"""Offline GTA5 label conversion: RGB-coded labels -> trainId PNGs.

Walks a raw GTA5 root (flat ``images/`` and RGB-coded ``labels/`` PNGs,
the download's layout), writes single-channel trainId label PNGs (a colour
that is no class key -> 255, void) and hard-links the images (a copy
across filesystems): a ``GTA5_Modified`` tree that trains without
``decode_label_colors``, the decode paid once.

The remap is :func:`convert_labels`: the RGB -> trainId kernel (K2,
``ops/cuda/remap.py``) on the GPU, or its plain PyTorch version
(``ops/remap.py``) with ``--device cpu``.  PNGs are decoded and written
with PIL in a thread pool; the remaps run one label at a time in the
calling thread.

    python -m rtsds_tpu_torch.data.convert_gta5 --src data/GTA5 \\
        --dst data/GTA5_Modified [--device cpu]

Library: :func:`convert_tree` returns a stats dict; :func:`build_lut` is
the 24-bit host lookup table the JAX package converts with.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.ops.cuda.remap import rgb_to_train_ids_cuda
from rtsds_tpu_torch.utils.colors import class_colors_for_remap

VOID = 255


def build_lut(color_table=None, default_id: int = VOID) -> np.ndarray:
    """(2^24,) uint8 lookup table: packed RGB (r<<16 | g<<8 | b) ->
    trainId.  Of two equal keys it keeps the last, where the kernel keeps
    the first; the GTA5 table has none."""
    if color_table is None:
        color_table = class_colors_for_remap()
    table = np.asarray(color_table, dtype=np.uint32)
    lut = np.full(1 << 24, default_id, dtype=np.uint8)
    keys = (table[:, 0] << 16) | (table[:, 1] << 8) | table[:, 2]
    lut[keys] = np.arange(len(table), dtype=np.uint8)
    return lut


def convert_labels(rgb: np.ndarray, device=None) -> np.ndarray:
    """(..., 3) uint8 RGB-coded labels -> (...) uint8 trainIds (255 for a
    colour that is no class key), remapped on ``device``: the GPU's kernel
    by default (raises without a GPU), the plain version on ``"cpu"``."""
    device = resolve_device(device)
    x = torch.from_numpy(np.require(rgb, np.uint8, ("C", "W")))
    ids = rgb_to_train_ids_cuda(x.to(device), default_id=VOID)
    return ids.to(torch.uint8).cpu().numpy()


def _decode_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _save_ids(ids: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(ids, mode="L").save(path)


def _link_or_copy(src: str, dst: str):
    if os.path.exists(dst):
        return
    try:
        os.link(src, dst)
    except OSError:  # across devices, or no hard links: copy
        shutil.copyfile(src, dst)


def convert_tree(src_root: str, dst_root: str, workers: int = 8,
                 overwrite: bool = False, link_images: bool = True,
                 quiet: bool = False, device=None) -> dict:
    """Convert ``src_root/{images,labels}`` into a trainId tree at
    ``dst_root``, remapping on ``device`` (:func:`convert_labels`).
    Labels already converted are skipped unless ``overwrite``.  Returns
    ``{converted, skipped, linked, void_fraction}``."""
    device = resolve_device(device)
    src_images = os.path.join(src_root, "images")
    src_labels = os.path.join(src_root, "labels")
    if not os.path.isdir(src_labels):
        raise FileNotFoundError(f"no labels/ directory under {src_root}")
    dst_images = os.path.join(dst_root, "images")
    dst_labels = os.path.join(dst_root, "labels")
    os.makedirs(dst_labels, exist_ok=True)

    names = sorted(n for n in os.listdir(src_labels)
                   if n.lower().endswith(".png"))
    todo, skipped = [], 0
    for n in names:
        dst = os.path.join(dst_labels, n)
        if not overwrite and os.path.exists(dst):
            skipped += 1
        else:
            todo.append((os.path.join(src_labels, n), dst))

    void_px = total_px = 0
    with ThreadPoolExecutor(max_workers=workers) as ex:
        writes = []
        for (_, dst), rgb in zip(todo, ex.map(lambda t: _decode_rgb(t[0]),
                                               todo)):
            ids = convert_labels(rgb, device)
            void_px += int(np.count_nonzero(ids == VOID))
            total_px += ids.size
            writes.append(ex.submit(_save_ids, ids, dst))
        for w in writes:
            w.result()

    linked = 0
    if link_images and os.path.isdir(src_images):
        os.makedirs(dst_images, exist_ok=True)
        img_names = sorted(n for n in os.listdir(src_images)
                           if n.lower().endswith(".png"))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(lambda n: _link_or_copy(
                os.path.join(src_images, n), os.path.join(dst_images, n)),
                img_names))
        linked = len(img_names)

    stats = {"converted": len(todo), "skipped": skipped, "linked": linked,
             "void_fraction": (void_px / total_px) if total_px else 0.0}
    if not quiet:
        print(f"convert_gta5: {stats['converted']} labels converted "
              f"({stats['skipped']} already present), {linked} images "
              f"{'linked' if link_images else 'kept'}; "
              f"{100.0 * stats['void_fraction']:.2f}% void pixels -> 255")
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert raw GTA5 RGB-coded labels to the "
                    "'GTA5_Modified' trainId layout.")
    parser.add_argument("--src", required=True,
                        help="Raw GTA5 root containing images/ and labels/")
    parser.add_argument("--dst", required=True,
                        help="Output root (a drop-in GTA5_Modified tree)")
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--overwrite", action="store_true",
                        help="Re-convert labels that already exist in dst")
    parser.add_argument("--no_images", action="store_true",
                        help="Only convert labels; do not link/copy images")
    parser.add_argument("--device", default=None,
                        help="torch device of the remap (default: the GPU's "
                             "kernel; 'cpu' for the plain version)")
    args = parser.parse_args(argv)
    try:
        convert_tree(args.src, args.dst, workers=args.workers,
                     overwrite=args.overwrite,
                     link_images=not args.no_images, device=args.device)
    except FileNotFoundError as e:
        print(f"convert_gta5: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
