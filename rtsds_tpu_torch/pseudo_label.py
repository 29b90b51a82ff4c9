"""Offline pseudo-label generation for self-training rounds.

Counterpart of ``rtsds_tpu/pseudo_label.py`` (CBST, Zou et al. ECCV'18;
BDL, Li et al. CVPR'19): sweep a trained checkpoint over the target
domain's images and write confidence-thresholded argmax labels as trainId
PNGs in the Cityscapes naming convention, so the output directory is a
drop-in ``gtFine``-style label tree for the supervised loop (the online
variant is ``train/self_training.py``).

Each batch is normalized, run forward, thresholded and cast to uint8 masks
on the device (:func:`infer_masks`); the host resizes each mask to its
image's size and writes it.  ``--quantize int8`` sweeps through the W8A8
serving path (``ops/quant.py``).  Thresholds: a scalar ``--threshold``, or
``--calibrate`` for CBST per-class bars from the checkpoint's own
confidence histograms
(``train/self_training.py:calibrate_class_thresholds``).  Every label path
is planned, and checked, before any inference runs.

    python -m rtsds_tpu_torch.pseudo_label --checkpoint_dir ckpt/da \\
        --images <cityscapes>/leftImg8bit/train --out pseudo/train

runs on the GPU (``--device cpu`` on the CPU).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Iterable

import numpy as np
import torch
from torch import nn

from rtsds_tpu_torch.data.indexing import _cityscapes_id
from rtsds_tpu_torch.data.pipeline import _nearest_index
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.models.pretrained import load_segmentor_state
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.ops.quant import quantize_model
from rtsds_tpu_torch.train.self_training import (
    calibrate_class_thresholds, pseudo_labels)
from rtsds_tpu_torch.utils.dtypes import model_dtype


def _image_paths(images_dir: str) -> list[str]:
    paths = sorted(glob.glob(os.path.join(images_dir, "**", "*.png"),
                             recursive=True))
    if not paths:
        raise SystemExit(f"pseudo_label: no .png images under {images_dir}")
    return paths


def _label_path(out_dir: str, images_dir: str, image_path: str) -> str:
    """The Cityscapes-convention label path: the same sub-tree, the sample
    id (first 3 ``_`` tokens) and a trainId-style suffix that the index
    pairing accepts (anything but ``color.png``)."""
    rel = os.path.relpath(image_path, images_dir)
    stem = os.path.splitext(os.path.basename(rel))[0]
    tokens = stem.split("_")
    sid = "_".join(tokens[:3]) if len(tokens) >= 3 else stem
    return os.path.join(out_dir, os.path.dirname(rel),
                        f"{sid}_pseudoTrainIds.png")


def _plan_label_paths(out_dir: str, images_dir: str,
                      paths: list[str]) -> dict[str, str]:
    """image path -> label path for the whole sweep, checked up front.

    Exits before any inference runs when two images map to the same label
    file, or when an image's label would not pair back with it under
    ``build_cityscapes_index``'s id rule (first 3 ``_`` tokens): either
    failure mid-sweep would leave a partial or unpairable label tree."""
    planned: dict[str, str] = {}
    by_label: dict[str, str] = {}
    for path in paths:
        out_path = _label_path(out_dir, images_dir, path)
        if _cityscapes_id(os.path.basename(out_path)) != \
                _cityscapes_id(os.path.basename(path)):
            raise SystemExit(
                f"pseudo_label: {path} is not Cityscapes-named (needs a "
                "trailing suffix token after city_seq_frame, e.g. "
                "city_seq_frame_leftImg8bit.png, so the 3-token Cityscapes "
                "id excludes the file extension); its generated label "
                f"{os.path.basename(out_path)} would never pair back with "
                "the image in build_cityscapes_index — rename the images "
                "or use a Cityscapes-layout tree")
        if out_path in by_label:
            raise SystemExit(
                f"pseudo_label: {path} and {by_label[out_path]} map to "
                f"the same label file {out_path} (their first 3 "
                "'_' tokens collide — Cityscapes ids must be "
                "unique per directory)")
        by_label[out_path] = path
        planned[path] = out_path
    return planned


def _check_quantize(quantize: str | None) -> None:
    if quantize not in (None, "int8"):
        raise SystemExit(f"pseudo_label: quantize {quantize!r} is not "
                         "supported (int8)")


@torch.inference_mode()
def infer_masks(model: nn.Module, frames: torch.Tensor, threshold,
                ignore_index: int = 19,
                correct_preprocessing: bool = False) -> torch.Tensor:
    """(N, H, W, 3) uint8 frames on the model's device -> (N, H, W) uint8
    pseudo-label masks there: normalize, forward in the model's dtype,
    ``pseudo_labels`` at ``threshold`` (a number or one per class)."""
    x = normalize(frames, correct_preprocessing).permute(0, 3, 1, 2)
    out = model(x.to(model_dtype(model)))
    if isinstance(out, (tuple, list)):
        out = out[0]
    labels, _ = pseudo_labels(out, threshold, ignore_index)
    return labels.to(torch.uint8)


def sweep_model(model_name: str, state: dict, calib_frames: list,
                num_classes: int = 19, backbone: str = "resnet18",
                quantize: str | None = None, calibrate: bool = False,
                threshold=0.9, portion: float = 0.5,
                calib_stat: str = "max", calib_percentile: float = 99.9,
                correct_preprocessing: bool = False, device=None):
    """The sweep's model and thresholds: the float32 model of ``state`` on
    ``device``, or with ``quantize="int8"`` its W8A8 model calibrated on
    ``calib_frames`` ((B, H, W, 3) uint8 batches); with ``calibrate`` the
    CBST per-class thresholds of that model on the same batches, else
    ``threshold``.  Returns ``(model, threshold)``."""
    from rtsds_tpu_torch.models.bisenet import BiSeNet
    from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2

    device = resolve_device(device)
    _check_quantize(quantize)

    def normalized(frames):
        x = torch.from_numpy(np.asarray(frames)).to(device)
        return normalize(x, correct_preprocessing)

    if quantize == "int8":
        model = quantize_model(
            model_name, state,
            (normalized(f).permute(0, 3, 1, 2) for f in calib_frames),
            calib_stat=calib_stat, calib_percentile=calib_percentile,
            device=device)
    else:
        model = (DeepLabV2(num_classes=num_classes, output_f32=False)
                 if model_name == "deeplab" else
                 BiSeNet(num_classes=num_classes, context_path=backbone,
                         output_f32=False))
        model = load_segmentor_state(model, state).to(device).eval()
    if calibrate:
        threshold = calibrate_class_thresholds(
            model, (normalized(f) for f in calib_frames), num_classes,
            portion=portion)
    return model, threshold


def write_masks(masks: np.ndarray, metas: list, label_paths: dict,
                num_classes: int, full_res: bool = True) -> tuple:
    """Write each (H, W) uint8 mask of ``metas`` ``(image path, (h, w))``
    as a PNG at its planned path, resized nearest to the image's own size
    with ``full_res``.  Returns ``(kept pixels per class, pixels)``."""
    from PIL import Image

    kept = np.zeros((num_classes,), np.int64)
    n_px = 0
    for mask, (path, orig) in zip(masks, metas):
        if full_res and tuple(orig) != mask.shape:
            mask = mask[_nearest_index(orig[0], mask.shape[0])][
                :, _nearest_index(orig[1], mask.shape[1])]
        counts = np.bincount(mask.reshape(-1), minlength=num_classes + 1)
        kept += counts[:num_classes]
        n_px += mask.size
        out_path = label_paths[path]
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        Image.fromarray(mask, mode="L").save(out_path)
    return kept, n_px


def generate_pseudo_labels(checkpoint_dir: str, images_dir: str,
                           out_dir: str, model_name: str = "bisenet",
                           backbone: str = "resnet18",
                           num_classes: int = 19,
                           image_size: tuple[int, int] = (1024, 2048),
                           batch_size: int = 4, threshold=0.9,
                           calibrate: bool = False, portion: float = 0.5,
                           calib_batches: int = 8, use_ema: bool = True,
                           ignore_index: int = 19,
                           correct_preprocessing: bool = False,
                           quantize: str | None = None,
                           calib_stat: str = "max",
                           calib_percentile: float = 99.9,
                           full_res: bool = True, device=None) -> dict:
    """Sweep the checkpoint over ``images_dir`` and write pseudo-label
    PNGs under ``out_dir``, mirroring the image sub-tree.  Returns a stats
    dict (images, pixel coverage, per-class kept-pixel shares, the
    thresholds used)."""
    from PIL import Image

    from rtsds_tpu_torch.data.pipeline import decode_image
    from rtsds_tpu_torch.serve import load_checkpoint_state

    if ignore_index > 255:
        raise SystemExit("pseudo_label: ignore_index must fit the uint8 "
                         "PNG wire format (<= 255)")
    if model_name not in ("bisenet", "deeplab"):
        raise SystemExit(f"pseudo_label: unknown model {model_name!r}")
    state = load_checkpoint_state(checkpoint_dir, use_ema=use_ema)
    paths = _image_paths(images_dir)
    # collisions and unpairable names follow from the paths alone: fail
    # before any inference, not mid-sweep
    label_paths = _plan_label_paths(out_dir, images_dir, paths)

    def batches() -> Iterable:
        """(frames (B, H, W, 3) uint8, [(path, (h, w))]); the last batch
        is padded by repeating its first frame."""
        for i in range(0, len(paths), batch_size):
            frames, metas = [], []
            for p in paths[i:i + batch_size]:
                with Image.open(p) as im:
                    orig = (im.height, im.width)
                frames.append(decode_image(p, image_size))
                metas.append((p, orig))
            while len(frames) < batch_size:
                frames.append(frames[0])
            yield np.stack(frames), metas

    _check_quantize(quantize)
    calib_frames = []
    if quantize or calibrate:
        # decoded once, shared by the int8 scales and the CBST bars
        for frames, _ in batches():
            if len(calib_frames) >= max(1, calib_batches):
                break
            calib_frames.append(frames)
    model, threshold = sweep_model(
        model_name, state, calib_frames, num_classes=num_classes,
        backbone=backbone, quantize=quantize, calibrate=calibrate,
        threshold=threshold, portion=portion, calib_stat=calib_stat,
        calib_percentile=calib_percentile,
        correct_preprocessing=correct_preprocessing, device=device)
    dev = resolve_device(device)

    kept = np.zeros((num_classes,), np.int64)
    n_px = n_images = 0
    for frames, metas in batches():
        masks = infer_masks(model, torch.from_numpy(frames).to(dev),
                            threshold, ignore_index,
                            correct_preprocessing).cpu().numpy()
        # coverage counts real images only: the padding of the last batch
        # is never written or counted
        k, n = write_masks(masks, metas, label_paths, num_classes, full_res)
        kept += k
        n_px += n
        n_images += len(metas)

    total_kept = int(kept.sum())
    return {
        "images": n_images,
        "out_dir": out_dir,
        "coverage": total_kept / max(n_px, 1),
        "class_share": (kept / max(total_kept, 1)).round(4).tolist(),
        "threshold": np.asarray(threshold, np.float32).round(4).tolist(),
        "ignore_index": ignore_index,
        **({"quantize": quantize} if quantize else {}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Offline pseudo-label generation (CBST/BDL-style "
                    "self-training rounds)")
    ap.add_argument("--checkpoint_dir", required=True,
                    help="trained checkpoint directory (or export_torch "
                         "file)")
    ap.add_argument("--images", required=True,
                    help="target-domain image tree (recursive *.png, "
                         "Cityscapes leftImg8bit layout)")
    ap.add_argument("--out", required=True,
                    help="output label tree (gtFine-style drop-in)")
    ap.add_argument("--model", default="bisenet",
                    choices=["bisenet", "deeplab"])
    ap.add_argument("--backbone", default="resnet18")
    ap.add_argument("--num_classes", type=int, default=19)
    ap.add_argument("--size", default="1024, 2048",
                    help="inference H, W")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--threshold", type=float, default=0.9,
                    help="scalar confidence bar (ignored with --calibrate)")
    ap.add_argument("--calibrate", action="store_true",
                    help="CBST per-class thresholds from the checkpoint's "
                         "confidence histograms")
    ap.add_argument("--portion", type=float, default=0.5,
                    help="CBST kept-fraction per class")
    ap.add_argument("--calib_batches", type=int, default=8)
    ap.add_argument("--no_ema", action="store_true",
                    help="use raw training params even when the "
                         "checkpoint has an EMA item")
    ap.add_argument("--ignore_index", type=int, default=19)
    ap.add_argument("--correct_preprocessing", action="store_true")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="sweep through the W8A8 serving path")
    ap.add_argument("--calib_stat", default="max",
                    choices=["max", "percentile"],
                    help="int8 activation-scale statistic")
    ap.add_argument("--calib_percentile", type=float, default=99.9)
    ap.add_argument("--model_res", action="store_true",
                    help="write labels at the inference resolution "
                         "instead of each image's original size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    size = tuple(int(v) for v in args.size.split(","))
    stats = generate_pseudo_labels(
        args.checkpoint_dir, args.images, args.out, model_name=args.model,
        backbone=args.backbone, num_classes=args.num_classes,
        image_size=size, batch_size=args.batch, threshold=args.threshold,
        calibrate=args.calibrate, portion=args.portion,
        calib_batches=args.calib_batches, use_ema=not args.no_ema,
        ignore_index=args.ignore_index,
        correct_preprocessing=args.correct_preprocessing,
        quantize=args.quantize, calib_stat=args.calib_stat,
        calib_percentile=args.calib_percentile,
        full_res=not args.model_res, device=args.device)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
