"""Dataset index builders: file discovery + image/label pairing (the
port's copy of the JAX package's indexing).

The pairing rules of the original dataset classes:

  * Cityscapes (``cityscapes.py:18-56``): recursive ``**/*.png`` glob of the
    image and gtFine directories; sample id = first 3 ``_``-separated tokens
    of the filename (city_seq_frame); each id keeps a trainId label
    (``*labelTrainIds.png``-style) and a colored label (``*color.png``),
    training consumes the trainId one.
  * GTA5 (``gta5.py:50-105``): flat ``*.png`` glob of images and labels
    paired by filename stem.  (The reference's ``get_id`` joins the stem's
    characters with underscores, ``gta5.py:93`` -- an id-mangling quirk with
    no behavioral effect since it is applied to both sides; we pair by the
    plain stem.)
"""

from __future__ import annotations

import dataclasses
import glob
import os


@dataclasses.dataclass(frozen=True)
class Sample:
    image: str
    label: str            # trainId label (or RGB-coded label for raw GTA5)
    color_label: str = "" # colored annotation, kept but unused in training


def _cityscapes_id(path: str) -> str:
    return "_".join(os.path.basename(path).split("_")[:3])


def build_cityscapes_index(labels_dir: str, images_dir: str) -> list[Sample]:
    """(annotation_path, images_path) -> paired samples, sorted by id.

    Argument order matches the reference ctor (``cityscapes.py:19``).
    """
    images = glob.glob(os.path.join(images_dir, "**", "*.png"), recursive=True)
    labels = glob.glob(os.path.join(labels_dir, "**", "*.png"), recursive=True)

    by_id: dict[str, dict] = {}
    for img in images:
        by_id[_cityscapes_id(img)] = {"image": img, "label": "", "color": ""}
    for lbl in labels:
        sid = _cityscapes_id(lbl)
        if sid not in by_id:
            continue
        if lbl.endswith("color.png"):
            by_id[sid]["color"] = lbl
        else:
            by_id[sid]["label"] = lbl

    samples = [Sample(v["image"], v["label"], v["color"])
               for sid, v in sorted(by_id.items()) if v["label"]]
    return samples


def build_gta5_index(images_dir: str, labels_dir: str) -> list[Sample]:
    images = glob.glob(os.path.join(images_dir, "*.png"))
    labels = glob.glob(os.path.join(labels_dir, "*.png"))
    lbl_by_stem = {os.path.splitext(os.path.basename(p))[0]: p for p in labels}
    samples = []
    for img in sorted(images):
        stem = os.path.splitext(os.path.basename(img))[0]
        if stem in lbl_by_stem:
            samples.append(Sample(img, lbl_by_stem[stem]))
    return samples
