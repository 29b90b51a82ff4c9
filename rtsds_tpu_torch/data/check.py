"""Dataset layout validator: catch data problems BEFORE a training run
(the port's copy of ``rtsds_tpu/data/check.py``, on the port's config).

The reference assumes its exact on-disk layouts (Cityscapes id-paired
city trees, ``cityscapes.py:25-56``; flat pre-converted "GTA5_Modified",
``gta5.py:59-60``) and fails late and opaquely when they're wrong — an
empty glob trains on nothing, RGB-coded labels silently clamp into
garbage classes.  This tool validates what the CLI would actually load:

    python -m rtsds_tpu_torch.data.check --config config.yaml
    python -m rtsds_tpu_torch.data.check --config config.yaml --dataset gta5

Checks, per dataset: directories exist, the index pairs a non-empty
sample set, unpaired files are counted, and a decoded sample of pairs
has the right image mode, label encoding (trainIds vs RGB-coded — with
the exact config fix to apply), value range, and matching sizes.
Exit 0 = no errors (warnings allowed), 1 = at least one error.
Host-only (PIL + numpy): runs anywhere, touches no accelerator.
"""

from __future__ import annotations

import os

import numpy as np

OK, WARN, ERROR = "ok", "WARN", "ERROR"


def _finding(level: str, message: str) -> dict:
    return {"level": level, "message": message}


def _decode(path: str):
    from PIL import Image

    with Image.open(path) as im:
        return im.mode, np.asarray(im)


def _check_label_values(arr: np.ndarray, num_classes: int) -> list[dict]:
    vals = np.unique(arr)
    valid = set(range(num_classes)) | {255, num_classes}  # ignore spellings
    bad = [int(v) for v in vals if int(v) not in valid]
    if bad:
        return [_finding(
            WARN,
            f"label values outside trainId range [0, {num_classes - 1}] "
            f"+ ignore ({num_classes}/255): {bad[:8]} -- raw labelIds "
            f"(0-33) instead of trainIds? They will be clamped to "
            f"ignore at load time")]
    return []


def check_pairs(samples, num_classes: int = 19, sample_count: int = 4,
                decode_label_colors: bool = False,
                dataset: str = "dataset") -> list[dict]:
    """Decode a few (image, label) pairs and validate encodings."""
    findings: list[dict] = []
    step = max(len(samples) // max(sample_count, 1), 1)
    for s in samples[::step][:sample_count]:
        img_mode, img = _decode(s.image)
        if img.ndim != 3 or img.shape[-1] != 3:
            findings.append(_finding(
                ERROR, f"{s.image}: expected RGB image, got mode "
                       f"{img_mode} shape {img.shape}"))
        lbl_mode, lbl = _decode(s.label)
        rgb_coded = lbl.ndim == 3
        if rgb_coded and lbl.shape[-1] == 4:
            lbl = lbl[..., :3]  # tolerate RGBA label exports
        if rgb_coded and not decode_label_colors:
            fix = ("set data.gta5_modified.decode_label_colors: true or "
                   "pre-convert with python -m "
                   "rtsds_tpu_torch.data.convert_gta5"
                   if dataset == "gta5" else
                   "point segmentation dirs at the *_labelTrainIds.png "
                   "annotations")
            findings.append(_finding(
                ERROR, f"{s.label}: RGB-coded label (mode {lbl_mode}) but "
                       f"color decoding is OFF -- {fix}"))
        elif not rgb_coded:
            if decode_label_colors:
                findings.append(_finding(
                    WARN, f"{s.label}: single-channel trainId label but "
                          f"decode_label_colors is ON -- the RGB decode "
                          f"would mangle it; disable the flag"))
            findings.extend(_check_label_values(lbl, num_classes))
        if img.shape[:2] != lbl.shape[:2]:
            findings.append(_finding(
                ERROR, f"{os.path.basename(s.image)}: image "
                       f"{img.shape[:2]} vs label {lbl.shape[:2]} size "
                       f"mismatch"))
    return findings


def check_cityscapes(cs_cfg, split: str = "train",
                     sample_count: int = 4) -> list[dict]:
    from rtsds_tpu_torch.data.indexing import build_cityscapes_index

    findings: list[dict] = []
    img_key, lbl_key = f"images_{split}_dir", f"segmentation_{split}_dir"
    img_dir, lbl_dir = cs_cfg[img_key], cs_cfg[lbl_key]
    for key, d in ((img_key, img_dir), (lbl_key, lbl_dir)):
        if not os.path.isdir(d):
            findings.append(_finding(
                ERROR, f"data.cityscapes.{key}: {d} is not a directory"))
    if any(f["level"] == ERROR for f in findings):
        return findings
    samples = build_cityscapes_index(lbl_dir, img_dir)
    paired = [s for s in samples if s.label]
    findings.append(_finding(
        OK, f"cityscapes/{split}: {len(paired)} paired samples "
            f"({len(samples) - len(paired)} images without a trainId "
            f"label)"))
    if not paired:
        findings.append(_finding(
            ERROR, f"cityscapes/{split}: no (image, trainId-label) pairs "
                   f"-- check the id pairing (first 3 '_' tokens) and "
                   f"that *_labelTrainIds.png files exist"))
        return findings
    if len(samples) != len(paired):
        findings.append(_finding(
            WARN, f"cityscapes/{split}: {len(samples) - len(paired)} "
                  f"unpaired images, e.g. "
                  f"{os.path.basename(samples[0].image) if samples else ''}"))
    findings.extend(check_pairs(
        paired, int(cs_cfg.get("num_classes", 19)), sample_count,
        dataset="cityscapes"))
    return findings


def check_gta5(gta5_cfg, sample_count: int = 4) -> list[dict]:
    from rtsds_tpu_torch.data.indexing import build_gta5_index

    findings: list[dict] = []
    img_dir = gta5_cfg["images_dir"]
    lbl_dir = gta5_cfg["segmentation_dir"]
    for key, d in (("images_dir", img_dir), ("segmentation_dir", lbl_dir)):
        if not os.path.isdir(d):
            findings.append(_finding(
                ERROR, f"data.gta5_modified.{key}: {d} is not a directory"))
    if any(f["level"] == ERROR for f in findings):
        return findings
    samples = build_gta5_index(img_dir, lbl_dir)
    findings.append(_finding(OK, f"gta5: {len(samples)} paired samples"))
    if not samples:
        findings.append(_finding(
            ERROR, "gta5: no (image, label) stem pairs -- images and "
                   "labels must share file stems in flat directories"))
        return findings
    findings.extend(check_pairs(
        samples, int(gta5_cfg.get("num_classes", 19)), sample_count,
        decode_label_colors=bool(gta5_cfg.get("decode_label_colors",
                                              False)),
        dataset="gta5"))
    return findings


def main(argv=None) -> int:
    import argparse

    from rtsds_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(
        description="Validate dataset layouts against what the training "
                    "CLI would load (host-only, no accelerator)")
    parser.add_argument("--config", default=None,
                        help="config.yaml with data.* paths (defaults "
                             "used when omitted)")
    parser.add_argument("--dataset", default="all",
                        choices=["all", "cityscapes", "gta5"])
    parser.add_argument("--samples", type=int, default=4,
                        help="pairs to decode per dataset")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    findings: list[dict] = []
    if args.dataset in ("all", "cityscapes"):
        for split in ("train", "val"):
            findings += check_cityscapes(config.data["cityscapes"], split,
                                         args.samples)
    if args.dataset in ("all", "gta5"):
        findings += check_gta5(config.data["gta5_modified"], args.samples)

    errors = 0
    for f in findings:
        if f["level"] == ERROR:
            errors += 1
        print(f"[{f['level']:>5}] {f['message']}")
    print(f"dataset check: {errors} error(s), "
          f"{sum(f['level'] == WARN for f in findings)} warning(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
