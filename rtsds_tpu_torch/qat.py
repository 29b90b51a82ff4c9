"""Quantization-aware fine-tuning CLI: recover int8 serving accuracy by
training against the W8A8 grid.

Counterpart of ``rtsds_tpu/qat.py``.  Use it when int8 serving
(``--quantize int8``) loses mIoU on your data that the calibration choices
(``--calib_stat``, ``--calib_percentile``) cannot close: it takes the
trained checkpoint, folds BN, calibrates the activation scales as serving
does, fine-tunes the folded weights against the W8A8 grid
(straight-through estimators, ``train/qat.py``) and writes a SERVING
checkpoint of the port (``epoch_0.pt``, read by
``serve.load_checkpoint_state`` and ``Predictor.from_checkpoint``) with
the activation scales beside it (``qat_act_scales.json``), which int8
serving then uses instead of recalibrating.  Its BNs are exact identities
carrying the folded statistics: do not resume batch-statistics training
from it.

    python -m rtsds_tpu_torch.qat --checkpoint_dir ckpt/m --out ckpt_qat \\
        --images <cityscapes>/leftImg8bit/train \\
        --labels <cityscapes>/gtFine/train --model bisenet --steps 500

runs on the GPU (``--device cpu`` on the CPU).  :func:`finetune` is the
loop over frames in memory; :func:`qat_finetune` feeds it decoded PNGs.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable

import numpy as np
import torch

from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
from rtsds_tpu_torch.config import parse_int_list
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.ops.resize import clamp_labels
from rtsds_tpu_torch.serve import load_checkpoint_state
from rtsds_tpu_torch.train.qat import (
    create_qat_state, prepare_qat, save_act_scales, writeback)
from rtsds_tpu_torch.train.supervised import make_train_step


class _ServingWeights:
    """A checkpoint item holding a model state dict, in the layout of a
    train state's (``{"model": state}``)."""

    def __init__(self, state: dict):
        self.state = state

    def state_dict(self) -> dict:
        return {"model": self.state}


def finetune(state: dict, load_images: Callable, load_labels: Callable,
             n_samples: int, out_dir: str, model_name: str = "bisenet",
             batch_size: int = 8, steps: int = 500, lr: float = 1e-5,
             calib_batches: int = 8, calib_stat: str = "max",
             calib_percentile: float = 99.9, ignore_index: int = 19,
             correct_preprocessing: bool = False, seed: int = 42,
             log_every: int = 50, device=None) -> dict:
    """Fine-tune the model of ``state`` against the W8A8 grid and write the
    serving checkpoint and its scales sidecar to ``out_dir``.

    ``load_images(idx)`` gives the (B, H, W, 3) uint8 frames of samples
    ``idx`` and ``load_labels(idx)`` their (B, H, W) trainIds (void ids
    above ``ignore_index`` are clamped to it, as the training transform
    clamps them); samples are drawn as the JAX package draws them (a
    permutation from ``seed``, redrawn when a batch would run past it; the
    calibration batches first).  Returns a stats dict."""
    device = resolve_device(device)

    def images(idx):
        x = torch.from_numpy(np.asarray(load_images(idx))).to(device)
        return normalize(x, correct_preprocessing)

    rng = np.random.default_rng(seed)
    order = rng.permutation(n_samples)
    calib_idx = [order[i % n_samples]
                 for i in range(max(1, calib_batches) * batch_size)]
    prep = prepare_qat(
        model_name, state,
        (images(calib_idx[i:i + batch_size]).permute(0, 3, 1, 2)
         for i in range(0, len(calib_idx), batch_size)),
        calib_stat=calib_stat, calib_percentile=calib_percentile,
        device=device)
    train_state = create_qat_state(prep, lr)
    step_fn = make_train_step(ignore_index=ignore_index)

    cursor, last_loss = 0, float("nan")
    for it in range(steps):
        if cursor + batch_size > len(order):
            order = rng.permutation(n_samples)
            cursor = 0
        idx = order[cursor:cursor + batch_size]
        cursor += batch_size
        labels = clamp_labels(torch.from_numpy(
            np.asarray(load_labels(idx))).to(device), 0, ignore_index)
        metrics = step_fn(train_state, images(idx), labels)
        if (it + 1) % log_every == 0 or it + 1 == steps:
            last_loss = float(metrics["train_loss"])
            print(f"qat step {it + 1}/{steps} loss {last_loss:.4f}",
                  file=sys.stderr, flush=True)

    served = writeback(model_name, state, train_state.model.folded)
    CheckpointManager(out_dir).save(0, {"model": _ServingWeights(served)})
    # the grid follows the checkpoint: int8 serving reads these scales
    # instead of recalibrating, which at aggressive settings would clip
    # again what the fine-tune repaired
    scales_path = save_act_scales(out_dir, prep, calib_stat,
                                  calib_percentile)
    return {
        "scales_sidecar": scales_path,
        "out_dir": out_dir,
        "steps": steps,
        "final_loss": last_loss,
        "quantized_convs": len(prep.quant_names),
        "bf16_convs": len(prep.folded) - len(prep.quant_names),
        "calib_stat": calib_stat,
        "calib_percentile": calib_percentile,
        "samples": n_samples,
    }


def qat_finetune(checkpoint_dir: str, images_dir: str, labels_dir: str,
                 out_dir: str, model_name: str = "bisenet",
                 image_size: tuple[int, int] = (1024, 2048),
                 batch_size: int = 4, steps: int = 500, lr: float = 1e-5,
                 calib_batches: int = 8, calib_stat: str = "max",
                 calib_percentile: float = 99.9, use_ema: bool = True,
                 ignore_index: int = 19,
                 correct_preprocessing: bool = False,
                 seed: int = 42, log_every: int = 50, device=None) -> dict:
    """Fine-tune the checkpoint at ``checkpoint_dir`` (its ``ema`` weights
    unless ``use_ema=False``) on the labelled Cityscapes-layout (images,
    labels) trees, decoded and resized to ``image_size``, and write the
    serving checkpoint to ``out_dir`` (:func:`finetune`)."""
    from rtsds_tpu_torch.data.indexing import build_cityscapes_index
    from rtsds_tpu_torch.data.pipeline import decode_image, decode_label

    samples = build_cityscapes_index(labels_dir, images_dir)
    if not samples:
        raise SystemExit(f"qat: no paired (image, label) samples between "
                         f"{images_dir} and {labels_dir}")
    state = load_checkpoint_state(checkpoint_dir, use_ema=use_ema)
    return finetune(
        state,
        lambda idx: np.stack([decode_image(samples[i].image, image_size)
                              for i in idx]),
        lambda idx: np.stack([decode_label(samples[i].label, image_size)
                              for i in idx]),
        len(samples), out_dir, model_name=model_name, batch_size=batch_size,
        steps=steps, lr=lr, calib_batches=calib_batches,
        calib_stat=calib_stat, calib_percentile=calib_percentile,
        ignore_index=ignore_index,
        correct_preprocessing=correct_preprocessing, seed=seed,
        log_every=log_every, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="QAT fine-tune: recover int8 serving accuracy by "
                    "training against the W8A8 grid")
    ap.add_argument("--checkpoint_dir", required=True,
                    help="trained checkpoint directory (or export_torch "
                         "file)")
    ap.add_argument("--images", required=True,
                    help="labeled image tree (Cityscapes layout)")
    ap.add_argument("--labels", required=True,
                    help="trainId label tree paired by Cityscapes ids "
                         "(real gtFine or a pseudo_label output tree)")
    ap.add_argument("--out", required=True,
                    help="output SERVING checkpoint directory")
    ap.add_argument("--model", default="bisenet",
                    choices=["bisenet", "deeplab"])
    ap.add_argument("--size", default="1024, 2048", help="train H, W")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--calib_batches", type=int, default=8)
    ap.add_argument("--calib_stat", default="max",
                    choices=["max", "percentile"])
    ap.add_argument("--calib_percentile", type=float, default=99.9)
    ap.add_argument("--no_ema", action="store_true",
                    help="use raw training params even when the "
                         "checkpoint has an EMA item")
    ap.add_argument("--ignore_index", type=int, default=19)
    ap.add_argument("--correct_preprocessing", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--log_every", type=int, default=50,
                    help="print a loss line every N steps (stderr)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    stats = qat_finetune(
        args.checkpoint_dir, args.images, args.labels, args.out,
        model_name=args.model, image_size=tuple(parse_int_list(args.size)),
        batch_size=args.batch, steps=args.steps, lr=args.lr,
        calib_batches=args.calib_batches, calib_stat=args.calib_stat,
        calib_percentile=args.calib_percentile, use_ema=not args.no_ema,
        ignore_index=args.ignore_index,
        correct_preprocessing=args.correct_preprocessing, seed=args.seed,
        log_every=args.log_every, device=args.device)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
