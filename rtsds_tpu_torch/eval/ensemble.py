"""Multi-scale and flip ensemble inference: each pixel's class
probabilities are the mean over resized and horizontally flipped copies of
the frame.

Each scale's size is snapped to a multiple of 32, and a size met twice
runs once.  The copy at a scale and its flip run as one forward of 2N
frames.  The resizes antialias as ``jax.image.resize`` does by default: the
frames into a smaller scale and the logits of a larger scale back down to
the frame's size.  The probabilities are taken in at least float32 (the
JAX package's float32; a float64 run stays float64, for exact
comparisons).  ``images`` may be height bands (``parallel/spatial.py``):
the protocol then runs on the bands, every op of it banded.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from rtsds_tpu_torch.eval.validate import make_eval_step
from rtsds_tpu_torch.ops.resize import resize_bilinear
from rtsds_tpu_torch.utils.dtypes import at_least_f32


def _snap(v: float, multiple: int = 32) -> int:
    return max(int(round(v / multiple)) * multiple, multiple)


def ensemble_sizes(image_size: tuple[int, int],
                   scales: Sequence[float]) -> list[tuple[int, int]]:
    """The distinct snapped (H, W) of each scale, in the order given."""
    h, w = image_size
    sizes = []
    for s in scales:
        size = (_snap(h * s), _snap(w * s))
        if size not in sizes:
            sizes.append(size)
    return sizes


def make_ensemble_predict(forward: Callable, image_size: tuple[int, int],
                          scales: Sequence[float] = (0.75, 1.0, 1.25),
                          flip: bool = True,
                          return_probs: bool = False) -> Callable:
    """``predict(x) -> masks`` over (N, C, H, W) images of ``image_size``:
    (N, H, W) int32 class ids, or with ``return_probs`` the float32 (N, K,
    H, W) mean class probabilities.  ``forward`` maps (M, C, h, w) images
    to (M, K, h, w) logits."""
    h, w = image_size
    sizes = ensemble_sizes(image_size, scales)

    def predict(images: torch.Tensor) -> torch.Tensor:
        n = images.shape[0]
        acc = None
        count = 0
        for size in sizes:
            x = images
            if size != (h, w):
                x = resize_bilinear(images, size, antialias=True)
            if flip:
                both = forward(torch.cat([x, x.flip(-1)]))
                logits_list = [both[:n], both[n:].flip(-1)]
            else:
                logits_list = [forward(x)]
            for logits in logits_list:
                logits = at_least_f32(logits)
                if tuple(logits.shape[-2:]) != (h, w):
                    logits = resize_bilinear(logits, (h, w), antialias=True)
                p = torch.softmax(logits, dim=1)
                acc = p if acc is None else acc + p
                count += 1
        probs = acc / count
        if return_probs:
            return probs
        return probs.argmax(dim=1).to(torch.int32)

    return predict


def make_ensemble_eval_step(model: nn.Module, image_size: tuple[int, int],
                            num_classes: int,
                            scales: Sequence[float] = (0.75, 1.0, 1.25),
                            flip: bool = True, return_preds: bool = False,
                            compute_dtype: torch.dtype | None = None
                            ) -> Callable:
    """The ensemble form of
    :func:`rtsds_tpu_torch.eval.validate.make_eval_step`: ``eval_step(
    images, labels, hist) -> hist`` (or ``(hist, preds)``), the histogram
    updated by the confusion-matrix kernel."""
    predict = make_ensemble_predict(model, image_size, scales, flip)
    return make_eval_step(model, num_classes, return_preds=return_preds,
                          compute_dtype=compute_dtype, predict=predict)
