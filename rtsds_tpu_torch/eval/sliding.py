"""Sliding-window inference: frames larger than the network was trained on
are cut into overlapping windows, the windows run through the model
stacked along the batch axis, and each pixel's class probabilities are the
mean over the windows that cover it.

The window grid depends only on the frame size, so it is fixed when the
predict function is made.  Windows run ``window_chunk`` at a time (all at
once by default): one forward of ``window_chunk * N`` tiles each.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from rtsds_tpu_torch.eval.validate import make_eval_step


def _positions(total: int, window: int, stride: int) -> list[int]:
    """Window start offsets covering [0, total) with overlap; the last
    window is clamped flush to the edge."""
    if window >= total:
        return [0]
    pos = list(range(0, total - window + 1, stride))
    if pos[-1] + window < total:
        pos.append(total - window)
    return pos


def make_sliding_predict(forward: Callable, image_size: tuple[int, int],
                         window: tuple[int, int] = (512, 1024),
                         stride: tuple[int, int] | None = None,
                         return_probs: bool = False,
                         window_chunk: int | None = None) -> Callable:
    """``predict(x) -> masks`` over (N, C, H, W) images of ``image_size``:
    (N, H, W) int32 class ids, or with ``return_probs`` the float32 (N, K,
    H, W) mean class probabilities.

    Args:
      forward: (M, C, h, w) images -> (M, K, h, w) logits.
      window: the (h, w) window, typically the training size; clipped to
        the image.
      stride: the window step; 3/4 of the window by default (25% overlap).
        It may not exceed the window: pixels would go uncovered.
      window_chunk: the most windows per forward; all of them by default,
        ``1`` one window at a time.
    """
    h, w = image_size
    wh, ww = min(window[0], h), min(window[1], w)
    if stride is None:
        stride = (max(wh * 3 // 4, 1), max(ww * 3 // 4, 1))
    if stride[0] <= 0 or stride[1] <= 0:
        raise ValueError(f"stride {stride} must be positive")
    if stride[0] > wh or stride[1] > ww:
        raise ValueError(
            f"stride {stride} exceeds window ({wh}, {ww}): uncovered "
            f"pixels would divide 0/0")
    tiles = [(y, x) for y in _positions(h, wh, stride[0])
             for x in _positions(w, ww, stride[1])]
    if window_chunk is None:
        window_chunk = len(tiles)
    if window_chunk < 1:
        raise ValueError(f"window_chunk {window_chunk} must be >= 1")

    def predict(images: torch.Tensor) -> torch.Tensor:
        n = images.shape[0]
        acc = None
        count = torch.zeros((1, 1, h, w), dtype=torch.float32,
                            device=images.device)
        for start in range(0, len(tiles), window_chunk):
            group = tiles[start:start + window_chunk]
            batch = torch.cat([images[:, :, y:y + wh, x:x + ww]
                               for y, x in group])
            probs = torch.softmax(forward(batch).float(), dim=1)
            if acc is None:
                acc = probs.new_zeros((n, probs.shape[1], h, w))
            for i, (y, x) in enumerate(group):
                acc[:, :, y:y + wh, x:x + ww] += probs[i * n:(i + 1) * n]
                count[:, :, y:y + wh, x:x + ww] += 1.0
        probs = acc / count
        if return_probs:
            return probs
        return probs.argmax(dim=1).to(torch.int32)

    return predict


def make_sliding_eval_step(model: nn.Module, image_size: tuple[int, int],
                           num_classes: int,
                           window: tuple[int, int] = (512, 1024),
                           stride: tuple[int, int] | None = None,
                           return_preds: bool = False,
                           window_chunk: int | None = None,
                           compute_dtype: torch.dtype | None = None
                           ) -> Callable:
    """The sliding-window form of
    :func:`rtsds_tpu_torch.eval.validate.make_eval_step`: ``eval_step(
    images, labels, hist) -> hist`` (or ``(hist, preds)``), the histogram
    updated by the confusion-matrix kernel."""
    predict = make_sliding_predict(model, image_size, window, stride,
                                   window_chunk=window_chunk)
    return make_eval_step(model, num_classes, return_preds=return_preds,
                          compute_dtype=compute_dtype, predict=predict)
