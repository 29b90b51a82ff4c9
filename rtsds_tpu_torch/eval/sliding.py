"""Sliding-window inference: frames larger than the network was trained on
are cut into overlapping windows, the windows run through the model
stacked along the batch axis, and each pixel's class probabilities are the
mean over the windows that cover it.

The window grid depends only on the frame size, so it is fixed when the
predict function is made.  Windows run ``window_chunk`` at a time (all at
once by default): one forward of ``window_chunk * N`` tiles each.

:func:`make_banded_sliding_predict` runs the protocol on frames whose rows
are banded over devices (``parallel/spatial.py``, spatial serving): each
window's rows are gathered onto the band that holds its first row, the
window runs through that device's forward, and its probabilities are
scattered back into each band's accumulator beside the band's count map;
the argmax is per band.  No device ever holds the whole frame.
:func:`make_sliding_predict` takes that path itself when its frames come
as bands (validation in spatial training): each band's windows run
through the one model as a single band on that band's device, so the
banded ops carry the weights there (``_Layout.on``) as they do in the
training step, and the model is never copied.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from rtsds_tpu_torch.eval.validate import make_eval_step
from rtsds_tpu_torch.parallel.spatial import Bands, _Layout, bands_of


def _grid(image_size: tuple[int, int], window: tuple[int, int],
          stride: tuple[int, int] | None):
    """The window ``(wh, ww)`` clipped to the image and the tiles' top-left
    corners, with the stride checks."""
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
    return (wh, ww), tiles


def _positions(total: int, window: int, stride: int) -> list[int]:
    """Window start offsets covering [0, total) with overlap; the last
    window is clamped flush to the edge."""
    if window >= total:
        return [0]
    pos = list(range(0, total - window + 1, stride))
    if pos[-1] + window < total:
        pos.append(total - window)
    return pos


def _on_band(forward: Callable, device) -> Callable:
    """``forward`` on (M, C, h, w) windows on ``device``: the windows as one
    band there, so that the model's banded ops read each weight through
    ``_Layout.on`` (a copy on ``device``, whatever the model axis gathered
    this step) and the model itself is neither copied nor moved."""
    def run(batch: torch.Tensor) -> torch.Tensor:
        return forward(bands_of([batch], _Layout([device]))).parts[0]
    return run


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
    (wh, ww), tiles = _grid(image_size, window, stride)
    if window_chunk is None:
        window_chunk = len(tiles)
    if window_chunk < 1:
        raise ValueError(f"window_chunk {window_chunk} must be >= 1")

    def predict(images: torch.Tensor) -> torch.Tensor:
        if isinstance(images, Bands):
            # height bands (validation under the spatial axis): each window
            # on the band holding its first row, through the one model
            return make_banded_sliding_predict(
                [_on_band(forward, d) for d in images.layout.devices],
                image_size, window, stride, return_probs=return_probs,
                window_chunk=window_chunk)(images)
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


def make_banded_sliding_predict(forwards, image_size: tuple[int, int],
                                window: tuple[int, int] = (512, 1024),
                                stride: tuple[int, int] | None = None,
                                return_probs: bool = False,
                                window_chunk: int | None = None
                                ) -> Callable:
    """:func:`make_sliding_predict` on banded frames: ``predict(x) ->
    masks`` over (N, C, H, W) :class:`~rtsds_tpu_torch.parallel.spatial.
    Bands` of ``image_size``, the masks (or with ``return_probs`` the mean
    probabilities) as bands on the same rows.

    ``forwards[i]`` runs (M, C, h, w) windows on device ``i`` of the bands
    (a model replica there).  A window runs on the band that holds its
    first row, its rows gathered there; the windows of one band run
    ``window_chunk`` at a time (all at once by default).  Each band adds
    the probabilities of every window that covers its rows in the window
    order of :func:`make_sliding_predict`, so a pixel's sum is the one
    device's sum in the same order."""
    from rtsds_tpu_torch.parallel.spatial import _rows

    h, w = image_size
    (wh, ww), tiles = _grid(image_size, window, stride)
    if window_chunk is not None and window_chunk < 1:
        raise ValueError(f"window_chunk {window_chunk} must be >= 1")

    def predict(x):
        n, nb = x.shape[0], len(x.parts)
        home = [next(i for i in range(nb) if x.bounds(i)[0] <= y
                     < x.bounds(i)[1]) for y, _ in tiles]
        probs = [None] * len(tiles)
        for b in range(nb):
            mine = [t for t, hb in enumerate(home) if hb == b]
            chunk = window_chunk or max(len(mine), 1)
            for start in range(0, len(mine), chunk):
                group = mine[start:start + chunk]
                batch = torch.cat([
                    _rows(x, tiles[t][0], tiles[t][0] + wh, b)[
                        ..., tiles[t][1]:tiles[t][1] + ww] for t in group])
                out = torch.softmax(forwards[b](batch).float(), dim=1)
                for i, t in enumerate(group):
                    probs[t] = out[i * n:(i + 1) * n]
        accs, counts = [], []
        for j in range(nb):
            a, e = x.bounds(j)
            dev = x.layout.devices[j]
            acc = torch.zeros((n, probs[0].shape[1], e - a, w),
                              dtype=torch.float32, device=dev)
            count = torch.zeros((1, 1, e - a, w), dtype=torch.float32,
                                device=dev)
            for t, (y, x0) in enumerate(tiles):
                s_, e_ = max(y, a), min(y + wh, e)
                if s_ >= e_:
                    continue
                acc[:, :, s_ - a:e_ - a, x0:x0 + ww] += \
                    probs[t][:, :, s_ - y:e_ - y].to(dev)
                count[:, :, s_ - a:e_ - a, x0:x0 + ww] += 1.0
            accs.append(acc)
            counts.append(count)
        mean = x._like([acc / count for acc, count in zip(accs, counts)])
        if return_probs:
            return mean
        return mean._per_band(
            lambda p: p.argmax(dim=1).to(torch.int32))

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
