"""Segmentation metrics from an (n, n) confusion matrix.

``fast_hist`` here is the plain PyTorch confusion matrix: the CPU path of
:func:`rtsds_tpu_torch.ops.cuda.hist.fast_hist_cuda` and the reference its
CUDA kernel is held against.
"""

from __future__ import annotations

import torch


def fast_hist(labels: torch.Tensor, preds: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """(n, n) int32 confusion matrix; ``hist[i, j]`` counts pixels of true
    class ``i`` predicted as ``j``.

    A pixel counts only when both its label and its prediction lie in
    [0, n), the rule of the TPU kernel this replaces.  (The JAX package's
    ``bincount`` version masks labels only, so an out-of-range prediction
    lands in another cell there.)
    """
    n = num_classes
    labels = labels.reshape(-1).to(torch.int64)
    preds = preds.reshape(-1).to(torch.int64)
    valid = (labels >= 0) & (labels < n) & (preds >= 0) & (preds < n)
    idx = torch.where(valid, labels * n + preds, n * n)
    counts = torch.bincount(idx, minlength=n * n + 1)
    return counts[:n * n].reshape(n, n).to(torch.int32)


def per_class_iou(hist) -> torch.Tensor:
    """Per-class IoU, ``diag / (row + col - diag + 1e-5)``, in float32
    (float64 for a float64 matrix)."""
    hist = torch.as_tensor(hist)
    hist = hist.to(torch.float64 if hist.dtype == torch.float64
                   else torch.float32)
    diag = torch.diagonal(hist)
    return diag / (hist.sum(dim=1) + hist.sum(dim=0) - diag + 1e-5)


def mean_iou(hist) -> torch.Tensor:
    """nanmean of the per-class IoU (an absent class scores 0.0, not NaN,
    because of the epsilon)."""
    return torch.nanmean(per_class_iou(hist))


def pixel_accuracy(hist) -> torch.Tensor:
    """trace / total, or 0 for an empty matrix."""
    hist = torch.as_tensor(hist).to(torch.float32)
    total = hist.sum()
    if total > 0:
        return torch.trace(hist) / total
    return torch.zeros((), dtype=torch.float32, device=hist.device)
