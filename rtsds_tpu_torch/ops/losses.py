"""Segmentation losses on NCHW logits and (N, H, W) integer labels.

``cross_entropy`` is the mean over non-ignored pixels of the per-pixel
negative log-likelihood.  A batch whose pixels are all ignored gives 0,
not NaN: the count in the denominator is at least 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rtsds_tpu_torch.utils.dtypes import at_least_f32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int | None = None) -> torch.Tensor:
    """Mean cross entropy of (N, C, H, W) logits against (N, H, W) labels.

    Labels lie in [0, C) or equal ``ignore_index``.
    """
    logits = at_least_f32(logits)
    labels = labels.long()
    if ignore_index is None:
        return F.cross_entropy(logits, labels)
    total = F.cross_entropy(logits, labels, ignore_index=ignore_index,
                            reduction="sum")
    count = (labels != ignore_index).sum().clamp(min=1)
    return total / count


def segmentation_loss(outputs, labels: torch.Tensor,
                      ignore_index: int | None = 19) -> torch.Tensor:
    """Sum of the cross entropy of each head: ``outputs`` is one logits
    tensor or the train-mode tuple ``(main, aux1, aux2)``, whose entries
    may be None."""
    if not isinstance(outputs, (tuple, list)):
        outputs = (outputs,)
    heads = [out for out in outputs if out is not None]
    loss = cross_entropy(heads[0], labels, ignore_index)
    for out in heads[1:]:
        loss = loss + cross_entropy(out, labels, ignore_index)
    return loss
