"""Segmentation losses on NCHW logits and (N, H, W) integer labels, the
discriminator's binary cross entropy, and the entropy of the per-pixel
class distributions (MinEnt).

``cross_entropy`` is the mean over non-ignored pixels of the per-pixel
negative log-likelihood.  A batch whose pixels are all ignored gives 0,
not NaN: the count in the denominator is at least 1.
"""

from __future__ import annotations

import math

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


def bce_with_logits(logits: torch.Tensor, targets) -> torch.Tensor:
    """Mean binary cross entropy of logits against ``targets`` (a number or
    a tensor that broadcasts to the logits), in at least float32:
    ``max(x, 0) - x * y + log(1 + exp(-|x|))``.  Written out, its gradient
    keeps ``sigmoid(x) - y`` accurate for a confident logit, where
    ``F.binary_cross_entropy_with_logits`` loses it to cancellation in
    float32."""
    x = at_least_f32(logits)
    y = torch.as_tensor(targets, dtype=x.dtype, device=x.device)
    return (x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """Mean Shannon entropy of the per-pixel class distributions of (N, C,
    H, W) logits, divided by ``log C`` so that it lies in [0, 1] (MinEnt,
    Vu et al., CVPR'19), in at least float32."""
    logp = F.log_softmax(at_least_f32(logits), dim=1)
    ent = -(logp.exp() * logp).sum(dim=1)
    return ent.mean() / math.log(logits.shape[1])


def make_criterion(cfg):
    """``{name: CrossEntropy[, ignore_index]}`` or ``{name: BCEWithLogits}``
    -> ``loss(logits, labels)``."""
    name = cfg["name"]
    if name == "CrossEntropy":
        ignore_index = cfg.get("ignore_index", None)
        return lambda logits, labels: cross_entropy(logits, labels,
                                                    ignore_index)
    if name == "BCEWithLogits":
        return bce_with_logits
    raise ValueError(
        "Invalid loss name. Please select CrossEntropy or BCEWithLogits")


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
