"""Segmentation losses on NCHW logits and (N, H, W) integer labels, the
discriminator's binary cross entropy, and the entropy of the per-pixel
class distributions (MinEnt).

``cross_entropy`` is the mean over non-ignored pixels of the per-pixel
negative log-likelihood.  A batch whose pixels are all ignored gives 0,
not NaN: the count in the denominator is at least 1.

Under the data axis (``parallel/distributed.py:data_parallel``) every mean
divides by the count of the GLOBAL batch: the valid pixels all-reduced, or
a shape's size times the world size.  Each rank's loss is then its share
of the global batch's loss, whose gradient the summed gradients are, as in
the JAX package, whose means run over the global batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rtsds_tpu_torch.parallel.distributed import global_count, world_size
from rtsds_tpu_torch.utils.dtypes import at_least_f32


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t``'s elements over the global batch: its sum over the
    global count (``t.mean()`` at world size 1)."""
    if world_size() == 1:
        return t.mean()
    return t.sum() / global_count(t.numel())


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int | None = None) -> torch.Tensor:
    """Mean cross entropy of (N, C, H, W) logits against (N, H, W) labels.

    Labels lie in [0, C) or equal ``ignore_index``.
    """
    logits = at_least_f32(logits)
    labels = labels.long()
    if ignore_index is None:
        if world_size() == 1:
            return F.cross_entropy(logits, labels)
        return (F.cross_entropy(logits, labels, reduction="sum")
                / global_count(labels.numel()))
    total = F.cross_entropy(logits, labels, ignore_index=ignore_index,
                            reduction="sum")
    count = global_count((labels != ignore_index).sum()).clamp(min=1)
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
    loss = x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return global_mean(loss)


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """Mean Shannon entropy of the per-pixel class distributions of (N, C,
    H, W) logits, divided by ``log C`` so that it lies in [0, 1] (MinEnt,
    Vu et al., CVPR'19), in at least float32."""
    logp = F.log_softmax(at_least_f32(logits), dim=1)
    ent = -(logp.exp() * logp).sum(dim=1)
    return global_mean(ent) / math.log(logits.shape[1])


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
