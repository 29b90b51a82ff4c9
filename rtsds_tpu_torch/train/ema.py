"""Exponential moving average of a module's parameters (the mean teacher).

Counterpart of ``rtsds_tpu/train/ema.py``.  The EMA is a dict of tensors,
one per ``named_parameters()`` entry of the module, on the module's device.
Parameters only: DeepLabV2's frozen batch-norm affines are parameters and
are averaged; batch-norm running statistics are buffers and are not (an
evaluation on the EMA takes the live module's buffers, as the JAX package
takes the live ``batch_stats``).

One update is ``e <- d * e + (1 - d) * p`` in float32, cast back to the
EMA's dtype, with the warmup ``d = min(decay, (1 + t) / (10 + t))`` when a
step ``t`` is given: the optimizer's count after the step that produced
``p`` (``TrainState.step``).

    ema = setup_ema(state.model)
    ...after each optimizer step...
    ema_update(ema.params, state.model, decay, state.step)
    with ema_weights(state.model, ema.params):
        ...evaluate on the average...
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import numpy as np
import torch
from torch import nn


def _params(source) -> dict[str, torch.Tensor]:
    if isinstance(source, nn.Module):
        return dict(source.named_parameters())
    return dict(source)


def ema_init(source) -> dict[str, torch.Tensor]:
    """A copy of the parameters of ``source`` (a module or a dict of
    tensors), detached."""
    return {k: p.detach().clone() for k, p in _params(source).items()}


def warmup_decay(decay: float, step: int | None = None) -> np.float32:
    """The decay of one update in float32, with the warmup when ``step`` is
    given, as the JAX package computes it."""
    d = np.float32(decay)
    if step is not None:
        t = np.float32(step)
        d = min(d, (np.float32(1.0) + t) / (np.float32(10.0) + t))
    return np.float32(d)


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], source, decay: float = 0.999,
               step: int | None = None) -> dict[str, torch.Tensor]:
    """One EMA step of ``ema`` toward the parameters of ``source`` (a module
    or a dict of tensors with the same keys), in place; returns ``ema``."""
    d = warmup_decay(decay, step)
    params = _params(source)
    ema_t = [ema[k] for k in ema]
    par_t = [params[k].detach() for k in ema]
    if all(t.dtype == torch.float32 for t in ema_t + par_t):
        torch._foreach_mul_(ema_t, float(d))
        torch._foreach_add_(ema_t, par_t, alpha=float(np.float32(1.0) - d))
    else:
        for e, p in zip(ema_t, par_t):
            e.copy_(e.float() * float(d)
                    + p.float() * float(np.float32(1.0) - d))
    return ema


@contextlib.contextmanager
def ema_weights(model: nn.Module, ema: Mapping[str, torch.Tensor]):
    """``model`` computes with the ``ema`` parameters inside the block, and
    with its own buffers.  Each parameter's storage is swapped, not
    overwritten, and swapped back at the end: the model's own weights are
    never written."""
    params = dict(model.named_parameters())
    if set(params) != set(ema):
        raise KeyError(f"the EMA holds {len(ema)} tensors, the model "
                       f"{len(params)} parameters: their names differ")
    own = {k: p.data for k, p in params.items()}
    try:
        for k, p in params.items():
            p.data = ema[k]
        yield model
    finally:
        for k, p in params.items():
            p.data = own[k]


class EMA:
    """An EMA's parameters as a checkpoint item: ``state_dict()`` is
    ``{"params": {name: tensor}}``, the JAX package's ``ema`` item."""

    def __init__(self, params: dict[str, torch.Tensor]):
        self.params = params

    def state_dict(self) -> dict:
        return {"params": dict(self.params)}

    def load_state_dict(self, state: dict) -> None:
        stored = state["params"]
        if set(stored) != set(self.params):
            raise KeyError(f"the stored EMA holds {sorted(stored)[:4]}..., "
                           f"not this model's parameters")
        for k, v in stored.items():
            if v.shape != self.params[k].shape:
                raise RuntimeError(f"size mismatch for EMA {k}: "
                                   f"{tuple(v.shape)} vs "
                                   f"{tuple(self.params[k].shape)}")
        with torch.no_grad():
            for k, v in stored.items():
                self.params[k].copy_(v)


def setup_ema(model: nn.Module, seed: Mapping[str, torch.Tensor] | None
              = None) -> EMA:
    """The EMA of ``model`` for the training loops: a copy of its
    parameters, or of ``seed`` (a restored EMA) moved to each parameter's
    device and dtype."""
    if seed is None:
        return EMA(ema_init(model))
    params = dict(model.named_parameters())
    return EMA({k: torch.as_tensor(seed[k]).detach().to(
        device=p.device, dtype=p.dtype, copy=True) for k, p in params.items()})
