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

Under the model axis (``parallel/fsdp.py``) the EMA holds, for each
sharded parameter, this rank's chunk of its average, split as the
parameter is, and updates it from the parameter's shard (the update is
elementwise, so the chunk's update is the whole update's chunk), as JAX's
EMA tree follows the parameters' sharding.  :func:`ema_weights` gathers
the chunks into whole tensors for the block's forwards (a collective over
the model group) and drops them after; :class:`EMA`'s ``state_dict`` is
the whole average (the replicated run's ``ema`` item) and its
``load_state_dict`` cuts a whole one back into the chunks.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import numpy as np
import torch
from torch import nn

from rtsds_tpu_torch.parallel.fsdp import sharded_of


def _params(source) -> dict[str, torch.Tensor]:
    """What this rank holds of ``source``'s parameters (under the model
    axis a sharded parameter's shard), or ``source`` itself, a dict."""
    if isinstance(source, nn.Module):
        sharded = sharded_of(source)
        if sharded is not None:
            return sharded.local_parameters()
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
    never written.  Under the model axis the EMA's chunks are gathered
    whole on entry (every rank of the model group enters alike) and the
    model's own gather is held off inside the block."""
    params = dict(model.named_parameters())
    if set(params) != set(ema):
        raise KeyError(f"the EMA holds {len(ema)} tensors, the model "
                       f"{len(params)} parameters: their names differ")
    sharded = sharded_of(model)
    own = {k: p.data for k, p in params.items()}
    was_gathered = sharded.gathered if sharded is not None else None
    try:
        with torch.no_grad():
            for k, p in params.items():
                p.data = (ema[k] if sharded is None
                          else sharded.gather_like(k, ema[k]))
        if sharded is not None:
            sharded.gathered = True
        yield model
    finally:
        for k, p in params.items():
            p.data = own[k]
        if sharded is not None:
            sharded.gathered = was_gathered


class EMA:
    """An EMA's parameters as a checkpoint item: ``state_dict()`` is
    ``{"params": {name: tensor}}``, the JAX package's ``ema`` item, whole
    also when ``sharded`` (the model's
    :class:`~rtsds_tpu_torch.parallel.fsdp.ShardedParameters`) splits
    ``params`` into this rank's chunks."""

    def __init__(self, params: dict[str, torch.Tensor], sharded=None):
        self.params = params
        self.sharded = sharded

    def state_dict(self) -> dict:
        if self.sharded is None:
            return {"params": dict(self.params)}
        return {"params": {k: self.sharded.gather_like(k, v)
                           for k, v in self.params.items()}}

    def load_state_dict(self, state: dict) -> None:
        stored = state["params"]
        if set(stored) != set(self.params):
            raise KeyError(f"the stored EMA holds {sorted(stored)[:4]}..., "
                           f"not this model's parameters")
        if self.sharded is not None:
            stored = {k: self.sharded.cut(k, v.to(self.params[k].device))
                      for k, v in stored.items()}
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
    parameters, or of ``seed`` (a restored EMA: whole tensors, or under the
    model axis this rank's chunks) moved to each parameter's device and
    dtype."""
    sharded = sharded_of(model)
    if seed is None:
        return EMA(ema_init(model), sharded)
    params = _params(model)
    out = {}
    for k, p in params.items():
        v = torch.as_tensor(seed[k]).detach()
        if sharded is not None and v.shape != p.shape:
            v = sharded.cut(k, v.to(p.device))
        out[k] = v.to(device=p.device, dtype=p.dtype, copy=True)
    return EMA(out, sharded)
