"""Pipeline parallelism: a GPipe microbatch schedule over a ``pipe`` mesh
of stage devices, in eager PyTorch.

Counterpart of ``rtsds_tpu/parallel/pipeline.py``.  L homogeneous blocks
split into P stages; stage p holds blocks ``[p*L/P, (p+1)*L/P)`` on
``mesh.devices[p]``.  At tick t = 0 .. M + P - 2 stage p runs microbatch
t - p and hands its activation to stage p + 1 (a copy to the next device).
Kernel launches are asynchronous per device, so the stages of one tick
overlap on separate GPUs; a backward of the results runs the reverse
schedule on autograd's per-device threads.  Each block sees the M
microbatches in order, so BatchNorm's running statistics advance exactly
as a gradient-accumulation loop advances them (``train/accumulate.py``).

The blocks are modules that keep their own parameters and BatchNorm state,
so the JAX package's ``stack_block_params`` (stacking per-block parameter
trees on a leading axis for ``shard_map``) has no counterpart here.
Stages may share a device (two stages on one GPU run the same schedule
without overlap).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rtsds_tpu_torch.parallel.mesh import Mesh


def to_device_hook(device: torch.device):
    def hook(module, args):
        return tuple(a.to(device, non_blocking=True)
                     if isinstance(a, torch.Tensor) else a for a in args)
    return hook


def place_stages(blocks: Sequence[nn.Module], mesh: Mesh,
                 axis: str = "pipe") -> list[list[nn.Module]]:
    """Move stage p's slice of ``blocks`` to ``mesh.devices[p]`` and give
    each stage's first block a hook that moves its input there, so that a
    plain forward through the blocks (validation, serving, the EMA's
    evaluation) works wherever the stages sit.  Returns the stages.
    Placing again replaces the earlier hooks."""
    n_stages = mesh.shape[axis]
    if len(blocks) % n_stages:
        raise ValueError(
            f"{len(blocks)} blocks do not split over {n_stages} stages")
    per = len(blocks) // n_stages
    stages = []
    for p, device in enumerate(mesh.devices):
        stage = list(blocks[p * per:(p + 1) * per])
        for b in stage:
            b.to(device)
            for handle in getattr(b, "_stage_hooks", ()):
                handle.remove()
            b._stage_hooks = []
        stage[0]._stage_hooks.append(
            stage[0].register_forward_pre_hook(to_device_hook(device)))
        stages.append(stage)
    return stages


def to_device(model: nn.Module, device) -> nn.Module:
    """``model.to(device)``, unless its stages are placed on a pipe mesh
    (``train/pipelined.py:place_pipeline`` marks it), which keeps them
    where they are."""
    if getattr(model, "pipe_mesh", None) is None:
        model.to(device)
    return model


def _stage_device(stage: list[nn.Module]) -> torch.device:
    return next(stage[0].parameters()).device


def pipeline_apply_stateful(blocks: Sequence[nn.Module], xs, mesh: Mesh,
                            axis: str = "pipe") -> list[torch.Tensor]:
    """The GPipe schedule of ``xs`` (M microbatches: a list, or a tensor
    whose first dimension is M) through ``blocks`` placed by
    :func:`place_stages`.  Returns the M outputs, on the last stage's
    device.  Blocks in train mode update their BatchNorm statistics once
    per microbatch, in microbatch order; gradients flow back through the
    schedule."""
    n_stages = mesh.shape[axis]
    per = len(blocks) // n_stages
    if len(blocks) % n_stages:
        raise ValueError(
            f"{len(blocks)} blocks do not split over {n_stages} stages")
    stages = [list(blocks[p * per:(p + 1) * per]) for p in range(n_stages)]
    devices = [_stage_device(s) for s in stages]
    xs = list(xs)
    n_micro = len(xs)
    inbox: list = [None] * n_stages  # the activation waiting at each stage
    outs: list = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        # the last stage first, so that a stage's output of this tick does
        # not overwrite what the next stage has still to take
        for p in reversed(range(n_stages)):
            k = t - p
            if not 0 <= k < n_micro:
                continue
            h = (xs[k] if p == 0 else inbox[p]).to(devices[p],
                                                  non_blocking=True)
            for block in stages[p]:
                h = block(h)
            if p == n_stages - 1:
                outs[k] = h
            else:
                inbox[p + 1] = h
    return outs


def pipeline_apply(blocks: Sequence[nn.Module], x: torch.Tensor, mesh: Mesh,
                   axis: str = "pipe",
                   num_microbatches: int | None = None) -> torch.Tensor:
    """``x`` (the global batch) through the pipelined ``blocks`` in
    ``num_microbatches`` microbatches (default: the stage count), the
    outputs concatenated on the last stage's device: the result of the
    blocks applied in sequence."""
    n_micro = num_microbatches or mesh.shape[axis]
    if x.shape[0] % n_micro:
        raise ValueError(
            f"batch {x.shape[0]} does not split into {n_micro} microbatches")
    return torch.cat(pipeline_apply_stateful(blocks, x.chunk(n_micro), mesh,
                                             axis))
