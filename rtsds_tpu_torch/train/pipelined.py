"""Pipelined supervised train step: DeepLabV2 with its homogeneous layer3
bottlenecks GPipe-scheduled over a ``pipe`` mesh of stage devices.

Counterpart of ``rtsds_tpu/train/pipelined.py``.  The network splits into

  front  (stem, layer1, layer2, layer3.0)   -- on the first stage's device
  blocks (layer3.1 .. layer3.{n-1})         -- pipelined over ``pipe``
  tail   (layer4, ASPP, upsample)           -- on the first stage's device

The front and the tail run the M microbatches in order; the blocks run the
tick schedule of ``parallel/pipeline.py``; one ``backward()`` of the mean
of the M losses runs the reverse schedule on autograd's per-device
threads.  The semantics are gradient accumulation over M microbatches
(``train/accumulate.py``): per-microbatch BatchNorm statistics, running
statistics advanced in microbatch order, the gradient of the mean loss,
one optimizer update.

The blocks stay where :func:`make_pipelined_train_step` places them, each
stage's first block with a hook that moves its input to the stage's
device, so the model's own forward (validation, the EMA, serving) runs
with the stages on separate GPUs; checkpoints carry the same state dict.
That placement is not verified on more than one GPU yet.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.layers import max_pool_3x3_s2
from rtsds_tpu_torch.ops.losses import segmentation_loss
from rtsds_tpu_torch.ops.resize import resize_bilinear
from rtsds_tpu_torch.parallel.mesh import Mesh
from rtsds_tpu_torch.parallel.pipeline import (
    pipeline_apply_stateful, place_stages, to_device_hook)
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.utils.dtypes import at_least_f32


def pipe_blocks(model: DeepLabV2) -> list:
    """The homogeneous blocks the schedule pipelines: layer3.1 onward."""
    if not isinstance(model, DeepLabV2):
        raise ValueError(
            f"pipelined training supports DeepLabV2 only (its layer3 "
            f"bottlenecks are the homogeneous stage unit); got "
            f"{type(model).__name__}")
    blocks = list(model.layer3)[1:]
    if not blocks:
        raise ValueError(f"a layer3 of {len(model.layer3)} block(s) has no "
                         f"homogeneous blocks to pipeline")
    return blocks


def place_pipeline(model: DeepLabV2, mesh: Mesh) -> None:
    """The model on ``mesh.devices[0]`` with its pipe blocks placed stage
    by stage (``parallel/pipeline.py:place_stages``); layer4 takes its
    input back to the first device."""
    blocks = pipe_blocks(model)
    n_stages = mesh.shape["pipe"]
    if len(blocks) % n_stages:
        valid = [p for p in range(1, len(blocks) + 1)
                 if len(blocks) % p == 0]
        raise ValueError(
            f"{len(blocks)} homogeneous layer3 blocks (layers="
            f"{tuple(len(getattr(model, f'layer{i}')) for i in range(1, 5))})"
            f" do not split over pipe={n_stages} stages; valid pipe sizes: "
            f"{valid}")
    model.to(mesh.devices[0])
    place_stages(blocks, mesh)
    for handle in getattr(model.layer4, "_stage_hooks", ()):
        handle.remove()
    model.layer4._stage_hooks = [model.layer4.register_forward_pre_hook(
        to_device_hook(mesh.devices[0]))]
    model.pipe_mesh = mesh


def _front(model: DeepLabV2, x: torch.Tensor) -> torch.Tensor:
    h = max_pool_3x3_s2(F.relu(model.bn1(model.conv1(x))), ceil_mode=True)
    return model.layer3[0](model.layer2(model.layer1(h)))


def _tail(model: DeepLabV2, h: torch.Tensor, in_size) -> torch.Tensor:
    out = resize_bilinear(model.layer6(model.layer4(h)), in_size)
    return at_least_f32(out) if model.output_f32 else out


def make_pipelined_train_step(model: DeepLabV2, mesh: Mesh,
                              ignore_index: int | None = 19,
                              num_microbatches: int | None = None
                              ) -> Callable:
    """``train_step(state, images, labels) -> metrics`` with layer3
    pipelined over the mesh's ``pipe`` axis; ``state.model`` must be
    ``model``, which this places (:func:`place_pipeline`).

    ``images``: normalized (N, H, W, 3) floats, ``labels`` (N, H, W) ints,
    on any device; ``num_microbatches`` (default: the stage count) must
    divide N.  The metrics are ``make_train_step``'s: ``train_loss`` (the
    mean of the M losses), ``correct`` and ``total``."""
    place_pipeline(model, mesh)
    blocks = pipe_blocks(model)
    n_micro = (mesh.shape["pipe"] if num_microbatches is None
               else int(num_microbatches))
    if n_micro < 1:
        raise ValueError(f"num_microbatches={num_microbatches} must be >= 1")
    device = mesh.devices[0]

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> dict:
        if state.model is not model:
            raise ValueError("the state's model is not the pipelined model")
        if images.shape[0] % n_micro:
            raise ValueError(
                f"batch {images.shape[0]} does not split into {n_micro} "
                f"pipeline microbatches")
        in_size = tuple(images.shape[1:3])
        imgs = images.to(device).permute(0, 3, 1, 2).chunk(n_micro)
        lbls = labels.to(device).chunk(n_micro)
        model.train()
        state.optimizer.zero_grad()
        with state.autocast():
            hs = [_front(model, x) for x in imgs]
            hs = pipeline_apply_stateful(blocks, hs, mesh)
            loss_sum = 0.0
            correct = torch.zeros((), dtype=torch.int64, device=device)
            for h, lbl in zip(hs, lbls):
                logits = _tail(model, h.to(device), in_size)
                loss_sum = loss_sum + segmentation_loss(
                    (logits, None, None), lbl, ignore_index)
                with torch.no_grad():
                    correct = correct + (logits.argmax(dim=1) == lbl).sum()
            loss = loss_sum / n_micro
        loss.backward()
        state.optimizer.step()
        return {"train_loss": loss.detach(), "correct": correct,
                "total": labels.numel()}

    return train_step
