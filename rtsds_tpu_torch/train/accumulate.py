"""Gradient accumulation: one optimizer update from K micro-batches.

Counterpart of ``rtsds_tpu/train/accumulate.py``.  The K micro-batches run
in order, each forward in train mode and its main + auxiliary cross entropy
backpropagated divided by K, so the gradients the update sees are the mean
of the micro-batches' gradients; then the gradient clip and one optimizer
step, so ``optimizer.count`` (and the learning-rate schedule) advances once
per accumulated step.  An effective batch of K x micro trains with the
activation memory of one micro-batch.

Batch-norm running statistics update once per micro-batch, K times a step,
as the JAX package's ``lax.scan`` threads them.  With ``ignore_index``
masking, each micro-batch's loss is a mean over its own valid pixels, so
micro-batches weigh equally, not pixels.

Under the data axis (``parallel/distributed.py``) each rank splits its
shard, and micro-batch k is the union of the ranks' k-th slices: its
BatchNorm statistics and loss denominators are that union's.  The loader
gives rank r its share of each of the global batch's K contiguous
micro-batches (``data/multihost.py``, ``shard_positions``), so that union
is the JAX package's micro-batch k of the same global batch.  Under the
spatial axis micro-batch k is the k-th batch slice of every band: its
BatchNorm runs over its bands (and the data group's), and its ``correct``
sums over them.
"""

from __future__ import annotations

from typing import Callable

import torch

from rtsds_tpu_torch.ops.losses import segmentation_loss
from rtsds_tpu_torch.parallel.distributed import reduce_metrics, world_size
from rtsds_tpu_torch.parallel.spatial import (
    Bands, FrameBands, split_micro_batches)
from rtsds_tpu_torch.train.state import TrainState


def split_microbatches(batch: torch.Tensor, accum_steps: int) -> torch.Tensor:
    """(K * micro, ...) -> (K, micro, ...), a view; raises when K does not
    divide the batch.  A height-banded batch (``parallel/spatial.py``)
    splits into K micro-batches of consecutive frames, each a batch slice
    of every band (:func:`~rtsds_tpu_torch.parallel.spatial.
    split_micro_batches`)."""
    if isinstance(batch, (Bands, FrameBands)):
        return split_micro_batches(batch, accum_steps)
    n = batch.shape[0]
    if n % accum_steps:
        raise ValueError(
            f"batch {n} does not split into {accum_steps} micro-batches")
    return batch.reshape(accum_steps, n // accum_steps, *batch.shape[1:])


def make_accumulating_train_step(ignore_index: int | None = 19) -> Callable:
    """``train_step(state, images, labels) -> metrics``.

    ``images``: (K, micro, H, W, 3) normalized floats; ``labels``: (K,
    micro, H, W) ints (:func:`split_microbatches` of a flat batch); K is
    read off the leading dimension.  ``state`` is updated in place.  The
    metrics: ``train_loss``, the mean of the K losses; ``correct``, the
    main-head pixels equal to the label over all micro-batches; ``total``,
    every label pixel.
    """

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> dict:
        accum_steps, micro = images.shape[:2]
        need = getattr(state.model, "min_train_batch", 1)
        if micro * world_size() < need:
            raise ValueError(
                f"training needs a batch of at least {need} frames, got "
                f"micro-batches of {micro} ({accum_steps} x {micro} frames): "
                f"the attention gates' batch norm runs over one pooled value "
                f"per frame; use fewer accumulate_steps")
        model = state.model.train()
        state.optimizer.zero_grad()
        loss_sum = torch.zeros((), device=images.device)
        correct = torch.zeros((), dtype=torch.int64, device=images.device)
        for mb_images, mb_labels in zip(images, labels):
            with state.autocast():
                outputs = model(mb_images.permute(0, 3, 1, 2))
                loss = segmentation_loss(outputs, mb_labels, ignore_index)
            (loss / accum_steps).backward()
            main = outputs[0] if isinstance(outputs, (tuple, list)) \
                else outputs
            with torch.no_grad():
                loss_sum = loss_sum + loss.detach()
                correct = correct + (main.argmax(dim=1) == mb_labels).sum()
            del outputs, main
        state.optimizer.step()
        return reduce_metrics({"train_loss": loss_sum / accum_steps,
                               "correct": correct, "total": labels.numel()})

    return train_step
