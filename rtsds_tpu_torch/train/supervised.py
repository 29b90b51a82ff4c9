"""Supervised segmentation train step.

Forward in train mode, the cross entropy of the model's heads summed
(BiSeNet's three, DeepLabV2's one), backward, one optimizer step.  The
metrics stay on the device until the loop reads them: the loss, the count of pixels whose main-head
prediction equals the label, and the count of all pixels.  Ignored pixels
count in ``total`` too: they can never be predicted, so they count as
errors, as in the original training script.
"""

from __future__ import annotations

from typing import Callable

import torch

from rtsds_tpu_torch.ops.losses import segmentation_loss
from rtsds_tpu_torch.train.state import TrainState


def check_batch(model: torch.nn.Module, images: torch.Tensor,
                name: str = "") -> None:
    """Raise when ``images`` holds fewer frames than ``model`` trains on:
    its ``min_train_batch`` (BiSeNet's attention gates batch-normalize a
    pooled (N, C, 1, 1) map, whose statistics one frame cannot give)."""
    need = getattr(model, "min_train_batch", 1)
    n = images.shape[0]
    if n < need:
        got = f"{n} {name} frames" if name else str(n)
        raise ValueError(
            f"training needs a batch of at least {need} frames, got {got}: "
            f"the attention gates' batch norm runs over one pooled value per "
            f"frame")


def make_train_step(ignore_index: int | None = 19) -> Callable:
    """``train_step(state, images, labels) -> metrics``.

    ``images``: normalized (N, H, W, 3) float32; ``labels``: (N, H, W)
    int; both on the model's device.  ``state`` is updated in place.
    BiSeNet needs N >= 2 (:func:`check_batch`); DeepLabV2 trains at N = 1.
    """

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> dict:
        check_batch(state.model, images)
        model = state.model.train()
        with state.autocast():
            outputs = model(images.permute(0, 3, 1, 2))
            loss = segmentation_loss(outputs, labels, ignore_index)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        main = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
        with torch.no_grad():
            correct = (main.argmax(dim=1) == labels).sum()
        return {"train_loss": loss.detach(), "correct": correct,
                "total": labels.numel()}

    return train_step
