"""Train state: the model, its optimizer and the compute dtype.

The model and the optimizer are updated in place by each train step;
``step`` is the optimizer's count of steps taken, which also drives the
learning-rate schedule.  ``state_dict``/``load_state_dict`` carry all of
it, for checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from rtsds_tpu_torch.train.optim import ScheduledOptimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: ScheduledOptimizer
    # None computes in the parameters' dtype (float32); torch.bfloat16 runs
    # forward and loss under autocast, with float32 parameters and logits
    compute_dtype: torch.dtype | None = None

    @property
    def step(self) -> int:
        return self.optimizer.count

    @property
    def schedule(self):
        return self.optimizer.learning_rate

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def autocast(self):
        """The context the forward and the loss run in."""
        if self.compute_dtype in (None, torch.float32):
            return contextlib.nullcontext()
        return torch.autocast(device_type=self.device.type,
                              dtype=self.compute_dtype)

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
