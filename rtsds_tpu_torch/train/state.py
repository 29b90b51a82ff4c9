"""Train state: the model, its optimizer and the compute dtype.

The model and the optimizer are updated in place by each train step;
``step`` is the optimizer's count of steps taken, which also drives the
learning-rate schedule.  ``state_dict``/``load_state_dict`` carry all of
it, for checkpoints; under the model axis (``parallel/fsdp.py``) they
gather the whole tensors and cut them back into this rank's shards, so a
checkpoint is the replicated run's.
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
        sharded = getattr(self.optimizer, "sharded", None)
        if sharded is None:
            return {"step": self.step, "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict()}
        return {"step": self.step, "model": sharded.model_state_dict(),
                "optimizer": sharded.optimizer_state_dict(self.optimizer)}

    def load_state_dict(self, state: dict) -> None:
        sharded = getattr(self.optimizer, "sharded", None)
        if sharded is None:
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
            return
        sharded.load_model_state_dict(state["model"])
        sharded.load_optimizer_state_dict(self.optimizer, state["optimizer"])
