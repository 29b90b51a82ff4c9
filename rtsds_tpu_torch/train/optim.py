"""Optimizers: ``torch.optim`` Adam or SGD, driven by a learning-rate
schedule and an optional global-norm gradient clip.

The update rule, in order:
  0. the gradients of the ``frozen`` parameters (DeepLabV2's batch-norm
     affines) are set to zero, a missing one created as zero;
  1. ``grad_clip``: when the global norm of all gradients exceeds it, every
     gradient is scaled by ``grad_clip / norm`` (before the moments);
  2. Adam (betas 0.9, 0.999, eps 1e-8, ``weight_decay`` added to the
     gradient before the moments, not decoupled AdamW) or SGD with
     heavy-ball momentum (no dampening, no Nesterov, and no weight decay,
     as in the JAX package's SGD chain);
  3. the learning rate ``schedule(count) * lr_mult`` of each param group,
     where ``count`` is the number of steps taken before this one, so the
     first step uses ``schedule(0)``.

So a frozen parameter stays exactly still under SGD and under Adam without
weight decay, and under Adam with ``weight_decay > 0`` it moves by the
decay's update alone, as it does in the JAX package, whose chain zeroes
the frozen updates before ``add_decayed_weights``.

``head_lr_mult`` puts the parameters a segmentor's ``is_head`` names
(BiSeNet: all but the pretrained ``context_path``; DeepLabV2: the
``layer6`` classifier) into a second param group whose rate is scaled by
it; on a model without ``is_head`` (a discriminator) it raises.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch import nn

from rtsds_tpu_torch.utils.schedules import Schedule


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer with the schedule and the clip above.

    Param groups may carry an ``lr_mult`` (default 1).  ``count`` is the
    number of steps taken; it is saved with the optimizer's state.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 learning_rate: float | Schedule, grad_clip: float = 0.0,
                 frozen: Iterable[torch.Tensor] = ()):
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.grad_clip = float(grad_clip)
        self.frozen = list(frozen)
        self.count = 0

    @property
    def param_groups(self) -> list[dict]:
        return self.optimizer.param_groups

    def current_lr(self) -> float:
        """The base rate the next step uses."""
        if callable(self.learning_rate):
            return float(self.learning_rate(self.count))
        return float(self.learning_rate)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.current_lr()
        for group in self.param_groups:
            group["lr"] = lr * group.get("lr_mult", 1.0)
        for p in self.frozen:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        if self.grad_clip:
            clip_by_global_norm(
                [p for g in self.param_groups for p in g["params"]],
                self.grad_clip)
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor],
                        max_norm: float) -> None:
    """Scale the gradients in place by ``max_norm / norm`` when their global
    L2 norm exceeds ``max_norm``; no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def make_optimizer(name: str, param_groups, learning_rate: float | Schedule,
                   weight_decay: float = 0.0, momentum: float = 0.9,
                   grad_clip: float = 0.0,
                   frozen: Iterable[torch.Tensor] = ()) -> ScheduledOptimizer:
    """``param_groups``: parameters, or dicts ``{"params", "lr_mult"}``;
    ``frozen``: parameters among them whose gradient is zeroed first."""
    groups = list(param_groups)
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    if name == "Adam":
        inner = torch.optim.Adam(groups, lr=lr0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    elif name == "SGD":
        inner = torch.optim.SGD(groups, lr=lr0, momentum=momentum)
    else:
        raise ValueError("Invalid optimizer name. Please select Adam or SGD")
    return ScheduledOptimizer(inner, learning_rate, grad_clip, frozen)


def head_param_groups(model: nn.Module, head_mult: float) -> list[dict]:
    """Two groups: the parameters ``model.is_head`` rejects at 1x, those it
    names at ``head_mult``; one group when ``head_mult`` is 0 or 1.  A model
    without ``is_head`` (a discriminator) has no head to scale: raises."""
    if not head_mult or head_mult == 1.0:
        return [{"params": list(model.parameters()), "lr_mult": 1.0}]
    if not hasattr(model, "is_head"):
        raise ValueError(
            f"head_lr_mult is defined for segmentor optimizers only "
            f"(deeplab's ASPP head, bisenet's non-backbone modules), not "
            f"{type(model).__name__}")
    backbone, head = [], []
    for name, p in model.named_parameters():
        (head if model.is_head(name) else backbone).append(p)
    return [{"params": backbone, "lr_mult": 1.0},
            {"params": head, "lr_mult": float(head_mult)}]


def optimizer_from_config(opt_cfg, model: nn.Module,
                          schedule: Callable | None,
                          frozen: Iterable[torch.Tensor] = ()
                          ) -> ScheduledOptimizer:
    """From a config node ``{name, lr[, weight_decay, momentum, grad_clip,
    head_lr_mult]}``; ``schedule`` overrides the static ``lr``; ``frozen``
    as for :func:`make_optimizer`."""
    return make_optimizer(
        opt_cfg["name"],
        head_param_groups(model,
                          float(opt_cfg.get("head_lr_mult", 0.0) or 0.0)),
        learning_rate=schedule if schedule is not None else opt_cfg["lr"],
        weight_decay=float(opt_cfg.get("weight_decay", 0.0) or 0.0),
        momentum=float(opt_cfg.get("momentum", 0.9) or 0.9),
        grad_clip=float(opt_cfg.get("grad_clip", 0.0) or 0.0),
        frozen=frozen)
