"""Dtype helpers shared by models and ops."""

from __future__ import annotations

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Promote to float32 without downcasting: bf16 -> f32, f64 stays f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def model_dtype(model: torch.nn.Module) -> torch.dtype:
    """The dtype a model's input is cast to: its declared ``compute_dtype``
    (the int8 model's bf16, whose tensors are int8 and float32 buffers),
    else the dtype of its first parameter."""
    declared = getattr(model, "compute_dtype", None)
    if declared is not None:
        return declared
    return next(model.parameters()).dtype
