"""Dtype helpers shared by models and ops."""

from __future__ import annotations

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Promote to float32 without downcasting: bf16 -> f32, f64 stays f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
