"""Bilinear resizes of NCHW feature maps.

``align_corners=False`` samples at half-pixel positions, the convention of
``jax.image.resize(method="bilinear")``; with no antialias the two agree
exactly when upsampling, which is the only way the models use them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an (N, C, H, W) tensor to spatial ``size`` (H, W)."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor bilinear upsample of an (N, C, H, W) tensor."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (h * scale, w * scale))
