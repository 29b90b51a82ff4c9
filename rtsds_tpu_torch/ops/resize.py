"""Resizes of NCHW feature maps, NHWC frames and integer label maps.

``align_corners=False`` samples at half-pixel positions, the convention of
``jax.image.resize(method="bilinear")``; with no antialias the two agree
exactly when upsampling, which is how the models use them.  The ensemble
protocol resizes with ``antialias=True``, ``jax.image.resize``'s default.
Labels resize by nearest neighbour, the floor of the scaled index.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    antialias: bool = False) -> torch.Tensor:
    """Bilinear resize of an (N, C, H, W) tensor to spatial ``size`` (H, W).

    ``antialias=True`` widens the triangle filter where the resize shrinks,
    as ``jax.image.resize(..., antialias=True)`` does; an enlarging resize
    takes the plain filter either way (torch's antialiased kernel would
    differ from it by rounding).
    """
    if x.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    shrinks = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    if x.shape[0] * x.shape[1] * size[0] * size[1] >= 2 ** 31 - 1:
        # ATen's channels-last bilinear kernel refuses an output of 2^31
        # elements or more (BiSeNet's logits at b64, 1024x2048); its NCHW
        # kernel takes it
        x = x.contiguous()
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=antialias and shrinks)


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor bilinear upsample of an (N, C, H, W) tensor."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (h * scale, w * scale))


def resize_images(x: torch.Tensor, size: tuple[int, int],
                  antialias: bool = False) -> torch.Tensor:
    """Bilinear resize of (N, H, W, C) or (H, W, C) float frames to ``size``.

    ``antialias=True`` widens the triangle filter when downscaling, as
    ``jax.image.resize(..., antialias=True)`` does.  Frames already at
    ``size`` come back unchanged.
    """
    if x.ndim not in (3, 4):
        raise ValueError(f"expected HWC or NHWC, got shape {tuple(x.shape)}")
    if tuple(x.shape[-3:-1]) == tuple(size):
        return x
    batched = x if x.ndim == 4 else x[None]
    out = F.interpolate(batched.permute(0, 3, 1, 2), size=tuple(size),
                        mode="bilinear", align_corners=False,
                        antialias=antialias).permute(0, 2, 3, 1)
    return out if x.ndim == 4 else out[0]


def resize_labels_nearest(labels: torch.Tensor,
                          size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (H, W), (N, H, W) or (N, H, W, 1) integer labels.

    Source index ``floor(out_index * in / out)``, computed in float32 as
    the JAX package computes it; rank and dtype are kept.
    """
    if labels.ndim == 4:
        h, w = labels.shape[1:3]
    else:
        h, w = labels.shape[-2:]
    out_h, out_w = size
    if (h, w) == (out_h, out_w):
        return labels
    dev = labels.device
    rows = torch.floor(torch.arange(out_h, dtype=torch.float32, device=dev)
                       * (h / out_h)).long()
    cols = torch.floor(torch.arange(out_w, dtype=torch.float32, device=dev)
                       * (w / out_w)).long()
    if labels.ndim == 4:
        return labels[:, rows][:, :, cols]
    return labels[..., rows, :][..., cols]


def clamp_labels(labels: torch.Tensor, min_val: int = 0,
                 max_val: int = 19) -> torch.Tensor:
    """Clamp label ids into [min_val, max_val] as int32: void 255 becomes
    ``max_val`` (19), which the loss ignores."""
    return torch.clamp(labels, min_val, max_val).to(torch.int32)
