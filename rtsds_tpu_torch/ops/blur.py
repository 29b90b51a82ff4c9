"""Gaussian blur as two depthwise 1-D convolutions (NHWC in and out).

The semantics of ``torchvision.transforms.GaussianBlur``: ``kernel_size``
is (kx, ky), width first; sigma is one scalar (drawn from its range in
:mod:`rtsds_tpu_torch.ops.augment`); each 1-D kernel is a normalised
gaussian; borders are reflect-padded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel1d(kernel_size: int, sigma: float,
                      device=None) -> torch.Tensor:
    half = (kernel_size - 1) / 2.0
    x = torch.linspace(-half, half, kernel_size, dtype=torch.float32,
                       device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(x: torch.Tensor, kernel_size: tuple[int, int],
                  sigma: float) -> torch.Tensor:
    """Blur (N, H, W, C) or (H, W, C) float images; the dtype is kept and
    the arithmetic is float32."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    c = x.shape[-1]
    kx, ky = int(kernel_size[0]), int(kernel_size[1])
    dtype = x.dtype
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    xf = F.pad(xf, (kx // 2, kx // 2, ky // 2, ky // 2), mode="reflect")
    kern_x = gaussian_kernel1d(kx, sigma, x.device)
    kern_y = gaussian_kernel1d(ky, sigma, x.device)
    xf = F.conv2d(xf, kern_x.reshape(1, 1, 1, kx).expand(c, 1, 1, kx),
                  groups=c)
    xf = F.conv2d(xf, kern_y.reshape(1, 1, ky, 1).expand(c, 1, ky, 1),
                  groups=c)
    out = xf.permute(0, 2, 3, 1).to(dtype)
    return out[0] if squeeze else out
