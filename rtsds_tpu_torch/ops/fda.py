"""Fourier Domain Adaptation (FDA): source frames restyled with a target
frame's low-frequency amplitude (Yang & Soatto, CVPR'20).

Counterpart of ``rtsds_tpu/ops/fda.py``.  Each source frame keeps its FFT
phase (edges, semantics) and takes the target's amplitude in the lowest
spatial frequencies (colour cast, illumination), a style transfer with no
parameters.  The FFTs are ``torch.fft`` (cuFFT on the card), as the JAX
package leaves them to XLA.  The frames are normalized NHWC floats, as the
train steps take them, so FDA runs before a step's permute to NCHW.

The JAX package computes in float32 whatever the input's dtype; this one
in at least float32, so a float64 batch stays float64 (the tests hold the
two to the same algorithm in float64, and to each other in float32).
"""

from __future__ import annotations

import numpy as np
import torch

from rtsds_tpu_torch.ops.resize import resize_bilinear
from rtsds_tpu_torch.utils.dtypes import at_least_f32


def low_freq_mask(height: int, width: int, beta: float) -> np.ndarray:
    """(H, W) float32 mask of the low-frequency bins of an unshifted 2-D
    spectrum: bin ``(i, j)`` is in when ``min(i, H - i) < b`` and
    ``min(j, W - j) < b``, ``b = floor(min(H, W) * beta)``.

    The window is symmetric under frequency negation, so splicing the
    amplitudes of two real frames keeps the spectrum Hermitian and the
    inverse real FFT loses nothing.  ``beta = 0`` selects no bin.
    """
    b = int(np.floor(min(height, width) * float(beta)))
    rows = np.minimum(np.arange(height), height - np.arange(height)) < b
    cols = np.minimum(np.arange(width), width - np.arange(width)) < b
    return np.outer(rows, cols).astype(np.float32)


def fda_source_to_target(src_images: torch.Tensor, tgt_images: torch.Tensor,
                         beta: float = 0.01) -> torch.Tensor:
    """(Ns, H, W, C) source frames restyled with the low-frequency amplitude
    of (Nt, H', W', C) target frames.

    The target is resized bilinearly to the source's size where it differs
    (antialiased when it shrinks, as ``jax.image.resize`` does) and tiled
    cyclically over the source batch when ``Nt != Ns``.  ``beta <= 0``
    returns ``src_images`` itself.  The result has the source's dtype.
    """
    if float(beta) <= 0.0:
        return src_images
    ns, h, w, _ = src_images.shape
    src = at_least_f32(src_images)
    tgt = tgt_images.to(src.dtype)
    if tuple(tgt.shape[1:3]) != (h, w):
        tgt = resize_bilinear(tgt.permute(0, 3, 1, 2), (h, w),
                              antialias=True).permute(0, 2, 3, 1)
    if tgt.shape[0] != ns:
        tgt = tgt[torch.arange(ns, device=tgt.device) % tgt.shape[0]]
    # real FFTs: the frames are real and the spliced spectrum Hermitian, so
    # the half spectrum gives the same result as the full one
    fft_src = torch.fft.rfft2(src, dim=(1, 2))
    fft_tgt = torch.fft.rfft2(tgt, dim=(1, 2))
    mask = torch.from_numpy(low_freq_mask(h, w, beta)[:, : w // 2 + 1]).to(
        device=src.device, dtype=src.dtype)[None, :, :, None]
    amp = fft_src.abs() * (1.0 - mask) + fft_tgt.abs() * mask
    out = torch.fft.irfft2(torch.polar(amp, fft_src.angle()), s=(h, w),
                           dim=(1, 2))
    return out.to(src_images.dtype)
