"""Precision of the reference's convolutions.

``float32`` computes them as they are (the reference; TF32 is off while it
runs, see :func:`strict_float32`).  ``fp8`` is the control: each conv's
input and weight are rounded to float8 e4m3 with a per-tensor scale (its
largest magnitude onto 448) and, in the backward, each gradient that flows
into them to float8 e5m2 (onto 57344), the usual recipe of float8
training.  Everything else stays float32.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, fmax: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = fmax / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def float32(x: torch.Tensor) -> torch.Tensor:
    return x


CASTS = {"float32": float32, "fp8": fp8}


@contextlib.contextmanager
def strict_float32():
    """TF32 off for cuDNN convolutions and matmuls inside the block; the
    settings outside it are put back on exit."""
    kept = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = kept
