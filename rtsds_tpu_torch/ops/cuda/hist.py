"""Confusion matrix on the GPU: the wrapper of ``csrc/hist.cu``.

Counterpart of ``rtsds_tpu/ops/pallas/hist.py``.  On CPU tensors the
wrapper computes the plain PyTorch version
(:func:`rtsds_tpu_torch.utils.metrics.fast_hist`); on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from rtsds_tpu_torch.ops.cuda import _build
from rtsds_tpu_torch.utils.metrics import fast_hist

MAX_CLASSES = 128  # the kernel's n x n int32 bins fit in 64 KB of smem
BLOCKS_PER_SM = 4  # 4 x 512 threads fill an SM
# the id dtypes the kernel reads as they are, by their code in csrc/hist.cu;
# any other integer dtype is cast to int32 first
ID_TYPES = {torch.int32: 0, torch.int64: 1, torch.uint8: 2}


def fast_hist_cuda(labels: torch.Tensor, preds: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """(n, n) int32 confusion matrix of integer ``labels`` and ``preds`` of
    any one shape.  A pixel counts only when both ids lie in [0, n).

    int32, int64 and uint8 ids go to the kernel as they are (a contiguous
    tensor is not copied); other integer dtypes are cast to int32."""
    if not 0 < num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {MAX_CLASSES}], got "
                         f"{num_classes}")
    if labels.shape != preds.shape:
        raise ValueError(f"labels {tuple(labels.shape)} and preds "
                         f"{tuple(preds.shape)} differ in shape")
    for t in (labels, preds):
        if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
            raise TypeError(f"expected integer ids, got {t.dtype}")
    if labels.device.type == "cpu" and preds.device.type == "cpu":
        return fast_hist(labels, preds, num_classes)
    if labels.device.type != "cuda" or preds.device != labels.device:
        raise ValueError(f"labels on {labels.device} and preds on "
                         f"{preds.device}: both must be on one CUDA device")

    device = labels.device
    labels, preds = (
        (t if t.dtype in ID_TYPES else t.to(torch.int32)).reshape(-1)
        .contiguous() for t in (labels, preds))
    out = torch.zeros((num_classes, num_classes), dtype=torch.int32,
                      device=device)
    n_pixels = labels.numel()
    if n_pixels == 0:
        return out
    if n_pixels > torch.iinfo(torch.int32).max:
        raise ValueError(f"{n_pixels} pixels could overflow the int32 "
                         f"counts; split the call")
    lib = _build.load()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):  # the launch goes to the current device
        code = lib.rtsds_hist_launch(
            labels.data_ptr(), preds.data_ptr(), out.data_ptr(), n_pixels,
            num_classes, sms * BLOCKS_PER_SM, ID_TYPES[labels.dtype],
            ID_TYPES[preds.dtype],
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, code, "confusion-matrix kernel launch")
    fast_hist_cuda.launches += 1
    return out


fast_hist_cuda.launches = 0  # kernel launches since the last reset
