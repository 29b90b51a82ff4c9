"""FLOPs and parameter counts of a model's forward, and the card's peak.

Counterpart of ``rtsds_tpu/bench/flops.py``, whose counts come from XLA's
cost analysis of the compiled program (every op, elementwise included).
Here ``torch.utils.flop_counter.FlopCounterMode`` counts the forward's
convolutions and matrix products, 2 FLOPs a multiply-add, on tensors of
the ``meta`` device: shapes only, so counting a 1024x2048 batch costs no
memory and no compute.  Resizes, batch norm, pooling, activations and other
elementwise ops go uncounted; the count is the work of the tensor cores.

:data:`BF16_DENSE_PEAK_FLOPS` holds the published dense bf16 rate of each
card this port was measured on, keyed by ``torch.cuda.get_device_name()``;
:func:`mfu` is None for a card not in it.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA's data sheet, H100 SXM, dense (no sparsity), at its 700 W limit
BF16_DENSE_PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def count_parameters(model: nn.Module) -> int:
    """Parameter count (``utils.py:143-144``): every parameter tensor,
    frozen ones too, as the JAX package counts its ``params`` tree."""
    return sum(p.numel() for p in model.parameters())


def model_flops(model: nn.Module, input_shape, train: bool = False) -> dict:
    """FLOPs and parameters of one forward of ``model`` on an (N, H, W, C)
    input (the JAX package's layout; the model runs NCHW), in train or eval
    mode: ``{"flops", "flops_by_op", "parameters"}``.  The model's own
    tensors are not touched: the forward runs on ``meta`` stand-ins."""
    n, h, w, c = input_shape
    tensors = {k: torch.empty_like(v, device="meta") for k, v in
               [*model.named_parameters(), *model.named_buffers()]}
    x = torch.empty((n, c, h, w), device="meta",
                    dtype=next(model.parameters()).dtype)
    was_training = model.training
    model.train(train)
    counter = FlopCounterMode(display=False)
    try:
        with counter, torch.no_grad():
            functional_call(model, tensors, (x,))
    finally:
        model.train(was_training)
    by_op = {str(op): int(v) for op, v in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(counter.get_total_flops()), "flops_by_op": by_op,
            "parameters": count_parameters(model)}


def mfu(flops: float, ms: float, device_name: str) -> float | None:
    """Model FLOPs utilization: ``flops`` done in ``ms`` over the card's
    dense bf16 peak; None for a card whose peak is not in the table."""
    peak = BF16_DENSE_PEAK_FLOPS.get(device_name)
    if peak is None or not ms > 0:
        return None
    return flops / (ms / 1e3) / peak
