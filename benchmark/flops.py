"""FLOPs of the cells' work and the card's peaks.

A frozen copy of the program's counter (``torch.utils.flop_counter`` over
a forward on ``meta`` tensors: convolutions and matrix products, 2 FLOPs a
multiply-add; resizes, batch norm, pooling and elementwise work go
uncounted), applied to the benchmark's own reference models, so that no
change to the program moves the count.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA's data sheet, H100 SXM, dense, at its 700 W limit
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                                   "hbm_bytes_per_s": 3.35e12}}


def peak(card: str, key: str) -> float | None:
    return PEAKS.get(card, {}).get(key)


def _on_meta(model):
    return model.to_empty(device="meta")


def forward_flops(model, n: int, hw) -> int:
    """One eval forward of ``n`` frames of ``hw``."""
    model = _on_meta(model).eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.empty((n, 3, *hw), device="meta"))
    return int(counter.get_total_flops())


def da_step_flops(gen, dis, n: int, src_hw, tgt_hw) -> int:
    """One adversarial v1 step: the generator's forward and backward on
    the source and on the target (through the discriminator, which takes no
    weight gradient), then the discriminator's forward and backward on
    both softmax maps.  No recompute is counted."""
    import torch.nn.functional as F

    gen, dis = _on_meta(gen).train(), _on_meta(dis).train()
    counter = FlopCounterMode(display=False)
    with counter:
        heads = [h for h in gen(torch.empty((n, 3, *src_hw), device="meta"))
                 if h is not None]
        sum(h.sum() for h in heads).backward()
        for p in dis.parameters():
            p.requires_grad_(False)
        tgt = gen(torch.empty((n, 3, *tgt_hw), device="meta"))[0]
        dis(F.softmax(tgt, dim=1)).sum().backward()
        for p in dis.parameters():
            p.requires_grad_(True)
        src = heads[0].detach()
        (dis(F.softmax(src, dim=1)).sum()
         + dis(F.softmax(tgt.detach(), dim=1)).sum()).backward()
    return int(counter.get_total_flops())
