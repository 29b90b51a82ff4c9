"""Everything a run makes from ``--seed``: sub-seeds, weights and inputs,
made on the device in a few large calls."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed of its own for each use of one run's seed."""
    state = np.random.SeedSequence([seed % 2 ** 64, *tags]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _kinds(model: nn.Module) -> dict[str, str]:
    kinds = {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, nn.Conv2d):
            kinds[prefix + "weight"] = "conv_w"
            kinds[prefix + "bias"] = "conv_b"
        elif isinstance(m, nn.BatchNorm2d):
            for leaf, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                               ("running_mean", "bn_mean"),
                               ("running_var", "bn_var"),
                               ("num_batches_tracked", "count")):
                kinds[prefix + leaf] = kind
    return kinds


def make_weights(model: nn.Module, seed: int, device) -> dict:
    """A state dict for ``model``'s keys (the reference's, which are the
    program's), from one normal draw on ``device``: conv kernels at He's
    scale (std sqrt(2 / fan_in)), conv biases at std 0.01, batch-norm
    scales 1 + N(0, 0.1^2), shifts and running means N(0, 0.1^2), running
    variances 1 + |N(0, 0.1^2)|, counters 0; float32."""
    kinds = _kinds(model)
    state = model.state_dict()
    floats = [k for k, v in state.items() if v.is_floating_point()]
    total = sum(state[k].numel() for k in floats)
    draw = torch.randn(total, generator=generator(seed, device),
                       device=device)
    out, at = {}, 0
    for k, v in state.items():
        if not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            continue
        n = v.numel()
        z = draw[at:at + n].view(v.shape)
        at += n
        kind = kinds[k]
        if kind == "conv_w":
            t = z * (2.0 / (v[0].numel())) ** 0.5
        elif kind == "conv_b":
            t = z * 0.01
        elif kind == "bn_w":
            t = 1.0 + 0.1 * z
        elif kind == "bn_var":
            t = 1.0 + 0.1 * z.abs()
        else:
            t = 0.1 * z
        out[k] = t
    return out


# the 19 training colours, then two void colours that the label transform
# does not know (unlabelled, ground)
PALETTE = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32], [0, 0, 0], [111, 74, 0]], dtype=np.uint8)


def scenes(seed: int, n: int, hw, block: int, device):
    """``n`` colour-coded label maps of blocks of ``block`` x ``block``
    pixels, each block one of the 21 palette colours, and frames of the
    same scenes (the block's colour plus uniform noise of +-48), both
    (n, H, W, 3) uint8 on ``device``."""
    h, w = hw
    if h % block or w % block:
        raise ValueError(f"{hw} is not a multiple of the block {block}")
    g = generator(seed, device)
    ids = torch.randint(0, len(PALETTE), (n, h // block, w // block),
                        generator=g, device=device)
    ids = ids.repeat_interleave(block, 1).repeat_interleave(block, 2)
    colours = torch.as_tensor(PALETTE, device=device)[ids]
    noise = torch.randint(-48, 49, colours.shape, generator=g, device=device,
                          dtype=torch.int16)
    frames = (colours.to(torch.int16) + noise).clamp(0, 255).to(torch.uint8)
    return frames, colours
