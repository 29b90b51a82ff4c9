"""W8A8 int8 serving path of DeepLabV2 (post-training quantization).

Counterpart of ``rtsds_tpu/models/deeplab_int8.py``, over the shared
pipeline in ``ops/quant.py``: :func:`fold_deeplab` (every frozen BN folded
into its conv, read from the port's state dict) -> :func:`calibrate`
(static per-conv activation scales) -> :func:`build_quantized`
(per-output-channel int8 weights; a policy keeps the other convs in bf16)
-> :func:`deeplab_int8_apply`.

The topology walk exists once (:func:`_forward`) and mirrors
``models/deeplabv2.py``: the 7x7/s2 stem, BN and ReLU, the ceil-mode max
pool, Bottleneck stages with the stride on the first 1x1 and dilation 2/4
on stages 3/4, the summed 4-branch ASPP and the bilinear resize to the
input size.  Conv names are the JAX package's (``conv1``,
``layer3_0/conv2``, ``layer6/conv2d_list_0``).
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from rtsds_tpu_torch.models.layers import max_pool_3x3_s2
from rtsds_tpu_torch.ops.quant import (
    build_quantized_net, calibrate_net, fold_state, make_bf16_op,
    make_quant_op)
from rtsds_tpu_torch.ops.resize import resize_bilinear

ASPP_DILATIONS = (6, 12, 18, 24)
# (width, stride, dilation) of each stage
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))


def _block_counts(names) -> list[int]:
    """Stage block counts from ``layer{s}_{i}``-style conv names."""
    counts = [0, 0, 0, 0]
    for name in names:
        m = re.match(r"layer([1-4])_(\d+)", name)
        if m:
            s, i = int(m.group(1)), int(m.group(2))
            counts[s - 1] = max(counts[s - 1], i + 1)
    if not all(counts):
        raise ValueError("conv names do not look like DeepLabV2 "
                         f"(stage blocks found: {counts})")
    return counts


def conv_bn_pairs(state: Mapping) -> list[tuple[str, str, str | None]]:
    """Every conv as ``(JAX conv name, state-dict prefix of the conv,
    prefix of its BN or None)``."""
    pairs = [("conv1", "conv1", "bn1")]
    blocks = sorted({(int(m.group(1)), int(m.group(2))) for m in (
        re.fullmatch(r"layer([1-4])\.(\d+)\.conv1\.weight", k)
        for k in state) if m})
    for s, i in blocks:
        prefix, name = f"layer{s}.{i}", f"layer{s}_{i}"
        for cv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")):
            pairs.append((f"{name}/{cv}", f"{prefix}.{cv}", f"{prefix}.{bn}"))
        if f"{prefix}.downsample.0.weight" in state:
            pairs.append((f"{name}/downsample_conv", f"{prefix}.downsample.0",
                          f"{prefix}.downsample.1"))
    for i in range(len(ASPP_DILATIONS)):
        pairs.append((f"layer6/conv2d_list_{i}", f"layer6.conv2d_list.{i}",
                      None))
    return pairs


def fold_deeplab(state: Mapping) -> dict:
    """Fold every frozen BN of a DeepLabV2 state dict into its conv:
    ``{name: (OIHW kernel, bias or None)}``; exact at serving time, where
    the BNs run on their running statistics."""
    return fold_state(state, conv_bn_pairs(state))


fold = fold_deeplab


def _forward(op: Callable, x: torch.Tensor, block_counts):
    """The single topology walk over (N, 3, H, W) input;
    ``op(name, x, stride, padding, dilation)`` performs one BN-folded
    conv."""
    in_size = x.shape[-2:]
    x = F.relu(op("conv1", x, 2, 3, 1))
    x = max_pool_3x3_s2(x, ceil_mode=True)
    for stage_idx, ((width, stride, dilation), n_blocks) in enumerate(
            zip(STAGES, block_counts)):
        for block_idx in range(n_blocks):
            name = f"layer{stage_idx + 1}_{block_idx}"
            first = block_idx == 0
            s = stride if first else 1
            needs_proj = first and (
                stride != 1 or x.shape[1] != width * 4
                or dilation in (2, 4))
            identity = x
            out = F.relu(op(f"{name}/conv1", x, s, 0, 1))
            out = F.relu(op(f"{name}/conv2", out, 1, dilation, dilation))
            out = op(f"{name}/conv3", out, 1, 0, 1)
            if needs_proj:
                identity = op(f"{name}/downsample_conv", x, s, 0, 1)
            x = F.relu(out + identity)
    logits = None
    for i, d in enumerate(ASPP_DILATIONS):
        branch = op(f"layer6/conv2d_list_{i}", x, 1, d, d)
        logits = branch if logits is None else logits + branch
    return resize_bilinear(logits, in_size)


def make_walk(names) -> Callable:
    """``walk(op, x)``: :func:`_forward` closed over the block counts the
    conv ``names`` give."""
    block_counts = _block_counts(names)
    return lambda op, x: _forward(op, x, block_counts)


def calibrate(state: Mapping, batches, folded: dict | None = None,
              stat: str = "max", percentile: float = 99.9) -> dict:
    """Static per-conv-input activation scales from calibration batches
    ((N, 3, H, W) after the production preprocess; see
    ``ops/quant.py:calibrate_net``).  Convs sharing an input (a
    bottleneck's conv1 and downsample, the ASPP branches) record identical
    scales.  ``folded``: a precomputed :func:`fold_deeplab` tree, on the
    batches' device."""
    if folded is None:
        folded = fold_deeplab(state)
    return calibrate_net(make_walk(folded), folded, batches, stat=stat,
                         percentile=percentile)


def default_policy(name: str, kernel_shape) -> bool:
    """Quantize the 3x3 convs and the 1x1 bottleneck expansions
    (``conv3``); keep the ASPP classifier, the 7x7 stem and the 1x1
    reductions and projections in bf16: the JAX package's selection.
    ``kernel_shape`` is OIHW, so the kernel height is ``kernel_shape[2]``.
    """
    if name.startswith("layer6/"):
        return False
    return kernel_shape[2] == 3 or name.endswith("/conv3")


def build_quantized(state: Mapping, act_scales: dict,
                    policy: Callable = default_policy,
                    folded: dict | None = None) -> dict:
    """The quantized tree (see ``ops/quant.py:build_quantized_net``)."""
    if folded is None:
        folded = fold_deeplab(state)
    return build_quantized_net(folded, act_scales, policy)


def deeplab_int8_apply(qtree: dict, x: torch.Tensor,
                       output_f32: bool = False,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """The quantized serving forward of (N, 3, H, W) input.
    ``out_dtype=torch.float32`` dequantizes in float32 (the tests' exact
    surface)."""
    walk = make_walk(list(qtree["q8"]) + list(qtree["bf16"]))
    logits = walk(make_quant_op(qtree, out_dtype), x.to(out_dtype))
    return logits.to(torch.float32) if output_f32 else logits


def deeplab_bf16_apply(state: Mapping, x: torch.Tensor,
                       output_f32: bool = False,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """The BN-folded forward through the same walk: the baseline, and at
    ``dtype=torch.float32`` the fold's exactness surface against the
    model."""
    folded = fold_deeplab(state)
    logits = make_walk(folded)(make_bf16_op(folded, out_dtype=dtype),
                               x.to(dtype))
    return logits.to(torch.float32) if output_f32 else logits
