"""W8A8 int8 serving path of BiSeNet (post-training quantization).

Counterpart of ``rtsds_tpu/models/bisenet_int8.py``, over the shared
pipeline in ``ops/quant.py``: :func:`fold_bisenet` (every serving-time BN
folded into its conv, read from the port's state dict) ->
:func:`calibrate` (static per-conv activation scales) ->
:func:`build_quantized` (per-output-channel int8 weights under a policy)
-> :func:`bisenet_int8_apply`.

The topology walk exists once (:func:`_forward`) and mirrors
``models/bisenet.py`` in its serving configuration (eval mode,
``fast_head``): the spatial path, the ResNet context path (BasicBlock or
Bottleneck stages recovered from the conv names), the ARM gates, the tail
multiply, the bilinear upsample to 1/8, the split-form FFM (the concat
conv computed as a sum of per-part convs, each part with its own
activation scale), the SE gate, and the final 1x1 conv before the 8x
upsample.  Conv names are the JAX package's (``context_path/layer1_0/
conv1``, ``ffm/convblock:p0``, ``arm1/conv``), so scale dicts and
sidecars carry over between the two packages.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from rtsds_tpu_torch.models.layers import global_avg_pool, max_pool_3x3_s2
from rtsds_tpu_torch.ops.quant import (
    build_quantized_net, calibrate_net, fold_state, make_bf16_op,
    make_quant_op)
from rtsds_tpu_torch.ops.resize import resize_bilinear, upsample_bilinear

_WIDTHS = (64, 128, 256, 512)


def _structure(names) -> tuple[list[int], bool]:
    """(block counts per stage, bottleneck?) from the folded conv names."""
    counts = [0, 0, 0, 0]
    bottleneck = False
    for name in names:
        m = re.match(r"context_path/layer([1-4])_(\d+)/(\w+)", name)
        if m:
            s, i = int(m.group(1)), int(m.group(2))
            counts[s - 1] = max(counts[s - 1], i + 1)
            bottleneck |= m.group(3) == "conv3"
    if not all(counts):
        raise ValueError("conv names do not look like BiSeNet "
                         f"(context stage blocks found: {counts})")
    return counts, bottleneck


def conv_bn_pairs(state: Mapping) -> list[tuple[str, str, str | None]]:
    """Every serving-time conv as ``(JAX conv name, state-dict prefix of the
    conv, prefix of its BN or None)``; the FFM's 3x3 conv appears whole as
    ``ffm/convblock`` (:func:`fold_bisenet` splits it).  The supervision
    heads are train-only and left out."""
    pairs = [(f"spatial_path/convblock{i}", f"spatial_path.convblock{i}.conv1",
              f"spatial_path.convblock{i}.bn") for i in (1, 2, 3)]
    pairs.append(("context_path/conv1", "context_path.conv1",
                  "context_path.bn1"))
    blocks = sorted({(int(m.group(1)), int(m.group(2))) for m in (
        re.fullmatch(r"context_path\.layer([1-4])\.(\d+)\.conv1\.weight", k)
        for k in state) if m})
    for s, i in blocks:
        prefix = f"context_path.layer{s}.{i}"
        name = f"context_path/layer{s}_{i}"
        convs = [("conv1", "bn1"), ("conv2", "bn2")]
        if f"{prefix}.conv3.weight" in state:
            convs.append(("conv3", "bn3"))
        for cv, bn in convs:
            pairs.append((f"{name}/{cv}", f"{prefix}.{cv}", f"{prefix}.{bn}"))
        if f"{prefix}.downsample.0.weight" in state:
            pairs.append((f"{name}/downsample_conv", f"{prefix}.downsample.0",
                          f"{prefix}.downsample.1"))
    pairs += [("arm1/conv", "arm1.conv", "arm1.bn"),
              ("arm2/conv", "arm2.conv", "arm2.bn"),
              ("ffm/convblock", "ffm.convblock.conv1", "ffm.convblock.bn"),
              ("ffm/conv1", "ffm.conv1", None), ("ffm/conv2", "ffm.conv2", None),
              ("conv", "conv", None)]
    return pairs


def ffm_part_widths(state: Mapping) -> tuple[int, int, int]:
    """The FFM's input channels per part: (spatial, c16, c32), the context
    widths read from the ARM convs, so ResNet-18 and -101 both work."""
    c16 = state["arm1.conv.weight"].shape[1]
    c32 = state["arm2.conv.weight"].shape[1]
    total = state["ffm.convblock.conv1.weight"].shape[1]
    return total - c16 - c32, c16, c32


def fold_bisenet(state: Mapping) -> dict:
    """Fold every serving-time BN of a BiSeNet state dict into its conv:
    ``{name: (OIHW kernel, bias or None)}``.

    The FFM's 3x3 kernel is split along its input channels (dim 1) into
    ``ffm/convblock:p{i}`` entries; part 0 carries the folded bias, so it
    is added once across the summed parts."""
    folded = fold_state(state, conv_bn_pairs(state))
    kernel, bias = folded.pop("ffm/convblock")
    offset = 0
    for i, c in enumerate(ffm_part_widths(state)):
        folded[f"ffm/convblock:p{i}"] = (kernel[:, offset:offset + c],
                                         bias if i == 0 else None)
        offset += c
    return folded


fold = fold_bisenet


def _forward(op: Callable, x: torch.Tensor, blocks, bottleneck: bool):
    """The single topology walk over (N, 3, H, W) input (the serving
    graph: eval mode, ``fast_head`` ordering)."""
    sx = x
    for i in (1, 2, 3):
        sx = F.relu(op(f"spatial_path/convblock{i}", sx, 2, 1, 1))

    c = F.relu(op("context_path/conv1", x, 2, 3, 1))
    c = max_pool_3x3_s2(c)
    expansion = 4 if bottleneck else 1
    feats = []
    for stage_idx, (width, n_blocks) in enumerate(zip(_WIDTHS, blocks)):
        for block_idx in range(n_blocks):
            name = f"context_path/layer{stage_idx + 1}_{block_idx}"
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            needs_proj = block_idx == 0 and (
                stride != 1 or c.shape[1] != width * expansion)
            identity = c
            if bottleneck:  # torchvision v1.5: the stride on the 3x3
                out = F.relu(op(f"{name}/conv1", c, 1, 0, 1))
                out = F.relu(op(f"{name}/conv2", out, stride, 1, 1))
                out = op(f"{name}/conv3", out, 1, 0, 1)
            else:
                out = F.relu(op(f"{name}/conv1", c, stride, 1, 1))
                out = op(f"{name}/conv2", out, 1, 1, 1)
            if needs_proj:
                identity = op(f"{name}/downsample_conv", c, stride, 0, 1)
            c = F.relu(out + identity)
        feats.append(c)

    cx1, cx2 = feats[2], feats[3]
    tail = global_avg_pool(cx2)  # of the feature before its ARM
    cx1 = cx1 * torch.sigmoid(op("arm1/conv", global_avg_pool(cx1), 1, 0, 1))
    cx2 = cx2 * torch.sigmoid(op("arm2/conv", global_avg_pool(cx2), 1, 0, 1))
    cx2 = cx2 * tail

    sx_size = sx.shape[-2:]
    cx1 = resize_bilinear(cx1, sx_size)
    cx2 = resize_bilinear(cx2, sx_size)

    feature = None
    for i, part in enumerate((sx, cx1, cx2)):
        y = op(f"ffm/convblock:p{i}", part, 1, 1, 1)
        feature = y if feature is None else feature + y
    feature = F.relu(feature)
    gate = F.relu(op("ffm/conv1", global_avg_pool(feature), 1, 0, 1))
    gate = torch.sigmoid(op("ffm/conv2", gate, 1, 0, 1))
    out = feature * gate + feature

    out = op("conv", out, 1, 0, 1)
    return upsample_bilinear(out, 8)


def make_walk(names) -> Callable:
    """``walk(op, x)``: :func:`_forward` closed over the structure the conv
    ``names`` give."""
    blocks, bottleneck = _structure(names)
    return lambda op, x: _forward(op, x, blocks, bottleneck)


def calibrate(state: Mapping, batches, folded: dict | None = None,
              stat: str = "max", percentile: float = 99.9) -> dict:
    """Static activation scales over calibration batches (see
    ``ops/quant.py:calibrate_net``).  ``folded``: a precomputed
    :func:`fold_bisenet` tree, on the batches' device."""
    if folded is None:
        folded = fold_bisenet(state)
    return calibrate_net(make_walk(folded), folded, batches, stat=stat,
                         percentile=percentile)


def default_policy(name: str, kernel_shape) -> bool:
    """Quantize every conv EXCEPT the two 3-channel input stems, the
    pooled gate convs (ARM, FFM SE) and the final logits conv: the JAX
    package's selection.  ``kernel_shape`` is OIHW, so the input channels
    are ``kernel_shape[1]``."""
    if kernel_shape[1] <= 3:  # the 3-channel stems (spatial cb1 + 7x7)
        return False
    # ARM gates, FFM SE gates (not the split convblock parts), logits
    if name.startswith("arm") or name in ("ffm/conv1", "ffm/conv2", "conv"):
        return False
    return True


def build_quantized(state: Mapping, act_scales: dict,
                    policy: Callable = default_policy,
                    folded: dict | None = None) -> dict:
    """The quantized tree (see ``ops/quant.py:build_quantized_net``)."""
    if folded is None:
        folded = fold_bisenet(state)
    return build_quantized_net(folded, act_scales, policy)


def bisenet_int8_apply(qtree: dict, x: torch.Tensor,
                       output_f32: bool = False,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """The quantized serving forward of (N, 3, H, W) input.
    ``out_dtype=torch.float32`` dequantizes in float32 (the tests' exact
    surface)."""
    walk = make_walk(list(qtree["q8"]) + list(qtree["bf16"]))
    logits = walk(make_quant_op(qtree, out_dtype), x.to(out_dtype))
    return logits.to(torch.float32) if output_f32 else logits


def bisenet_bf16_apply(state: Mapping, x: torch.Tensor,
                       output_f32: bool = False,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """The BN-folded forward through the same walk: the baseline, and at
    ``dtype=torch.float32`` the fold's exactness surface against the
    model."""
    folded = fold_bisenet(state)
    logits = make_walk(folded)(make_bf16_op(folded, out_dtype=dtype),
                               x.to(dtype))
    return logits.to(torch.float32) if output_f32 else logits
