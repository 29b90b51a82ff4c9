"""int8 (W8A8) against bf16 on the card: the conv shapes of
DeepLabV2-R101's serving profile, and the whole quantized networks.

Counterpart of ``rtsds_tpu/bench/quant_bench.py``.  Per shape
(:func:`bench_shape`), every variant ends in a ReLU, as the serving convs
do:

  * ``bf16``: cuDNN's bf16 conv, the serving path's;
  * ``int8_static``: weights and activations already int8 (what a layer
    whose input is the previous layer's int8 output pays): the im2col and
    ``torch._int_mm`` GEMM of ``ops/quant.py:conv_int8``, then the
    dequantization;
  * ``int8_dynamic``: a bf16 activation quantized in the call (max-abs
    scale), then the same conv (what the first quantized layer after a
    float input pays);
  * and, apart, the im2col alone and the int8 GEMM alone on the static
    variant's operands, to say which of the two the int8 conv's time goes
    to.

The whole-network comparisons (:func:`bench_e2e` for DeepLabV2-R101 at
512x1024, :func:`bench_e2e_bisenet` for BiSeNet-R18 at 1024x2048) time
forward + argmax of the bf16 model against the quantized model of each
policy in ``QB_POLICIES`` (the default policy alone by default), with
random weights from a seed calibrated on the bench input.  Every call is
timed between CUDA events with the input on the card, after warmup
(``bench/latency.py``).

Run: ``python -m rtsds_tpu_torch.bench.quant_bench``; one JSON line per
shape and a summary.  Env: QB_BATCH (8), QB_ITERS (20), QB_REPEATS (1),
QB_SHAPES (csv filter); ``QB_E2E=1`` times the whole network instead
(``QB_E2E_MODEL=bisenet`` for BiSeNet, ``QB_POLICIES`` csv of policy
names).  Without a GPU it raises; the functions take ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import re

import torch
import torch.nn.functional as F

from rtsds_tpu_torch.bench.flops import model_flops
from rtsds_tpu_torch.bench.latency import (
    latency_benchmark, make_model, random_input)
from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.ops.quant import (
    QuantizedSegmentor, build_quantized_net, calibrate_net, conv_int8,
    folded_on, im2col_int8, int8_matmul, int8_model_module, quantize_act)

# (name, count, H, W, Cin, Cout, k, dilation): DeepLabV2-R101 at 512x1024,
# output stride 8 (layer3 dilation 2, layer4 dilation 4, the ASPP's 3x3
# dilated 6/12/18/24 straight to the classes); ``count`` is the shape's
# occurrences in the network, the weight of the summary
DEEPLAB_CONVS = [
    ("l1_3x3_64", 3, 128, 256, 64, 64, 3, 1),
    ("l1_1x1_256", 3, 128, 256, 64, 256, 1, 1),
    ("l2_1x1_red", 4, 64, 128, 512, 128, 1, 1),
    ("l2_3x3_128", 4, 64, 128, 128, 128, 3, 1),
    ("l2_1x1_exp", 4, 64, 128, 128, 512, 1, 1),
    ("l3_1x1_red", 23, 64, 128, 1024, 256, 1, 1),
    ("l3_3x3_d2", 23, 64, 128, 256, 256, 3, 2),
    ("l3_1x1_exp", 23, 64, 128, 256, 1024, 1, 1),
    ("l4_1x1_red", 3, 64, 128, 2048, 512, 1, 1),
    ("l4_3x3_d4", 3, 64, 128, 512, 512, 3, 4),
    ("l4_1x1_exp", 3, 64, 128, 512, 2048, 1, 1),
    ("aspp_3x3_d6", 4, 64, 128, 2048, 19, 3, 6),
]


def _speedup(bf16_ms: float, int8_ms: float):
    return bf16_ms / int8_ms if int8_ms > 0 else None


def bench_shape(name, batch, h, w, cin, cout, k, dilation, iterations=20,
                repeats=1, device=None, seed: int = 0) -> dict:
    """One conv shape ("same" padding, stride 1) in bf16, int8 static and
    int8 dynamic, plus the int8 conv's im2col and GEMM apart; times in
    ms per call."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    # channels-last, the layout the serving walk's activations have
    x_f = torch.randn((batch, h, w, cin), generator=gen,
                      device=device).permute(0, 3, 1, 2)
    w_f = torch.randn((cout, cin, k, k), generator=gen, device=device) * 0.05
    pad = dilation * (k - 1) // 2
    x_bf, w_bf = x_f.to(torch.bfloat16), w_f.to(torch.bfloat16)
    w_scale = w_f.abs().amax(dim=(1, 2, 3)) / 127.0
    w_q = torch.clamp(torch.round(w_f / w_scale.reshape(-1, 1, 1, 1)),
                      -127, 127).to(torch.int8)
    x_scale = x_f.abs().max() / 127.0
    x_q = quantize_act(x_f, x_scale)
    deq = (w_scale * x_scale).reshape(-1, 1, 1)

    def run_bf16():
        return F.relu(F.conv2d(x_bf, w_bf, None, 1, pad, dilation))

    def run_int8_static():
        acc = conv_int8(x_q, w_q, 1, pad, dilation)
        return F.relu((acc.to(torch.float32) * deq).to(torch.bfloat16))

    def run_int8_dynamic():
        s = x_bf.abs().max().to(torch.float32) / 127.0
        acc = conv_int8(quantize_act(x_bf, s), w_q, 1, pad, dilation)
        scale = (w_scale * s).reshape(-1, 1, 1)
        return F.relu((acc.to(torch.float32) * scale).to(torch.bfloat16))

    cols = im2col_int8(x_q, k, k, 1, pad, dilation)
    wmat = w_q.permute(0, 2, 3, 1).reshape(cout, -1)

    def timed(fn):
        return latency_benchmark(fn, (), iterations=iterations,
                                 repeats=repeats, device=device)["mean_ms"]

    out = {"name": name, "shape": [batch, h, w, cin, cout, k, dilation],
           "bf16_ms": timed(run_bf16),
           "int8_static_ms": timed(run_int8_static),
           "int8_dynamic_ms": timed(run_int8_dynamic),
           "im2col_ms": timed(lambda: im2col_int8(x_q, k, k, 1, pad,
                                                  dilation)),
           "int_mm_ms": timed(lambda: int8_matmul(cols, wmat)),
           "flops": 2 * batch * h * w * cin * cout * k * k}
    out["static_speedup"] = _speedup(out["bf16_ms"], out["int8_static_ms"])
    out["dynamic_speedup"] = _speedup(out["bf16_ms"], out["int8_dynamic_ms"])
    return out


# policies over (conv name, OIHW kernel shape): the JAX package's
# candidates, kernel heights read from dim 2 and input channels from dim 1
DEEPLAB_POLICIES = {
    "all_backbone": lambda n, s: not n.startswith("layer6/"),
    "conv3x3": lambda n, s: s[2] == 3 and not n.startswith("layer6/"),
    "no_l4": lambda n, s: not n.startswith(("layer6/", "layer4")),
    "conv3x3_stem": lambda n, s: s[2] >= 3 and not n.startswith("layer6/"),
    "conv3x3_exp": lambda n, s: ((s[2] == 3 or n.endswith("/conv3"))
                                 and not n.startswith("layer6/")),
    "conv3x3_stem_exp": lambda n, s: ((s[2] >= 3 or n.endswith("/conv3"))
                                      and not n.startswith("layer6/")),
}


def _ctx_stage_at_least_2(name, shape):
    m = re.match(r"context_path/layer([1-4])", name)
    return bool(m) and int(m.group(1)) >= 2


def _bisenet_best(name, shape):
    return (name.startswith("context_path/layer")
            or name == "spatial_path/convblock3"
            or name.startswith("ffm/convblock:"))


def _bisenet_policies(default):
    return {
        "ctx234": _ctx_stage_at_least_2,
        "ctx1234": lambda n, s: n.startswith("context_path/layer"),
        "default_sp2": lambda n, s: default(n, s)
        or n == "spatial_path/convblock2",
        "default_ffm": lambda n, s: default(n, s)
        or n.startswith("ffm/convblock:"),
        "all_convs": lambda n, s: not n.startswith(("arm", "ffm/conv",
                                                    "conv")),
        "best": _bisenet_best,
        "best_sp2": lambda n, s: _bisenet_best(n, s)
        or n == "spatial_path/convblock2",
    }


def _select(policies: dict, policy_names) -> dict:
    if policy_names is None:
        policy_names = os.environ.get("QB_POLICIES", "default").split(",")
    unknown = [k for k in policy_names if k not in policies]
    if unknown:
        raise ValueError(f"unknown QB policies {unknown}; "
                         f"choose from {sorted(policies)}")
    return {k: policies[k] for k in policy_names}


def _e2e(model_name, tag, batch, image_size, iterations, repeats,
         policy_names, include_folded, device, seed) -> dict:
    device = resolve_device(device)
    q = int8_model_module(model_name)
    model = make_model(model_name, device, torch.float32, seed)
    folded = folded_on(q.fold(model.state_dict()), device)
    model = model.to(torch.bfloat16)
    # channels-last, as the serving path's permuted NHWC frames are
    x = random_input((batch, *image_size, 3), device, seed).permute(0, 3, 1, 2)
    walk = q.make_walk(folded)
    scales = calibrate_net(walk, folded, [x])
    policies = {"default": q.default_policy}
    policies.update(DEEPLAB_POLICIES if model_name == "deeplab"
                    else _bisenet_policies(q.default_policy))
    policies = _select(policies, policy_names)

    def run(forward):
        @torch.inference_mode()
        def fn(x):
            return forward(x).argmax(dim=1).to(torch.int32)
        return latency_benchmark(fn, (x,), iterations=iterations,
                                 repeats=repeats, images_per_call=batch,
                                 device=device)

    bf = run(lambda x: model(x.to(torch.bfloat16)))
    out = {"e2e": tag, "image_size": list(image_size), "batch": batch,
           "bf16_ms": bf["mean_ms"], "bf16_p50_ms": bf["p50_ms"],
           "bf16_fps": bf["fps"], "samples": bf["samples"],
           # the convolutions' FLOPs, the same in both networks
           "flops_per_call": model_flops(
               model, (batch, *image_size, 3))["flops"],
           "device": bf["device"]}
    if include_folded:
        # the BN-folded walk with no conv quantized: what the fold alone
        # does, apart from what int8 does
        empty = build_quantized_net(folded, scales, lambda n, s: False)
        fl = run(QuantizedSegmentor(walk, empty))
        out["folded_bf16_ms"] = fl["mean_ms"]
        out["folded_bf16_fps"] = fl["fps"]
    for pname, policy in policies.items():
        qtree = build_quantized_net(folded, scales, policy)
        q8 = run(QuantizedSegmentor(walk, qtree))
        out[pname] = {"int8_ms": q8["mean_ms"], "int8_p50_ms": q8["p50_ms"],
                      "int8_fps": q8["fps"],
                      "speedup": _speedup(bf["mean_ms"], q8["mean_ms"]),
                      "quantized_convs": len(qtree["q8"])}
        del qtree
    return out


def bench_e2e(batch=8, image_size=(512, 1024), iterations=20, repeats=1,
              policy_names=None, include_folded=False, device=None,
              seed: int = 0) -> dict:
    """DeepLabV2-R101's serving forward + argmax: bf16 against the W8A8
    model of each policy (``models/deeplab_int8.py``), the whole network
    with its quantize ops and bf16 segments."""
    return _e2e("deeplab", "deeplabv2_r101_serving", batch, image_size,
                iterations, repeats, policy_names, include_folded, device,
                seed)


def bench_e2e_bisenet(batch=48, image_size=(1024, 2048), iterations=20,
                      repeats=1, policy_names=None, include_folded=True,
                      device=None, seed: int = 0) -> dict:
    """BiSeNet-R18's serving forward + argmax at 1024x2048 (b48, the JAX
    package's bench batch): bf16 against the BN-folded bf16 walk and the
    W8A8 model of each policy (``models/bisenet_int8.py``)."""
    return _e2e("bisenet", "bisenet_r18_serving", batch, image_size,
                iterations, repeats, policy_names, include_folded, device,
                seed)


def main():
    batch = int(os.environ.get("QB_BATCH", "8"))
    iters = int(os.environ.get("QB_ITERS", "20"))
    repeats = int(os.environ.get("QB_REPEATS", "1"))
    if os.environ.get("QB_E2E", "0") == "1":
        if os.environ.get("QB_E2E_MODEL", "deeplab") == "bisenet":
            out = bench_e2e_bisenet(batch=batch, iterations=iters,
                                    repeats=repeats)
        else:
            out = bench_e2e(batch=batch, iterations=iters, repeats=repeats)
        print(json.dumps(out), flush=True)
        return
    only = os.environ.get("QB_SHAPES")
    names = set(only.split(",")) if only else None
    bf_total = int8_total = 0.0
    for name, count, h, w, cin, cout, k, dil in DEEPLAB_CONVS:
        if names and name not in names:
            continue
        row = bench_shape(name, batch, h, w, cin, cout, k, dil,
                          iterations=iters, repeats=repeats)
        row["count"] = count
        print(json.dumps(row), flush=True)
        bf_total += count * row["bf16_ms"]
        int8_total += count * row["int8_static_ms"]
    print(json.dumps({
        "weighted_bf16_ms": bf_total,
        "weighted_int8_static_ms": int8_total,
        "weighted_speedup": _speedup(bf_total, int8_total),
        "batch": batch,
        "note": "counts weight each shape by its occurrences in "
                "DeepLabV2-R101 at 512x1024, output stride 8; static = "
                "the fully quantized network's bound"}), flush=True)


if __name__ == "__main__":
    main()
