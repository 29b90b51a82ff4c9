"""W8A8 post-training quantization: BN fold, int8 convs, calibration, and
the fake-quant ops of quantization-aware fine-tuning.

Counterpart of ``rtsds_tpu/ops/quant.py``.  The scheme:

  * frozen batch norm folded into the preceding conv (exact at serving
    time, where BN normalizes with its running statistics);
  * weights: symmetric per-output-channel int8;
  * activations: symmetric per-tensor int8 with a STATIC scale from a
    calibration pass (max-abs or a histogram percentile over a few
    batches);
  * int8 x int8 products accumulated in int32, then dequantized, the
    folded bias added in float32, and the result cast to bf16.

Layouts are the port's: activations NCHW, kernels OIHW (so the
per-output-channel reductions run over dims (1, 2, 3)).  A folded tree is
``{conv_name: (kernel, bias or None)}`` under the JAX package's conv names
(``context_path/layer1_0/conv1``, ``ffm/convblock:p0``), so scale dicts
and sidecars mean the same in both packages.

The int8 conv is a GEMM: ``torch._int_mm`` (cuBLASLt's int8 GEMM on the
card, an exact integer product on the CPU) of the channels-last activation
flattened to (N*H'*W', K) against the (K, Cout) weight.  A kh x kw conv
enters through an im2col of the padded int8 tensor: a strided view of its
kh*kw shifted taps in (kh, kw, cin) order, copied once.  The card's GEMM needs
more than 16 rows and K and Cout multiples of 8; a conv that breaks those
rules is padded with zeros, which leaves every product exact.

Divisions by a scale use a tensor on the operand's device: on the card a
division by a host scalar is a multiplication by its reciprocal, which can
differ from the division in the last bit.

The model-agnostic pipeline (:func:`calibrate_net`,
:func:`build_quantized_net`, the conv dispatchers) works on a topology
walk ``forward(op, x)``, ``op(name, x, stride, padding, dilation)``
performing one BN-folded conv; ``models/bisenet_int8.py`` and
``models/deeplab_int8.py`` each contribute a fold and a walk.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtsds_tpu_torch.device import resolve_device
from rtsds_tpu_torch.models.layers import BN_EPS

HIST_BINS = 4096
# the card's int8 GEMM takes more than 16 rows, and K and N multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-d tensor on ``like``'s device."""
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def _per_out(v: torch.Tensor) -> torch.Tensor:
    """A (Cout,) vector broadcast over an OIHW kernel."""
    return v.reshape(-1, 1, 1, 1)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    """A (C,) vector broadcast over NCHW activations."""
    return v.reshape(-1, 1, 1)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root: taken in float64 and rounded to
    ``x``'s dtype (exact for a float32 ``x``).  ATen's vectorized float32
    square root on the CPU is off by one unit in the last place for some
    inputs."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def fold_bn(kernel, bias, bn_scale, bn_bias, bn_mean, bn_var,
            eps: float = 1e-5):
    """Fold an inference-mode BatchNorm into the preceding conv.

    ``conv(x, W) + b`` then ``(y - mean) * scale / sqrt(var + eps) + bias``
    equals ``conv(x, W * g) + (b - mean) * g + bias`` with ``g = scale /
    sqrt(var + eps)`` per output channel, computed as the JAX package
    computes it (a division by the correctly rounded square root, not a
    multiply by rsqrt).  ``kernel`` is OIHW.
    """
    g = bn_scale / _sqrt(bn_var + eps)
    kernel_f = kernel * _per_out(g)
    if bias is None:
        bias = torch.zeros_like(bn_mean)
    bias_f = (bias - bn_mean) * g + bn_bias
    return kernel_f, bias_f


def fold_state(state, pairs, eps: float = BN_EPS) -> dict:
    """``{name: (kernel, bias or None)}`` of the ``(name, conv prefix, BN
    prefix or None)`` triples over a model's state dict: each conv with its
    BN folded in (:func:`fold_bn`), or as it is when it has none."""
    folded = {}
    for name, conv, bn in pairs:
        kernel, bias = state[f"{conv}.weight"], state.get(f"{conv}.bias")
        if bn is None:
            folded[name] = (kernel, bias)
        else:
            folded[name] = fold_bn(
                kernel, bias, state[f"{bn}.weight"], state[f"{bn}.bias"],
                state[f"{bn}.running_mean"], state[f"{bn}.running_var"], eps)
    return folded


def _weight_scale(kernel: torch.Tensor) -> torch.Tensor:
    """Per-output-channel max-abs / 127 of an OIHW kernel, (Cout,)."""
    amax = kernel.abs().amax(dim=(1, 2, 3))
    return amax.clamp_min(1e-12) / _scalar(127.0, amax)


def quantize_kernel(kernel: torch.Tensor):
    """Symmetric per-output-channel int8 weights of an OIHW kernel.

    Returns ``(w_q int8, w_scale float32 (Cout,))`` with ``kernel ~= w_q *
    w_scale``."""
    w_scale = _weight_scale(kernel)
    w_q = torch.clamp(torch.round(kernel / _per_out(w_scale)), -127, 127)
    return w_q.to(torch.int8), w_scale.to(torch.float32)


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric per-tensor int8 activation with a static scale: float32
    division, round half to even, clip to +-127."""
    xf = x.to(torch.float32)
    return torch.clamp(torch.round(xf / _scalar(scale, xf)),
                       -127, 127).to(torch.int8)


def _out_size(size: int, k: int, stride: int, padding: int,
              dilation: int) -> int:
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 transposed -> (M, N) int32, exactly.

    Rows, K and N are padded with zeros up to the card's GEMM rules (more
    than 16 rows, K and N multiples of 8) and the padding sliced off."""
    m, k = a.shape
    n = w.shape[0]
    pad_m, pad_k, pad_n = max(_MIN_ROWS - m, 0), (-k) % _ALIGN, (-n) % _ALIGN
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a, w.t())
    return out[:m, :n] if pad_m or pad_n else out


def im2col_int8(x_q: torch.Tensor, kh: int, kw: int, stride: int = 1,
                padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """(N, C, H, W) int8 -> (N*H'*W', kh*kw*C) int8 columns in (kh, kw, c)
    order, the rows in (n, h', w') order: a strided view of the padded
    channels-last input, (n, h', w', i, j, c) -> x[n, h'*stride +
    i*dilation, w'*stride + j*dilation, c], copied once."""
    n, c, h, w = x_q.shape
    oh = _out_size(h, kh, stride, padding, dilation)
    ow = _out_size(w, kw, stride, padding, dilation)
    x = x_q.permute(0, 2, 3, 1)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    sn, sh, sw, sc = x.stride()
    taps = x.as_strided((n, oh, ow, kh, kw, c),
                        (sn, sh * stride, sw * stride, sh * dilation,
                         sw * dilation, sc), x.storage_offset())
    return taps.reshape(n * oh * ow, kh * kw * c)


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
              padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """The int32 accumulators of an int8 conv: (N, Cin, H, W) int8 input,
    (Cout, Cin, kh, kw) int8 kernel -> (N, Cout, H', W') int32 (a
    channels-last view of the GEMM's output)."""
    n, _, h, w = x_q.shape
    cout, cin, kh, kw = w_q.shape
    oh = _out_size(h, kh, stride, padding, dilation)
    ow = _out_size(w, kw, stride, padding, dilation)
    cols = im2col_int8(x_q, kh, kw, stride, padding, dilation)
    wmat = w_q.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
    acc = int8_matmul(cols, wmat)
    return acc.reshape(n, oh, ow, cout).permute(0, 3, 1, 2)


def conv_w8a8(x_q, w_q, x_scale, w_scale, bias, stride=1, padding=0,
              dilation=1, out_dtype=torch.bfloat16):
    """int8 x int8 -> int32 conv, dequantized to ``out_dtype``:
    ``acc.float() * (w_scale * x_scale)``, the product of the two float32
    scales taken first, then ``+ bias`` (the BN-folded float32 bias, added
    after the dequantization so its precision is not quantized away), then
    the cast."""
    acc = conv_int8(x_q, w_q, stride, padding, dilation)
    x_scale = _scalar(x_scale, acc)
    y = acc.to(torch.float32) * _per_channel(w_scale * x_scale)
    if bias is not None:
        y = y + _per_channel(bias)
    return y.to(out_dtype)


def conv_bf16(x, kernel, bias, stride=1, padding=0, dilation=1,
              out_dtype=torch.bfloat16):
    """The unquantized counterpart (BN already folded), for the convs a
    policy keeps in bf16: the conv in ``out_dtype``, then the bias added in
    ``out_dtype``, as the JAX package adds it."""
    y = F.conv2d(x.to(out_dtype), kernel.to(out_dtype), None, stride,
                 padding, dilation)
    if bias is not None:
        y = y + _per_channel(bias.to(out_dtype))
    return y


# ---------------------------------------------------------------------------
# The model-agnostic PTQ pipeline.
# ---------------------------------------------------------------------------


def percentile_target(percentile: float, size: int) -> int:
    """``ceil(percentile / 100 * size)`` as the JAX package computes it:
    the double product rounded to float32, then the float32 ceil."""
    return int(np.ceil(np.float32(percentile / 100.0 * size)))


def abs_bound(x: torch.Tensor, stat: str = "max", percentile: float = 99.9,
              chunk: int = 1 << 22) -> torch.Tensor:
    """The float32 bound of ``|x|`` that calibration takes: its max, or an
    approximate ``percentile``.

    The percentile comes from a histogram of HIST_BINS uniform bins over
    [0, max|x|] (upper-edge rounding, so conservative), built in chunks of
    ``chunk`` elements so that no full-size float32 copy of |x| and no
    full-size index tensor is made.  The bin of an element is
    ``min(|x| * (bins / amax), bins - 1)`` truncated toward zero, all in
    float32; the bound is ``(k + 1) * (amax / bins)`` for the first bin k
    whose cumulative count reaches ``target``
    (:func:`percentile_target`).  The JAX package pads the last chunk with
    ``+inf``, which lands in the last bin and cannot change k; here the
    last chunk is simply shorter.
    """
    amax = x.abs().max().to(torch.float32)
    if stat == "max":
        return amax
    amax = amax.clamp_min(1e-12)
    flat = x.reshape(-1)
    ratio = _scalar(float(HIST_BINS), amax) / amax
    hist = torch.zeros((HIST_BINS,), dtype=torch.int64, device=x.device)
    for start in range(0, flat.numel(), chunk):
        absx = flat[start:start + chunk].abs().to(torch.float32)
        idx = torch.clamp(absx * ratio, max=HIST_BINS - 1).to(torch.int32)
        hist += torch.bincount(idx, minlength=HIST_BINS)
    target = torch.tensor([percentile_target(percentile, flat.numel())],
                          dtype=torch.int64, device=x.device)
    k = torch.searchsorted(hist.cumsum(0), target)[0]
    return (k + 1).to(torch.float32) * (amax / HIST_BINS)


def calibrate_net(forward: Callable, folded: dict, batches: Iterable,
                  stat: str = "max", percentile: float = 99.9,
                  _hist_chunk: int = 1 << 22) -> dict:
    """Static per-conv-input activation scales from calibration batches.

    ``forward(op, x)`` is the model's topology walk; ``batches`` an
    iterable of (N, 3, H, W) tensors AFTER the production preprocess, on
    the device of the ``folded`` tree.  Each batch runs one bf16 forward
    (as the JAX package's calibration does) in which every conv records the
    bound of its input (:func:`abs_bound`: max-abs, or the
    outlier-robust histogram ``percentile``); bounds aggregate across
    batches by max, and the scale of a conv is ``max(bound, 1e-12) /
    127``.  Convs sharing an input record identical bounds.  Returns
    ``{conv_name: float scale}``.
    """
    if stat not in ("max", "percentile"):
        raise ValueError(f"calibration stat {stat!r} is not supported "
                         "('max' or 'percentile')")
    if stat == "percentile" and not 0.0 < percentile <= 100.0:
        raise ValueError(f"calibration percentile must be in (0, 100], "
                         f"got {percentile}")
    totals: dict = {}
    n = 0
    with torch.inference_mode(), _no_autocast(folded):
        for batch in batches:
            bounds = {}

            def op(name, x, stride, padding, dilation):
                kernel, bias = folded[name]
                bounds[name] = abs_bound(x, stat, percentile, _hist_chunk)
                return conv_bf16(x, kernel, bias, stride, padding, dilation)

            forward(op, batch.to(torch.bfloat16))
            for k, v in bounds.items():
                totals[k] = max(totals.get(k, 0.0), float(v))
            n += 1
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    return {k: max(v, 1e-12) / 127.0 for k, v in totals.items()}


def _no_autocast(folded: dict):
    """Autocast off on the tree's device: the walks' dtypes are explicit."""
    kernel = next(iter(folded.values()))[0]
    return torch.autocast(device_type=kernel.device.type, enabled=False)


def build_quantized_net(folded: dict, act_scales: dict,
                        policy: Callable) -> dict:
    """The quantized tree ``{'q8': {name: (w_q, w_scale, x_scale, bias)},
    'bf16': {name: (kernel bf16, bias float32)}}``.  ``policy(name,
    kernel_shape)`` (the OIHW shape) selects the convs to quantize; a conv
    without an activation scale stays in bf16.  ``x_scale`` is a float32
    0-d tensor."""
    q8, bf = {}, {}
    for name, (kernel, bias) in folded.items():
        bias32 = None if bias is None else bias.to(torch.float32)
        if policy(name, tuple(kernel.shape)) and name in act_scales:
            w_q, w_scale = quantize_kernel(kernel)
            q8[name] = (w_q, w_scale, _scalar(act_scales[name], kernel),
                        bias32)
        else:
            bf[name] = (kernel.to(torch.bfloat16), bias32)
    return {"q8": q8, "bf16": bf}


def make_quant_op(qtree: dict, out_dtype=torch.bfloat16) -> Callable:
    """The serving-time conv dispatcher over a :func:`build_quantized_net`
    tree: a quantized conv quantizes its input and runs :func:`conv_w8a8`,
    the others :func:`conv_bf16`.  ``out_dtype=torch.float32`` runs the
    dequantization and the bf16-policy convs in float32 (the tests' exact
    comparison surface)."""
    q8, bf = qtree["q8"], qtree["bf16"]

    def op(name, x, stride, padding, dilation):
        if name in q8:
            w_q, w_scale, x_scale, bias = q8[name]
            x_q = quantize_act(x, x_scale)
            return conv_w8a8(x_q, w_q, x_scale, w_scale, bias, stride,
                             padding, dilation, out_dtype=out_dtype)
        kernel, bias = bf[name]
        return conv_bf16(x, kernel, bias, stride, padding, dilation,
                         out_dtype=out_dtype)

    return op


def int8_model_module(model_name: str):
    """The int8 module of ``model_name``: ``models/bisenet_int8.py`` or
    ``models/deeplab_int8.py`` (each has ``fold``, ``make_walk``,
    ``default_policy``)."""
    if model_name == "deeplab":
        from rtsds_tpu_torch.models import deeplab_int8 as q
    elif model_name == "bisenet":
        from rtsds_tpu_torch.models import bisenet_int8 as q
    else:
        raise ValueError(f"no int8 path for model {model_name!r} "
                         "(expected 'bisenet' or 'deeplab')")
    return q


def folded_on(folded: dict, device) -> dict:
    """A folded tree's tensors moved to ``device``."""
    return {name: (kernel.to(device), None if bias is None else bias.to(device))
            for name, (kernel, bias) in folded.items()}


class QuantizedSegmentor(nn.Module):
    """The int8 serving forward of a :func:`build_quantized_net` tree as an
    eval-mode model: ``(N, 3, H, W)`` input -> ``(N, classes, H, W)`` bf16
    logits, for the callers that take a model (``Predictor``, the sliding
    and ensemble protocols, validation, the distillation teacher, CBST
    calibration).

    The tree's tensors are buffers, so ``.to(device)`` moves them (move it
    by device only: a dtype cast would round the float32 scales and
    biases).  The walk runs outside autocast, its dtypes explicit and bf16
    by construction, whatever dtype the input comes in;
    ``compute_dtype`` declares it for the callers that cast their input to
    the model's dtype.  ``walk(op, x)`` is the model's topology walk (its
    int8 module's ``make_walk``).  ``act_scales`` keeps the scales of every
    conv (the tree holds those of the quantized ones only).  The module has
    no parameters."""

    compute_dtype = torch.bfloat16

    def __init__(self, walk: Callable, qtree: dict,
                 act_scales: dict | None = None):
        super().__init__()
        self.act_scales = act_scales
        self._walk = walk
        self._keys: dict = {}
        for kind in ("q8", "bf16"):
            for name, entry in qtree[kind].items():
                keys = []
                for i, t in enumerate(entry):
                    key = None
                    if t is not None:
                        key = f"{kind}_{len(self._keys)}_{i}"
                        self.register_buffer(key, t)
                    keys.append(key)
                self._keys[(kind, name)] = keys
        self.eval()

    @property
    def qtree(self) -> dict:
        tree: dict = {"q8": {}, "bf16": {}}
        for (kind, name), keys in self._keys.items():
            tree[kind][name] = tuple(None if k is None else getattr(self, k)
                                     for k in keys)
        return tree

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(device_type=x.device.type, enabled=False):
            return self._walk(make_quant_op(self.qtree), x.to(torch.bfloat16))


def check_topology(model_name: str, act_scales: dict, folded: dict) -> None:
    """Raise unless ``act_scales`` names exactly the convs of ``folded``:
    every legitimate producer (calibration, the QAT sidecar) records a
    scale for every conv, and a conv without one would be served in bf16
    quietly, so a trimmed, stale or hand-built dict must fail loudly."""
    unknown = sorted(set(act_scales) - set(folded))
    missing = sorted(set(folded) - set(act_scales))
    if unknown or missing:
        raise ValueError(
            f"act_scales do not match the {model_name} conv topology ("
            + "; ".join(filter(None, [
                f"unknown names: {unknown[:5]}" if unknown else "",
                f"missing convs: {missing[:5]}" if missing else ""]))
            + ")")


def quantize_model(model_name: str, state, calib_batches: Iterable | None,
                   policy: Callable | None = None, calib_stat: str = "max",
                   calib_percentile: float = 99.9, device=None,
                   act_scales: dict | None = None) -> QuantizedSegmentor:
    """One-call W8A8 PTQ of a whole model: fold ``state`` (the model's
    float32 state dict), calibrate on ``calib_batches`` ((N, 3, H, W)
    tensors after the production preprocess, on ``device``) unless
    ``act_scales`` gives the scales (checked by :func:`check_topology`),
    quantize under ``policy`` (the model's ``default_policy`` by default)
    and wrap the walk in a :class:`QuantizedSegmentor` on ``device`` (the
    GPU unless the caller names the CPU), with the scales as its
    ``act_scales``: a drop-in eval-mode model for the inference consumers
    (serving, the distillation teacher, the pseudo-label sweep)."""
    q = int8_model_module(model_name)
    folded = folded_on(q.fold(state), resolve_device(device))
    if act_scales is not None:
        check_topology(model_name, act_scales, folded)
        scales = dict(act_scales)
    else:
        scales = calibrate_net(q.make_walk(folded), folded, calib_batches,
                               stat=calib_stat, percentile=calib_percentile)
    qtree = build_quantized_net(folded, scales, policy or q.default_policy)
    return QuantizedSegmentor(q.make_walk(folded), qtree, scales)


# ---------------------------------------------------------------------------
# QAT primitives: the serving path's W8A8 grid made differentiable with
# straight-through estimators (``train/qat.py`` drives them).
# ---------------------------------------------------------------------------


def fake_quant_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """Differentiable W8 view of an OIHW kernel: the values of
    ``dequantize(quantize_kernel(kernel))`` (the same per-channel max-abs
    grid; nothing saturates, so no clip), the gradient passed straight
    through."""
    scale = _per_out(_weight_scale(kernel))
    dq = torch.round(kernel / scale) * scale
    return kernel + (dq - kernel).detach()


def fake_quant_act(x: torch.Tensor, scale) -> torch.Tensor:
    """Differentiable A8 view of an activation with a static scale, in
    float32 (as the JAX package casts it): the serving grid's values
    (round, saturate at +-127, dequantize); the clipped straight-through
    gradient, identity inside the representable range and zero where the
    value saturates."""
    xf = x.to(torch.float32)
    s = _scalar(scale, xf)
    bound = s * 127.0
    dq = torch.clamp(torch.round(xf / s), -127, 127) * s
    ste = xf + (dq - xf).detach()
    return torch.where(xf.abs() <= bound, ste, dq.detach())


def make_fake_quant_op(folded: dict, act_scales: dict,
                       quant_names) -> Callable:
    """The QAT conv dispatcher, differentiable with respect to the
    ``folded`` tree: the ``quant_names`` convs see the W8A8 grid through
    the STEs, the others run straight through; float32 compute."""

    def op(name, x, stride, padding, dilation):
        kernel, bias = folded[name]
        kernel = kernel.to(torch.float32)
        if name in quant_names:
            x = fake_quant_act(x, act_scales[name])
            kernel = fake_quant_kernel(kernel)
        return conv_bf16(x, kernel, bias, stride, padding, dilation,
                         out_dtype=torch.float32)

    return op


def make_bf16_op(folded: dict, out_dtype=torch.bfloat16) -> Callable:
    """The BN-folded unquantized dispatcher: the baseline, and at
    ``out_dtype=torch.float32`` the fold's exactness test surface."""

    def op(name, x, stride, padding, dilation):
        kernel, bias = folded[name]
        return conv_bf16(x, kernel, bias, stride, padding, dilation,
                         out_dtype=out_dtype)

    return op
