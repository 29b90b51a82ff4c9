"""The port's W8A8 int8 path (``rtsds_tpu_torch/ops/quant.py``,
``models/bisenet_int8.py``, ``models/deeplab_int8.py``) against the JAX
package's, on the same weights (through the weight bridge) and inputs.

Tolerances:
  * the BN fold, the weight and activation grids, the int32 accumulators
    of ``conv_w8a8`` and its dequantized output (float32 and bf16): exact;
  * the calibration statistic on one conv fed bf16-representable inputs:
    exact (``==``), for both statistics and any histogram chunk;
  * whole-model activation scales: each within 2^-6 relative of JAX's
    (the calibration forward runs in bf16 on both sides, so a bound can
    move by a few bf16 steps); the max statistic's input scale exactly;
  * the folded walks in float32: rtol 1e-4 / atol 1e-5 against JAX's;
  * the int8 walks, both fed JAX's scales and run in float32
    (``out_dtype=float32``): every quantized conv's weights equal, each
    conv exact on the same int8 input, and along the whole walk fewer
    than 1e-3 of the activation codes flipped (a value within rounding
    of a half step lands on either code), the logits within 2e-2 of
    their peak and the argmax masks 99% equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.models import bisenet_int8 as jax_bisenet_int8
from rtsds_tpu.models import deeplab_int8 as jax_deeplab_int8
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
from rtsds_tpu.ops import quant as jq
from rtsds_tpu_torch.models import bisenet_int8, deeplab_int8
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.pretrained import (
    load_flax_variables, state_dict_from_flax)
from rtsds_tpu_torch.ops import quant as tq
from test_torch_cuda import CONV_SHAPES

HW = (64, 128)
THIN = (1, 1, 1, 1)
SCALE_RTOL = 2.0 ** -6
FLIP_LIMIT = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _moved_stats(variables, seed):
    """BN statistics moved off the identity: means ~N(0, 0.1), variances
    in [0.5, 1.5], so the fold is a real test."""
    rng = np.random.default_rng(seed)

    def stat(path, a):
        if path[-1].key == "mean":
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        stat, variables["batch_stats"])
    return variables


def flax_bisenet(seed=0, context_path="resnet18", hw=HW):
    """A Flax BiSeNet tree (numpy leaves, supervision heads included)."""
    model = FlaxBiSeNet(num_classes=19, context_path=context_path)
    v = jax.jit(lambda k, x: model.init(k, x, train=True))(
        jax.random.key(seed), jnp.zeros((1, *hw, 3), jnp.float32))
    return _moved_stats(jax.tree_util.tree_map(np.asarray, v), seed + 1)


def flax_deeplab(seed=0, layers=THIN, hw=HW):
    """A Flax DeepLabV2 tree (numpy leaves)."""
    model = FlaxDeepLab(num_classes=19, layers=layers)
    v = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(seed), jnp.zeros((1, *hw, 3), jnp.float32))
    return _moved_stats(jax.tree_util.tree_map(np.asarray, v), seed + 1)


def images(seed=0, n=2, hw=HW):
    """Normalized-image-like NHWC float32 inputs."""
    return np.random.default_rng(seed).normal(size=(n, *hw, 3)).astype(
        np.float32)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def hwio(t: torch.Tensor) -> np.ndarray:
    """An OIHW torch kernel as the JAX package's HWIO numpy array."""
    return t.detach().numpy().transpose(2, 3, 1, 0)


def jax_f32_op(qtree, record=None):
    """JAX's int8 conv dispatcher with the dequantization and the
    bf16-policy convs in float32, made from the JAX package's public
    primitives; ``record`` collects each quantized conv's int8 input and
    its (stride, padding, dilation)."""
    q8, bf = qtree["q8"], qtree["bf16"]

    def op(name, x, stride, padding, dilation):
        if name in q8:
            w_q, w_scale, x_scale, bias = q8[name]
            x_q = jq.quantize_act(x, x_scale)
            if record is not None:
                record[name] = (np.asarray(x_q), stride, padding, dilation)
            return jq.conv_w8a8(x_q, w_q, x_scale, w_scale, bias, stride,
                                padding, dilation, out_dtype=jnp.float32)
        kernel, bias = bf[name]
        return jq.conv_bf16(x, kernel, bias, stride, padding, dilation,
                            out_dtype=jnp.float32)

    return op


def port_f32_op(qtree, record):
    """The port's :func:`make_quant_op` at float32 that also records each
    quantized conv's int8 input."""
    inner = tq.make_quant_op(qtree, torch.float32)

    def op(name, x, stride, padding, dilation):
        if name in qtree["q8"]:
            record[name] = tq.quantize_act(x, qtree["q8"][name][2]).numpy()
        return inner(name, x, stride, padding, dilation)

    return op


MODELS = {
    "bisenet": (flax_bisenet, jax_bisenet_int8, bisenet_int8,
                "fold_bisenet"),
    "deeplab": (flax_deeplab, jax_deeplab_int8, deeplab_int8,
                "fold_deeplab"),
}


def _jax_walk(name, folded_or_names):
    if name == "deeplab":
        counts = jax_deeplab_int8._block_counts(folded_or_names)
        return lambda op, x: jax_deeplab_int8._forward(op, x, counts)
    blocks, bottleneck = jax_bisenet_int8._structure(folded_or_names)
    return lambda op, x: jax_bisenet_int8._forward(op, x, blocks,
                                                   bottleneck)


@pytest.fixture(scope="module", params=["bisenet", "deeplab"])
def setup(request):
    """Both packages' fold, JAX's scales, both quantized trees and both
    float32 int8 walks, computed once per model."""
    name = request.param
    make, jmod, tmod, fold_name = MODELS[name]
    variables = make()
    state = state_dict_from_flax(variables)
    x = images()
    jfold = getattr(jmod, fold_name)(variables)
    tfold = getattr(tmod, fold_name)(state)
    jscales = {stat: jmod.calibrate(variables, [jnp.asarray(x)],
                                    folded=jfold, stat=stat)
               for stat in ("max", "percentile")}
    scales = jscales["max"]
    jtree = jmod.build_quantized(variables, scales, folded=jfold)
    ttree = tmod.build_quantized(state, scales, folded=tfold)
    jrec, trec = {}, {}
    jlogits = np.asarray(_jax_walk(name, jfold)(
        jax_f32_op(jtree, jrec), jnp.asarray(x)))
    with torch.no_grad():
        tlogits = tmod.make_walk(tfold)(port_f32_op(ttree, trec),
                                        nchw(x)).numpy().transpose(0, 2, 3, 1)
    return dict(name=name, variables=variables, state=state, x=x,
                jfold=jfold, tfold=tfold, jscales=jscales, jtree=jtree,
                ttree=ttree, jrec=jrec, trec=trec, jlogits=jlogits,
                tlogits=tlogits, jmod=jmod, tmod=tmod)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def test_fold_bn_matches_jax_exactly(rng):
    kernel = (0.1 * rng.normal(size=(3, 3, 8, 16))).astype(np.float32)
    stats = [rng.uniform(0.5, 2.0, 16), rng.normal(size=16),
             0.3 * rng.normal(size=16), rng.uniform(0.5, 1.5, 16)]
    stats = [s.astype(np.float32) for s in stats]
    bias = rng.normal(size=16).astype(np.float32)
    for b in (None, bias):
        jk, jb = jq.fold_bn(jnp.asarray(kernel),
                            None if b is None else jnp.asarray(b),
                            *map(jnp.asarray, stats))
        tk, tb = tq.fold_bn(torch.from_numpy(kernel.transpose(3, 2, 0, 1)),
                            None if b is None else torch.from_numpy(b),
                            *map(torch.from_numpy, stats))
        np.testing.assert_array_equal(hwio(tk), np.asarray(jk))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_fold_bn_folds_an_eval_batch_norm(rng):
    """conv + eval BN == the folded conv, within float32 rounding."""
    conv = torch.nn.Conv2d(8, 16, 3, padding=1, bias=True)
    bn = torch.nn.BatchNorm2d(16).eval()
    with torch.no_grad():
        bn.running_mean.normal_(0, 0.3)
        bn.running_var.uniform_(0.5, 1.5)
        bn.weight.uniform_(0.5, 2.0)
        bn.bias.normal_()
    x = torch.from_numpy(rng.normal(size=(2, 8, 10, 12)).astype(np.float32))
    k, b = tq.fold_bn(conv.weight, conv.bias, bn.weight, bn.bias,
                      bn.running_mean, bn.running_var)
    with torch.no_grad():
        want = bn(conv(x))
        got = torch.nn.functional.conv2d(x, k, b, padding=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_quantize_grids_match_jax_exactly(rng):
    kernel = (rng.normal(size=(3, 3, 64, 32))
              * rng.uniform(0.01, 3.0, 32)).astype(np.float32)
    kernel[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    jw, js = jq.quantize_kernel(jnp.asarray(kernel))
    tw, ts = tq.quantize_kernel(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(hwio(tw), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    x = (3 * rng.normal(size=(2, 9, 11, 8))).astype(np.float32)
    # exact half steps round to even on both sides
    x[0, 0, 0, :4] = np.float32(0.0078125) * np.array([0.5, 1.5, 2.5, -0.5])
    for scale in (0.0123456, 1 / 127, 0.0078125, 0.5):
        want = np.asarray(jq.quantize_act(jnp.asarray(x), jnp.float32(scale)))
        got = tq.quantize_act(torch.from_numpy(x), scale)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    torch.testing.assert_close(
        tq.quantize_act(torch.tensor([0.5, 1.5, 2.5, -2.5, 300.0]), 1.0),
        torch.tensor([0, 2, 2, -2, 127], dtype=torch.int8), rtol=0, atol=0)




@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_w8a8_matches_jax_exactly(shape, rng):
    n, cin, h, w, cout, k, stride, padding, dilation = shape
    x_q = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    w_q = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    w_scale = rng.uniform(1e-3, 1e-2, cout).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    x_scale = np.float32(0.0213)
    tx = nchw(x_q)
    tw = torch.from_numpy(np.ascontiguousarray(w_q.transpose(3, 2, 0, 1)))
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(x_q), jnp.asarray(w_q), (stride, stride),
        ((padding, padding), (padding, padding)),
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = tq.conv_int8(tx, tw, stride, padding, dilation)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(acc))
    # the float64 conv is exact too (|acc| < 2^53)
    f64 = torch.nn.functional.conv2d(tx.double(), tw.double(), None, stride,
                                     padding, dilation)
    assert torch.equal(f64, got.double())
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        want = jq.conv_w8a8(jnp.asarray(x_q), jnp.asarray(w_q), x_scale,
                            jnp.asarray(w_scale), jnp.asarray(bias), stride,
                            padding, dilation, out_dtype=jdtype)
        y = tq.conv_w8a8(tx, tw, float(x_scale), torch.from_numpy(w_scale),
                         torch.from_numpy(bias), stride, padding, dilation,
                         out_dtype=dtype)
        assert y.dtype == dtype
        np.testing.assert_array_equal(
            y.float().numpy().transpose(0, 2, 3, 1),
            np.asarray(want.astype(jnp.float32)))


def test_int8_matmul_pads_to_the_gemm_rules(rng):
    """Rows below 17 and K or N off a multiple of 8 are padded with zeros
    and sliced off; the product stays exact."""
    for m, k, n in ((5, 27, 19), (17, 8, 8), (1, 147, 64), (40, 13, 3)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
        got = tq.int8_matmul(a, w)
        assert got.shape == (m, n) and got.dtype == torch.int32
        assert torch.equal(got.long(), a.long() @ w.long().t())


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _one_conv(seed):
    rng = np.random.default_rng(seed)
    kernel = (0.1 * rng.normal(size=(3, 3, 4, 8))).astype(np.float32)
    return ({"c": (jnp.asarray(kernel), None)},
            {"c": (torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                   None)})


def _walk(op, x):
    return op("c", x, 1, 1, 1)


@pytest.mark.parametrize("stat,percentile", [("max", 99.9),
                                             ("percentile", 99.9),
                                             ("percentile", 99.0),
                                             ("percentile", 60.0),
                                             ("percentile", 100.0)])
def test_calibration_statistic_is_exact_on_one_conv(stat, percentile, rng):
    """bf16-representable inputs, so both sides see the same |x|; the hot
    pixel makes the percentile differ from the max."""
    jfold, tfold = _one_conv(1)
    x = np.tanh(rng.normal(size=(2, 48, 40, 4))).astype(np.float32)
    x[0, 0, 0, 0] = 1000.0
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = jq.calibrate_net(_walk, jfold, [jnp.asarray(x)], stat=stat,
                            percentile=percentile)
    for chunk in (1 << 22, 1000, 4096):
        got = tq.calibrate_net(_walk, tfold, [nchw(x)], stat=stat,
                               percentile=percentile, _hist_chunk=chunk)
        assert got == want, (chunk, got, want)


def test_calibration_aggregates_batches_by_max_as_jax(rng):
    jfold, tfold = _one_conv(2)
    xs = [np.asarray(jnp.asarray(s * rng.normal(size=(1, 16, 24, 4)),
                                 jnp.bfloat16).astype(jnp.float32))
          for s in (1.0, 3.0, 0.5)]
    for stat in ("max", "percentile"):
        want = jq.calibrate_net(_walk, jfold, [jnp.asarray(x) for x in xs],
                                stat=stat)
        got = tq.calibrate_net(_walk, tfold, [nchw(x) for x in xs],
                               stat=stat)
        assert got == want


def test_percentile_target_rounds_as_jax_does():
    """The double product goes through float32 before the ceil: at large
    sizes the two roundings differ."""
    for pct, size in ((99.9, 4096), (99.9, 2 ** 27 + 3), (60.0, 123_456_789),
                      (99.99, 8 * 64 * 512 * 1024)):
        want = int(np.asarray(jnp.ceil(pct / 100.0 * size)
                              .astype(jnp.uint32)))
        assert tq.percentile_target(pct, size) == want


def test_calibration_refuses_what_jax_refuses():
    _, tfold = _one_conv(0)
    x = torch.zeros((1, 4, 8, 8))
    with pytest.raises(ValueError, match="stat"):
        tq.calibrate_net(_walk, tfold, [x], stat="p99")
    with pytest.raises(ValueError, match="percentile"):
        tq.calibrate_net(_walk, tfold, [x], stat="percentile",
                         percentile=0.0)
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate_net(_walk, tfold, [])


def test_whole_model_scales_match_jax(setup):
    s = setup
    for stat, want in s["jscales"].items():
        got = s["tmod"].calibrate(s["state"], [nchw(s["x"])],
                                  folded=s["tfold"], stat=stat)
        assert set(got) == set(want) == set(s["tfold"])
        for name in want:
            assert got[name] == pytest.approx(want[name], rel=SCALE_RTOL), \
                (stat, name)
        # the input convs see the bf16 image itself
        first = "conv1" if s["name"] == "deeplab" else "context_path/conv1"
        if stat == "max":
            assert got[first] == want[first]


# ---------------------------------------------------------------------------
# the fold and the walks
# ---------------------------------------------------------------------------


def test_fold_matches_jax_exactly(setup):
    s = setup
    assert set(s["tfold"]) == set(s["jfold"])
    for name, (jk, jb) in s["jfold"].items():
        tk, tb = s["tfold"][name]
        np.testing.assert_array_equal(hwio(tk), np.asarray(jk), err_msg=name)
        assert (tb is None) == (jb is None), name
        if jb is not None:
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb),
                                          err_msg=name)


def test_folded_walk_matches_jax_and_the_model(setup):
    s = setup
    jax_apply = (jax_bisenet_int8.bisenet_bf16_apply if s["name"] == "bisenet"
                 else jax_deeplab_int8.deeplab_bf16_apply)
    port_apply = (bisenet_int8.bisenet_bf16_apply if s["name"] == "bisenet"
                  else deeplab_int8.deeplab_bf16_apply)
    want = np.asarray(jax_apply(s["variables"], jnp.asarray(s["x"]),
                                dtype=jnp.float32, output_f32=True))
    with torch.no_grad():
        got = port_apply(s["state"], nchw(s["x"]), dtype=torch.float32,
                         output_f32=True)
        model = (BiSeNet() if s["name"] == "bisenet"
                 else DeepLabV2(layers=THIN))
        ref = load_flax_variables(model, s["variables"]).eval()(nchw(s["x"]))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_policy_selects_what_jax_selects(setup):
    s = setup
    assert set(s["ttree"]["q8"]) == set(s["jtree"]["q8"])
    assert set(s["ttree"]["bf16"]) == set(s["jtree"]["bf16"])
    for name, (jw, js, jx, jb) in s["jtree"]["q8"].items():
        tw, ts, tx, tb = s["ttree"]["q8"][name]
        np.testing.assert_array_equal(hwio(tw), np.asarray(jw), err_msg=name)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert float(tx) == float(jx)
    if s["name"] == "deeplab":  # the 3x3s and expansions, no ASPP, no stem
        assert all(n.endswith(("/conv2", "/conv3")) for n in s["ttree"]["q8"])
    else:
        assert {"spatial_path/convblock1", "context_path/conv1", "arm1/conv",
                "ffm/conv1", "conv"} <= set(s["ttree"]["bf16"])


def test_each_int8_conv_is_exact_on_jax_inputs(setup):
    """Every quantized conv, fed JAX's own int8 input, gives JAX's
    float32 output bit for bit."""
    s = setup
    for name, (x_q, stride, padding, dilation) in s["jrec"].items():
        jw, js, jx, jb = s["jtree"]["q8"][name]
        tw, ts, tx, tb = s["ttree"]["q8"][name]
        want = jq.conv_w8a8(jnp.asarray(x_q), jw, jx, js, jb, stride,
                            padding, dilation, out_dtype=jnp.float32)
        got = tq.conv_w8a8(nchw(x_q), tw, tx, ts, tb, stride, padding,
                           dilation, out_dtype=torch.float32)
        np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                      np.asarray(want), err_msg=name)


def test_int8_walk_matches_jax_on_the_same_scales(setup):
    s = setup
    assert set(s["trec"]) == set(s["jrec"]) == set(s["jtree"]["q8"])
    flipped = total = 0
    for name, (j, *_) in s["jrec"].items():
        t = s["trec"][name].transpose(0, 2, 3, 1)
        assert t.shape == j.shape
        flipped += int((t != j).sum())
        total += j.size
        assert int(np.abs(t.astype(np.int32) - j).max()) <= 1, name
    print(f"{s['name']}: {flipped} of {total} int8 codes flipped")
    assert flipped <= FLIP_LIMIT * total
    peak = np.abs(s["jlogits"]).max()
    np.testing.assert_allclose(s["tlogits"], s["jlogits"], rtol=0,
                               atol=2e-2 * peak)
    agree = (s["tlogits"].argmax(-1) == s["jlogits"].argmax(-1)).mean()
    assert agree >= 0.99


def test_bf16_int8_apply_matches_jax_masks(setup):
    """The serving forward (bf16) of both packages on the same scales."""
    s = setup
    jax_apply = (jax_bisenet_int8.bisenet_int8_apply if s["name"] == "bisenet"
                 else jax_deeplab_int8.deeplab_int8_apply)
    port_apply = (bisenet_int8.bisenet_int8_apply if s["name"] == "bisenet"
                  else deeplab_int8.deeplab_int8_apply)
    want = np.asarray(jax_apply(s["jtree"], jnp.asarray(s["x"]),
                                output_f32=True))
    with torch.no_grad():
        got = port_apply(s["ttree"], nchw(s["x"]))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 19, *HW)
    got = got.float().numpy().transpose(0, 2, 3, 1)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.98


def test_quantized_segmentor_is_the_int8_walk(setup):
    s = setup
    module = tq.QuantizedSegmentor(s["tmod"].make_walk(s["tfold"]),
                                   s["ttree"])
    assert not list(module.parameters())
    assert module.compute_dtype == torch.bfloat16
    apply = (bisenet_int8.bisenet_int8_apply if s["name"] == "bisenet"
             else deeplab_int8.deeplab_int8_apply)
    x = nchw(s["x"])
    with torch.no_grad():
        want = apply(s["ttree"], x)
        got = module(x)
        # autocast around it changes nothing: the walk's dtypes are its own
        with torch.autocast("cpu", dtype=torch.bfloat16):
            under = module(x.double())
    assert torch.equal(got, want) and torch.equal(under, want)
    for kind in ("q8", "bf16"):
        for name, entry in s["ttree"][kind].items():
            for a, b in zip(module.qtree[kind][name], entry):
                assert (a is None and b is None) or torch.equal(a, b)


def test_quantize_model_calibrates_folds_and_quantizes(setup):
    s = setup
    module = tq.quantize_model(s["name"], s["state"], [nchw(s["x"])],
                               device="cpu")
    scales = s["tmod"].calibrate(s["state"], [nchw(s["x"])])
    ref = s["tmod"].build_quantized(s["state"], scales)
    assert set(module.qtree["q8"]) == set(ref["q8"])
    for name, entry in ref["q8"].items():
        assert torch.equal(module.qtree["q8"][name][0], entry[0])
        assert float(module.qtree["q8"][name][2]) == float(entry[2])
    with pytest.raises(ValueError, match="no int8 path"):
        tq.quantize_model("fcn", s["state"], [], device="cpu")


def test_resnet101_bisenet_fold_and_walk_match_jax():
    """BiSeNet-R101's bottleneck blocks fold and walk as in JAX."""
    hw = (32, 64)
    variables = flax_bisenet(3, "resnet101", hw)
    state = state_dict_from_flax(variables)
    jfold = jax_bisenet_int8.fold_bisenet(variables)
    tfold = bisenet_int8.fold_bisenet(state)
    assert set(tfold) == set(jfold)
    assert bisenet_int8._structure(tfold) == ([3, 4, 23, 3], True)
    for name in ("context_path/layer3_5/conv3", "ffm/convblock:p2",
                 "context_path/layer4_0/downsample_conv"):
        np.testing.assert_array_equal(hwio(tfold[name][0]),
                                      np.asarray(jfold[name][0]))
    x = images(4, 1, hw)
    want = np.asarray(jax_bisenet_int8.bisenet_bf16_apply(
        variables, jnp.asarray(x), dtype=jnp.float32, output_f32=True))
    with torch.no_grad():
        got = bisenet_int8.bisenet_bf16_apply(state, nchw(x),
                                              dtype=torch.float32)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-4, atol=1e-5)
