"""The port's int8 bench (``rtsds_tpu_torch/bench/quant_bench.py``) on the
CPU (``device="cpu"``; times there are the CPU's, never a card's), and its
policies against the JAX package's: each policy selects, on the OIHW
kernel shapes of the port's fold, the convs that the JAX package's policy
of the same name selects on the HWIO shapes of its fold (the JAX lambdas
are local to its bench functions, so their conditions are restated here
as JAX writes them)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.models import bisenet_int8 as jax_bisenet_int8
from rtsds_tpu.models import deeplab_int8 as jax_deeplab_int8
from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
from rtsds_tpu_torch.bench import quant_bench
from rtsds_tpu_torch.models import bisenet_int8, deeplab_int8
from rtsds_tpu_torch.models.pretrained import state_dict_from_flax
from test_torch_quant import flax_bisenet

# the JAX package's policies (rtsds_tpu/bench/quant_bench.py), on HWIO
JAX_DEEPLAB = {
    "all_backbone": lambda n, s: not n.startswith("layer6/"),
    "conv3x3": lambda n, s: s[0] == 3 and not n.startswith("layer6/"),
    "no_l4": lambda n, s: not (n.startswith("layer6/")
                               or n.startswith("layer4")),
    "conv3x3_stem": lambda n, s: s[0] >= 3 and not n.startswith("layer6/"),
    "conv3x3_exp": lambda n, s: ((s[0] == 3 or n.endswith("/conv3"))
                                 and not n.startswith("layer6/")),
    "conv3x3_stem_exp": lambda n, s: ((s[0] >= 3 or n.endswith("/conv3"))
                                      and not n.startswith("layer6/")),
    "default": jax_deeplab_int8.default_policy,
}


def _jax_best(n, s):
    return (n.startswith("context_path/layer")
            or n == "spatial_path/convblock3"
            or n.startswith("ffm/convblock:"))


def _ctx234(n, s):
    m = re.match(r"context_path/layer([1-4])", n)
    return bool(m) and int(m.group(1)) >= 2


JAX_BISENET = {
    "ctx234": _ctx234,
    "ctx1234": lambda n, s: n.startswith("context_path/layer"),
    "default_sp2": lambda n, s: jax_bisenet_int8.default_policy(n, s)
    or n == "spatial_path/convblock2",
    "default_ffm": lambda n, s: jax_bisenet_int8.default_policy(n, s)
    or n.startswith("ffm/convblock:"),
    "all_convs": lambda n, s: not n.startswith(("arm", "ffm/conv", "conv")),
    "best": _jax_best,
    "best_sp2": lambda n, s: _jax_best(n, s)
    or n == "spatial_path/convblock2",
    "default": jax_bisenet_int8.default_policy,
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def folds():
    bis = flax_bisenet(9)
    dl = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, x: FlaxDeepLab(num_classes=19).init(k, x, train=False))(
        jax.random.key(9), jnp.zeros((1, 33, 65, 3))))
    return {
        "bisenet": (jax_bisenet_int8.fold_bisenet(bis),
                    bisenet_int8.fold_bisenet(state_dict_from_flax(bis))),
        "deeplab": (jax_deeplab_int8.fold_deeplab(dl),
                    deeplab_int8.fold_deeplab(state_dict_from_flax(dl)))}


@pytest.mark.parametrize("model", ["bisenet", "deeplab"])
def test_policies_select_what_jax_selects(folds, model):
    jfold, tfold = folds[model]
    ours = ({"default": bisenet_int8.default_policy,
             **quant_bench._bisenet_policies(bisenet_int8.default_policy)}
            if model == "bisenet" else
            {"default": deeplab_int8.default_policy,
             **quant_bench.DEEPLAB_POLICIES})
    theirs = JAX_BISENET if model == "bisenet" else JAX_DEEPLAB
    assert set(ours) == set(theirs)
    for name, policy in ours.items():
        want = {n for n, (k, _) in jfold.items() if theirs[name](n, k.shape)}
        got = {n for n, (k, _) in tfold.items()
               if policy(n, tuple(k.shape))}
        assert got == want, name


def test_bench_shape_on_the_cpu():
    row = quant_bench.bench_shape("l3_3x3_d2", 1, 9, 11, 16, 24, 3, 2,
                                  iterations=1, device="cpu")
    for key in ("bf16_ms", "int8_static_ms", "int8_dynamic_ms", "im2col_ms",
                "int_mm_ms", "static_speedup", "dynamic_speedup"):
        assert row[key] > 0, key
    assert row["flops"] == 2 * 9 * 11 * 16 * 24 * 9
    assert row["shape"] == [1, 9, 11, 16, 24, 3, 2]


def test_e2e_benches_on_the_cpu():
    dl = quant_bench.bench_e2e(batch=1, image_size=(33, 65), iterations=1,
                               device="cpu")
    assert dl["e2e"] == "deeplabv2_r101_serving" and dl["bf16_ms"] > 0
    assert dl["default"]["quantized_convs"] == 66
    assert dl["default"]["speedup"] == pytest.approx(
        dl["bf16_ms"] / dl["default"]["int8_ms"])
    bis = quant_bench.bench_e2e_bisenet(
        batch=2, image_size=(64, 128), iterations=1,
        policy_names=["default", "all_convs"], device="cpu")
    assert bis["folded_bf16_ms"] > 0 and bis["flops_per_call"] > 0
    assert bis["default"]["quantized_convs"] == 24
    # all_convs: the backbone with both 3-channel stems (padded to the
    # GEMM's K), without the FFM, whose names its "ffm/conv" prefix drops
    assert bis["all_convs"]["quantized_convs"] == 23
    with pytest.raises(ValueError, match="unknown QB policies"):
        quant_bench.bench_e2e_bisenet(batch=2, image_size=(64, 128),
                                      policy_names=["fastest"],
                                      device="cpu")


def test_main_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("QB_SHAPES", "l1_3x3_64")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quant_bench.main()
    monkeypatch.setenv("QB_E2E", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quant_bench.main()
