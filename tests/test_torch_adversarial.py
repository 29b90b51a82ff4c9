"""The port's adversarial domain-adaptation steps against the JAX package's
``make_adversarial_step``, and the port's adversarial factory.

One step of each of v1, the gradient-reversal step and v2 runs in float64
on both packages, from the same Flax BiSeNet and Tiny discriminator trees
(through the weight bridge) and the same numpy batches, with plain SGD on
both networks, as tests/test_reference_parity_da.py builds its states.
The losses, ``correct``, G's parameters and BN running statistics and D's
parameters after the step are compared.  Limits are the JAX package's own
against the torch reference: v1 and the reversal step, losses rtol 1e-8 and
tensors rtol 1e-6 / atol 1e-10; v2, whose D phase runs the updated
generator again (and whose JAX pooling computes in float32), losses rtol
1e-6 and tensors rtol 1e-4 / atol 1e-6.

The isolation tests mirror tests/test_train_steps.py: with lambda = 0 the
generator's update does not depend on D, and D's update is the one its own
loss on the generator's detached outputs gives, so D takes none of G's
gradient.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.models.discriminator import (
    TinyDomainDiscriminator as FlaxTinyDiscriminator)
from rtsds_tpu.train.adversarial import (
    make_adversarial_step as jax_adversarial_step)
from rtsds_tpu.train.state import TrainState as JaxTrainState
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2, frozen_bn_parameters
from rtsds_tpu_torch.models.discriminator import (
    DomainDiscriminator, TinyDomainDiscriminator)
from rtsds_tpu_torch.models.pretrained import load_flax_variables, torch_scope
from rtsds_tpu_torch.ops.losses import bce_with_logits
from rtsds_tpu_torch.train.adversarial import make_adversarial_step
from rtsds_tpu_torch.train.factory import build_adversarial
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState

LAMBDA = 0.1
ITERATIONS = 5
GRL_ALPHA = 0.5
LR_G = 0.01
LR_D = 0.02
SRC = (64, 96)
TGT = (64, 128)
VARIANTS = {"v1": ("v1", 0.0), "grl": ("v1", GRL_ALPHA), "v2": ("v2", 0.0)}
LIMITS = {"v1": (1e-8, 1e-6, 1e-10), "grl": (1e-8, 1e-6, 1e-10),
          "v2": (1e-6, 1e-4, 1e-6)}  # loss rtol, tensor rtol, tensor atol


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch():
    rng = np.random.default_rng(7)
    src = rng.normal(size=(2, *SRC, 3))
    tgt = rng.normal(size=(2, *TGT, 3))
    labels = rng.integers(0, 20, size=(2, *SRC)).astype(np.int32)  # 19: void
    return src, labels, tgt


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*path, k))
        else:
            yield (*path, k), np.asarray(v)


def _torch_key(path, stats=False):
    *scopes, leaf = path
    name = ("running_" + leaf if stats else
            {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf])
    return ".".join([*map(torch_scope, scopes), name])


def _torch_layout(arr):
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr


@pytest.fixture(scope="module")
def trees():
    """Float64 Flax trees of BiSeNet-R18 (with the train-only heads) and the
    Tiny discriminator."""
    model = FlaxBiSeNet(num_classes=19)
    # jitted: one compile instead of one per op
    gen = jax.jit(lambda key, x: model.init(key, x, train=True))(
        jax.random.key(0), jnp.zeros((2, *SRC, 3)))
    dis = FlaxTinyDiscriminator(num_classes=19).init(
        jax.random.key(1), jnp.zeros((2, *TGT, 19)))
    return _f64(dict(gen)), _f64(dict(dis))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def jax_step(request, trees):
    """One float64 JAX step of the variant: its metrics and the G and D
    trees after it."""
    variant, grl_alpha = VARIANTS[request.param]
    gen_vars, dis_vars = trees
    src, labels, tgt = _batch()

    def state(variables, apply_fn, lr):
        tx = optax.sgd(lr)
        return JaxTrainState(step=jnp.zeros((), jnp.int32),
                             params=variables["params"],
                             batch_stats=variables.get("batch_stats"),
                             opt_state=tx.init(variables["params"]),
                             apply_fn=apply_fn, tx=tx)

    with jax.enable_x64(True):
        gen_vars = jax.tree_util.tree_map(jnp.asarray, gen_vars)
        dis_vars = jax.tree_util.tree_map(jnp.asarray, dis_vars)
        step = jax_adversarial_step(LAMBDA, ITERATIONS, epochs=1,
                                    ignore_index=19, variant=variant,
                                    donate=False, grl_alpha=grl_alpha)
        gen, dis, metrics = step(
            state(gen_vars, FlaxBiSeNet(num_classes=19).apply, LR_G),
            state(dis_vars, FlaxTinyDiscriminator(num_classes=19).apply,
                  LR_D),
            jnp.asarray(src), jnp.asarray(labels), jnp.asarray(tgt))
        metrics = {k: np.asarray(v) for k, v in metrics.items()}
        after = (_f64({"params": gen.params, "batch_stats": gen.batch_stats}),
                 _f64({"params": dis.params}))
    return request.param, metrics, after


def _port_states(trees, optimizer="SGD"):
    gen_vars, dis_vars = trees
    gen = load_flax_variables(BiSeNet().double(), gen_vars)
    dis = load_flax_variables(TinyDomainDiscriminator().double(), dis_vars)
    return (TrainState(gen, make_optimizer(optimizer, gen.parameters(), LR_G,
                                           momentum=0.0)),
            TrainState(dis, make_optimizer(optimizer, dis.parameters(), LR_D,
                                           momentum=0.0)))


def test_da_step_matches_jax_in_float64(jax_step, trees):
    name, want, (want_gen, want_dis) = jax_step
    variant, grl_alpha = VARIANTS[name]
    loss_rtol, rtol, atol = LIMITS[name]
    gen, dis = _port_states(trees)
    src, labels, tgt = _batch()
    step = make_adversarial_step(LAMBDA, ITERATIONS, 1, 19, variant,
                                 grl_alpha=grl_alpha)
    got = step(gen, dis, torch.from_numpy(src), torch.from_numpy(labels),
               torch.from_numpy(tgt))
    assert gen.step == dis.step == 1

    losses = sorted(k for k in want if k not in ("correct", "total"))
    assert sorted(k for k in got if k not in ("correct", "total")) == losses
    for k in losses:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=loss_rtol, atol=1e-12, err_msg=k)
    assert int(got["correct"]) == int(want["correct"])
    assert got["total"] == int(want["total"]) == labels.size

    new_gen = gen.model.state_dict()
    for path, arr in _leaves(want_gen["params"]):
        key = _torch_key(path)
        np.testing.assert_allclose(new_gen[key].numpy(), _torch_layout(arr),
                                   rtol=rtol, atol=atol, err_msg=f"G {key}")
    for path, arr in _leaves(want_gen["batch_stats"]):
        key = _torch_key(path, stats=True)
        np.testing.assert_allclose(new_gen[key].numpy(), arr, rtol=rtol,
                                   atol=atol, err_msg=f"G {key}")
    new_dis = dis.model.state_dict()
    for path, arr in _leaves(want_dis["params"]):
        key = _torch_key(path)
        np.testing.assert_allclose(new_dis[key].numpy(), _torch_layout(arr),
                                   rtol=rtol, atol=atol, err_msg=f"D {key}")
    assert all(p.requires_grad for p in dis.model.parameters())


class TinySeg(nn.Module):
    """A stand-in generator: conv + BN + ReLU -> per-pixel logits."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 16, 3, padding=1)
        self.bn = nn.BatchNorm2d(16)
        self.head = nn.Conv2d(16, 19, 1)

    def forward(self, x):
        logits = self.head(torch.relu(self.bn(self.conv(x))))
        return (logits, None, None) if self.training else logits


def _tiny_states(d_seed, lr_d=0.05):
    torch.manual_seed(0)
    gen = TinySeg()
    torch.manual_seed(d_seed)
    dis = TinyDomainDiscriminator()
    return (TrainState(gen, make_optimizer("Adam", gen.parameters(), 0.05)),
            TrainState(dis, make_optimizer("Adam", dis.parameters(), lr_d,
                                           weight_decay=1e-4)))


def _tiny_batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((2, 8, 8, 3), generator=g),
            torch.randint(0, 19, (2, 8, 8), generator=g),
            torch.randn((2, 8, 8, 3), generator=g))


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_lambda_zero_isolates_the_generator_from_d(variant):
    """With lambda = 0 the G update does not depend on D's init; with
    lambda > 0 it does."""
    def g_after_one_step(lambda_, d_seed):
        gen, dis = _tiny_states(d_seed)
        step = make_adversarial_step(lambda_, 4, 2, variant=variant)
        step(gen, dis, *_tiny_batch())
        return torch.cat([p.detach().ravel()
                          for p in gen.model.parameters()])

    torch.testing.assert_close(g_after_one_step(0.0, 1),
                               g_after_one_step(0.0, 2), rtol=0, atol=0)
    if variant == "v1":
        # v2's lambda is max(lambda, 10 lambda - ...): 0 stays 0
        assert not torch.allclose(g_after_one_step(0.5, 1),
                                  g_after_one_step(0.5, 2))


def test_d_takes_none_of_the_generators_gradient():
    """D's v1 update is SGD on D's own loss over the softmax of the
    generator's pre-update outputs: nothing of G's adversarial backward
    reaches D's gradients, and D's parameters require gradients again
    after the step."""
    gen, dis = _tiny_states(1)
    gen.optimizer = make_optimizer("SGD", gen.model.parameters(), 0.05)
    dis.optimizer = make_optimizer("SGD", dis.model.parameters(), 0.1,
                                   momentum=0.0)
    src, labels, tgt = _tiny_batch()
    g0, d0 = copy.deepcopy(gen.model), copy.deepcopy(dis.model)
    metrics = make_adversarial_step(0.5, 4, 2)(gen, dis, src, labels, tgt)
    assert float(metrics["loss_disc_source"]) > 0
    assert float(metrics["loss_disc_target"]) > 0
    assert all(p.requires_grad for p in dis.model.parameters())

    with torch.no_grad():
        src_main = g0.train()(src.permute(0, 3, 1, 2))[0]
        tgt_main = g0(tgt.permute(0, 3, 1, 2))[0]
    loss = (bce_with_logits(d0(torch.softmax(src_main, 1)), 1.0)
            + bce_with_logits(d0(torch.softmax(tgt_main, 1)), 0.0)) / 4
    loss.backward()
    for (name, p), q in zip(d0.named_parameters(), dis.model.parameters()):
        torch.testing.assert_close(q.detach(), p.detach() - 0.1 * p.grad,
                                   rtol=1e-6, atol=1e-7, msg=name)


@pytest.mark.parametrize("which", ["source", "target"])
def test_da_step_refuses_a_batch_of_one(which):
    """A generator that trains on at least 2 frames (``min_train_batch``,
    BiSeNet's) refuses one, in either stream."""
    gen, dis = _tiny_states(1)
    gen.model.min_train_batch = 2
    src, labels, tgt = _tiny_batch()
    if which == "source":
        src, labels = src[:1], labels[:1]
    else:
        tgt = tgt[:1]
    with pytest.raises(ValueError, match=f"at least 2 frames, got 1 {which}"):
        make_adversarial_step(0.1, 4, 2)(gen, dis, src, labels, tgt)
    assert gen.step == dis.step == 0


@pytest.mark.parametrize("kwargs,error,match", [
    ({"variant": "v2", "grl_alpha": 0.1}, ValueError, "v1 step only"),
    ({"variant": "v3"}, ValueError, "unknown adversarial variant"),
])
def test_step_refusals(kwargs, error, match):
    with pytest.raises(error, match=match):
        make_adversarial_step(0.1, 4, 2, **kwargs)


def test_bf16_da_step_keeps_f32_params_and_losses():
    config = load_config(overrides={
        "precision": {"compute_dtype": "bfloat16"},
        "training": {"domain_adaptation": {"epochs": 1, "iterations": 2}}})
    gen, dis = build_adversarial(config, "cpu", seed=3)
    assert gen.compute_dtype == dis.compute_dtype == torch.bfloat16
    src, labels, tgt = _tiny_batch()
    src = torch.randn((2, 32, 64, 3))
    tgt = torch.randn((2, 32, 48, 3))
    labels = torch.randint(0, 20, (2, 32, 64))
    for variant in ("v1", "v2"):
        metrics = make_adversarial_step(0.1, 2, 1, variant=variant)(
            gen, dis, src, labels, tgt)
        for k, v in metrics.items():
            if k.startswith("loss_"):
                assert v.dtype == torch.float32 and torch.isfinite(v), k
    assert all(p.dtype == torch.float32 for p in gen.model.parameters())
    assert all(p.dtype == torch.float32 for p in dis.model.parameters())
    with torch.no_grad(), dis.autocast():
        assert dis.model(torch.rand((2, 19, 16, 16))).dtype == torch.float32


def _da_config(**da):
    return load_config(overrides={
        "training": {"domain_adaptation": {"epochs": 3, "iterations": 4,
                                           "lr_decay_iter": 1, **da}},
        "model": {"adversarial_model": {
            "generator": {"optimizer": {"lr": 0.02}},
            "discriminator": {"optimizer": {"lr": 0.01}}}}})


def test_build_adversarial_schedules_and_optimizers():
    gen, dis = build_adversarial(_da_config(), "cpu", seed=5)
    assert isinstance(gen.model, BiSeNet)
    assert isinstance(dis.model, TinyDomainDiscriminator)
    # G: poly over epochs * iterations = 12 steps, power 0.9
    assert gen.schedule(0) == pytest.approx(0.02)
    assert gen.schedule(6) == pytest.approx(0.02 * 0.5 ** 0.9)
    # D under v1: once per epoch, power 0.05
    assert dis.schedule(3) == pytest.approx(0.01)
    assert dis.schedule(4) == pytest.approx(0.01 * (2 / 3) ** 0.05)
    inner = dis.optimizer.optimizer
    assert isinstance(inner, torch.optim.Adam)
    assert inner.param_groups[0]["weight_decay"] == pytest.approx(1e-4)
    # G starts from the seed, D from the seed + 1
    again, _ = build_adversarial(_da_config(), "cpu", seed=5)
    for a, b in zip(gen.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
    torch.manual_seed(6)
    assert torch.equal(dis.model.conv1.weight,
                       TinyDomainDiscriminator().conv1.weight)

    # D under v2: per step, over epochs * iterations
    _, dis2 = build_adversarial(_da_config(variant="v2"), "cpu")
    assert dis2.schedule(6) == pytest.approx(0.01 * 0.5 ** 0.05)


def test_build_adversarial_fc_discriminator_and_refusals():
    fc = load_config(overrides={
        "model": {"adversarial_model": {"discriminator": {"name": "fc"}}}})
    _, dis = build_adversarial(fc, "cpu")
    assert isinstance(dis.model, DomainDiscriminator)
    with pytest.raises(ValueError, match="segmentor optimizers only"):
        build_adversarial(load_config(overrides={
            "model": {"adversarial_model": {"discriminator": {
                "optimizer": {"head_lr_mult": 10.0}}}}}), "cpu")
    with pytest.raises(ValueError, match="Invalid generator name"):
        build_adversarial(load_config(overrides={
            "model": {"adversarial_model": {"generator": {
                "name": "pspnet"}}}}), "cpu")
    with pytest.raises(ValueError, match="unknown discriminator"):
        build_adversarial(load_config(overrides={
            "model": {"adversarial_model": {"discriminator": {
                "name": "patch"}}}}), "cpu")
    with pytest.raises(ValueError, match="Invalid loss name"):
        build_adversarial(load_config(overrides={
            "model": {"adversarial_model": {"discriminator": {
                "criterion": {"name": "Hinge"}}}}}), "cpu")


def test_build_adversarial_deeplab_generator_keeps_bn_frozen():
    config = load_config(overrides={
        "model": {"adversarial_model": {"generator": {"name": "deeplab"}}}})
    gen, dis = build_adversarial(config, "cpu", seed=5)
    assert isinstance(gen.model, DeepLabV2)
    assert isinstance(dis.model, TinyDomainDiscriminator)
    assert {id(p) for p in gen.optimizer.frozen} == {
        id(p) for p in frozen_bn_parameters(gen.model)}
    assert dis.optimizer.frozen == []


def test_da_step_takes_a_batch_of_one_from_a_deeplab_generator():
    torch.manual_seed(0)
    model = DeepLabV2(layers=(1, 1, 1, 1))
    gen = TrainState(model, make_optimizer("SGD", model.parameters(), 0.01,
                                           frozen=frozen_bn_parameters(model)))
    _, dis = _tiny_states(1)
    g = torch.Generator().manual_seed(0)
    metrics = make_adversarial_step(0.1, 4, 2)(
        gen, dis, torch.randn((1, 32, 48, 3), generator=g),
        torch.randint(0, 20, (1, 32, 48), generator=g),
        torch.randn((1, 32, 64, 3), generator=g))
    assert gen.step == dis.step == 1
    assert torch.isfinite(metrics["loss_adversarial"])


# --- the steps on height bands (the spatial axis) --------------------------

SAME = dict(rtol=1e-9, atol=1e-12)  # bands against one device


def _da_inputs(bands: int):
    """The DA batch as tensors; with ``bands``, source and target each cut
    into that many height bands on CPU "devices", each on its own row
    partition."""
    from rtsds_tpu_torch.parallel.spatial import split_batch

    src, labels, tgt = (torch.from_numpy(a) for a in _batch())
    if not bands:
        return src, labels, tgt
    src, labels = split_batch(src, labels, ["cpu"] * bands)
    tgt, _ = split_batch(tgt, torch.zeros(tgt.shape[:3]), ["cpu"] * bands)
    return src, labels, tgt


def _numpy_sd(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def da_runs(trees, bands_list, **step_kwargs) -> dict:
    """One port DA step from the trees per entry of ``bands_list`` (0: one
    device): the metrics, G's and D's state after it."""
    runs = {}
    for bands in bands_list:
        gen, dis = _port_states(trees)
        step = make_adversarial_step(LAMBDA, ITERATIONS, 1, 19,
                                     **step_kwargs)
        got = step(gen, dis, *_da_inputs(bands))
        runs[bands] = ({k: float(v) for k, v in got.items()},
                       _numpy_sd(gen.model), _numpy_sd(dis.model))
    return runs


def held_to_one_device_and_jax(runs: dict, bands: int, want, want_gen,
                               want_dis, limits, extra=()) -> None:
    """The banded run equals the one-device run (``runs[0]``) at rtol 1e-9
    / atol 1e-12, and JAX's step within ``limits`` (loss rtol, tensor
    rtol, tensor atol), as test_da_step_matches_jax_in_float64 holds the
    one-device step.  ``extra``: further (got, one device's) dict pairs
    held alike."""
    (metrics, gen, dis), (m1, g1, d1) = runs[bands], runs[0]
    for got, one, what in ((metrics, m1, "metrics"), (gen, g1, "G"),
                           (dis, d1, "D"), *extra):
        assert sorted(got) == sorted(one), what
        for k in one:
            np.testing.assert_allclose(got[k], one[k], err_msg=f"{what} {k}",
                                       **SAME)
    loss_rtol, rtol, atol = limits
    for k in want:
        if k not in ("correct", "total"):
            np.testing.assert_allclose(metrics[k], float(want[k]),
                                       rtol=loss_rtol, atol=1e-12, err_msg=k)
    assert metrics["correct"] == int(want["correct"])
    assert metrics["total"] == int(want["total"])
    for path, arr in _leaves(want_gen["params"]):
        key = _torch_key(path)
        np.testing.assert_allclose(gen[key], _torch_layout(arr), rtol=rtol,
                                   atol=atol, err_msg=f"G {key}")
    for path, arr in _leaves(want_gen["batch_stats"]):
        key = _torch_key(path, stats=True)
        np.testing.assert_allclose(gen[key], arr, rtol=rtol, atol=atol,
                                   err_msg=f"G {key}")
    for path, arr in _leaves(want_dis["params"]):
        key = _torch_key(path)
        np.testing.assert_allclose(dis[key], _torch_layout(arr), rtol=rtol,
                                   atol=atol, err_msg=f"D {key}")


def test_da_step_on_bands_equals_one_device_and_jax(jax_step, trees):
    """Each variant (v1, the reversal step with its reversal band by band,
    v2 with its pooling to the target's size) on 2 height bands of source
    and target."""
    name, want, (want_gen, want_dis) = jax_step
    variant, grl_alpha = VARIANTS[name]
    runs = da_runs(trees, (0, 2), variant=variant, grl_alpha=grl_alpha)
    held_to_one_device_and_jax(runs, 2, want, want_gen, want_dis,
                               LIMITS[name])


@pytest.mark.parametrize("size", [(64, 128), (37, 20), (80, 50), (3, 7)])
def test_banded_adaptive_pool_equals_the_whole_maps(size):
    """v2 pools the source's logits to the target's size: on 3 height
    bands (one holding no row) against ``F.adaptive_avg_pool2d`` on the
    whole map, to the map's own height (each band alone) and to others
    (each output band reading the rows its windows span), at rtol 1e-12."""
    from rtsds_tpu_torch.ops.pool import adaptive_avg_pool2d
    from rtsds_tpu_torch.parallel.spatial import (
        Bands, _Layout, gather, split_rows)

    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 19, 64, 96)))
    starts = [0, 40, 40]
    bands = Bands(split_rows(x, ["cpu"] * 3, starts=starts), starts, 64,
                  _Layout(["cpu"] * 3))
    np.testing.assert_allclose(
        gather(adaptive_avg_pool2d(bands, size)).numpy(),
        torch.nn.functional.adaptive_avg_pool2d(x, size).numpy(),
        rtol=1e-12, atol=1e-15)
