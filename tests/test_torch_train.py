"""The port's train-mode BiSeNet and supervised train step against the Flax
model and the JAX package's train step on the CPU, on the same weights
(through the Flax weight bridge) and the same numpy batch.

Train mode is compared in float64, as the repo's other train-mode parity
tests are (test_reference_parity_bisenet.py).  In float32 the comparison is
ill-conditioned: a ReLU input within rounding of zero may land on either
side, and one such flip reroutes the gradient and moves some tensors'
updates by more than 1e-3 of their largest update; and the JAX batch norm
takes the variance in one pass, E[x^2] - E[x]^2 (ROADMAP C).  In float64 a
true match is exact to ~1e-8 of the tolerance and a wrong graph is O(1).

Tolerances: train-mode logits rtol 1e-3 / atol 1e-4 and BN running stats
rtol 1e-4 / atol 1e-5 after one forward; for one SGD step, the loss rtol
1e-4, each tensor's update within 1e-3 of its largest update plus 1e-6, and
the BN stats rtol 1e-4.  The step uses SGD: Adam's first update is
``lr * sign(g)`` up to eps, so gradients near zero would flip whole
entries on rounding alone.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.ops.preprocess import normalize as jax_normalize
from rtsds_tpu.train.optim import make_optimizer as jax_make_optimizer
from rtsds_tpu.train.state import create_train_state
from rtsds_tpu.train.supervised import make_train_step as jax_train_step
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.data.synthetic import SyntheticSegDataset
from rtsds_tpu_torch.eval.validate import make_eval_step
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.pretrained import (
    state_dict_from_flax, torch_scope)
from rtsds_tpu_torch.ops.preprocess import normalize
from rtsds_tpu_torch.train.factory import build_supervised
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import make_train_step

SIZE = (64, 128)
LR = 0.01


def _batch():
    ds = SyntheticSegDataset(2, SIZE, seed=3, fixed_tints=True)
    images = np.stack([ds[i][0] for i in range(2)])
    labels = np.stack([ds[i][1] for i in range(2)])
    labels[:, :4] = 19  # a band of ignored pixels
    return np.asarray(jax_normalize(jnp.asarray(images))), labels


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*path, k))
        else:
            yield (*path, k), np.asarray(v)


def _stat_key(path):
    *scopes, leaf = path
    return ".".join([*map(torch_scope, scopes), "running_" + leaf])


def _param_key(path, arr):
    *scopes, leaf = path
    name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    return ".".join([*map(torch_scope, scopes), name])


def _to_torch_layout(arr):
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _port_model(variables) -> BiSeNet:
    """The port's BiSeNet in float64 holding ``variables`` exactly."""
    model = BiSeNet().double()
    own = model.state_dict()
    for k, v in state_dict_from_flax(variables).items():
        own[k].copy_(v)
    return model


@pytest.fixture(scope="module")
def jax_step():
    """One float64 JAX SGD train step on a fresh Flax BiSeNet: the
    variables before it, the batch, the metrics, and the variables after
    it, plus the train-mode outputs and BN stats of one forward."""
    images, labels = _batch()
    images = images.astype(np.float64)
    tx = jax_make_optimizer("SGD", LR, momentum=0.9)
    flax_model = FlaxBiSeNet(num_classes=19)
    with jax.enable_x64(True):
        state = create_train_state(flax_model, jax.random.key(0),
                                   jnp.zeros((2, *SIZE, 3)), tx)
        state = state.replace(params=_f64(state.params),
                              batch_stats=_f64(state.batch_stats))
        state = state.replace(opt_state=tx.init(state.params))
        before = _f64(state.variables)
        outs, new_vars = flax_model.apply(before, jnp.asarray(images),
                                          train=True, mutable=["batch_stats"])
        forward = ([np.asarray(o) for o in outs],
                   _f64(new_vars["batch_stats"]))
        step = jax_train_step(ignore_index=19, donate=False)
        new_state, metrics = step(state, jnp.asarray(images),
                                  jnp.asarray(labels))
        metrics = {k: np.asarray(v) for k, v in metrics.items()}
        after = _f64(new_state.variables)
    return before, images, labels, metrics, after, forward


def test_train_mode_heads_and_bn_stats_match_flax(jax_step):
    before, images, _, _, _, (outs, batch_stats) = jax_step
    model = _port_model(before).train()
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, outs):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-3, atol=1e-4)
    state = model.state_dict()
    stats = list(_leaves(batch_stats))
    assert len(stats) == 2 * sum(
        isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    for path, want in stats:
        np.testing.assert_allclose(state[_stat_key(path)].numpy(), want,
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=_stat_key(path))


def test_sgd_train_step_matches_jax(jax_step):
    before, images, labels, metrics, after, _ = jax_step
    model = _port_model(before)
    state = TrainState(model, make_optimizer("SGD", model.parameters(), LR,
                                             momentum=0.9))
    got = make_train_step(19)(state, torch.from_numpy(images),
                              torch.from_numpy(labels))
    assert state.step == 1
    np.testing.assert_allclose(float(got["train_loss"]),
                               float(metrics["train_loss"]), rtol=1e-4)
    assert got["total"] == int(metrics["total"]) == labels.size
    assert abs(int(got["correct"]) - int(metrics["correct"])) <= \
        1e-3 * labels.size

    new = model.state_dict()
    params_before = dict(_leaves(before["params"]))
    for path, want_after in _leaves(after["params"]):
        key = _param_key(path, want_after)
        want = _to_torch_layout(want_after - params_before[path])
        upd = new[key].numpy() - _to_torch_layout(params_before[path])
        limit = 1e-3 * np.abs(want).max() + 1e-6
        assert np.abs(upd - want).max() <= limit, key
    for path, want in _leaves(after["batch_stats"]):
        np.testing.assert_allclose(new[_stat_key(path)].numpy(), want,
                                   rtol=1e-4, err_msg=_stat_key(path))


@contextlib.contextmanager
def _relu_routing(masks, replay=False):
    """``F.relu`` records which inputs it passes; with ``replay`` it passes
    the ones ``masks`` recorded, so a step takes another run's routing."""
    relu = F.relu
    recorded = iter(list(masks)) if replay else None

    def routed(x, inplace=False):
        if recorded is None:
            masks.append(x.detach() > 0)
            return relu(x, inplace)
        return x * next(recorded).to(x.dtype)

    F.relu = routed
    try:
        yield
    finally:
        F.relu = relu


def test_float32_step_matches_float64_on_the_same_relu_routing():
    """The port's float32 train step at b4 64x128 against its float64 step,
    the float32 step taking the float64 step's ReLU routing: loss rtol
    1e-4, BN stats rtol 1e-4 / atol 1e-5, each update within 1e-3 of its
    tensor's largest update + 1e-6.  Without the shared routing, one ReLU
    input within float32 rounding of zero that lands on the other side
    moves some tensors' updates by tens of times that limit (ROADMAP C);
    chip_smoke.py holds the card's float32 step to the CPU's this way."""
    ds = SyntheticSegDataset(4, SIZE, seed=3, fixed_tints=True)
    images = normalize(torch.from_numpy(np.stack([ds[i][0]
                                                  for i in range(4)])))
    labels = torch.from_numpy(np.stack([ds[i][1] for i in range(4)]))
    labels[:, :3] = 19
    torch.manual_seed(0)
    init = BiSeNet()  # float32 weights, exact in float64 too
    masks, runs = [], {}
    for dtype in (torch.float64, torch.float32):
        model = copy.deepcopy(init).to(dtype)
        state = TrainState(model, make_optimizer("SGD", model.parameters(),
                                                 LR, momentum=0.9))
        before = {k: v.double() for k, v in model.state_dict().items()}
        with _relu_routing(masks, replay=dtype == torch.float32):
            loss = float(make_train_step(19)(state, images.to(dtype),
                                             labels)["train_loss"])
        after = {k: v.double() for k, v in model.state_dict().items()}
        runs[dtype] = loss, before, after
    (want_loss, before, want), (got_loss, _, got) = runs.values()
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    params = dict(init.named_parameters())
    for k in want:
        if "running_" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        elif k in params:
            upd, ref = got[k] - before[k], want[k] - before[k]
            limit = 1e-3 * float(ref.abs().max()) + 1e-6
            assert float((upd - ref).abs().max()) <= limit, k


def test_training_refuses_a_batch_of_one():
    model = BiSeNet()
    state = TrainState(model, make_optimizer("SGD", model.parameters(), LR))
    images = torch.zeros((1, 32, 64, 3))
    labels = torch.zeros((1, 32, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="at least 2"):
        make_train_step(19)(state, images, labels)
    assert state.step == 0


def test_bf16_step_keeps_f32_params_and_logits():
    config = load_config(overrides={
        "precision": {"compute_dtype": "bfloat16"},
        "training": {"segmentation": {"epochs": 1}}})
    state = build_supervised(config, "bisenet", 2, "cpu")
    assert state.compute_dtype == torch.bfloat16
    images, labels = _batch()
    before = [p.detach().clone() for p in state.model.parameters()]
    m = make_train_step(19)(state, torch.from_numpy(images[:, :32, :64]),
                            torch.from_numpy(labels[:, :32, :64]))
    assert torch.isfinite(m["train_loss"]) and m["train_loss"].dtype == \
        torch.float32
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert any(not torch.equal(a, b) for a, b in
               zip(before, state.model.parameters()))
    with torch.no_grad(), state.autocast():
        out = state.model.eval()(torch.zeros((1, 3, 32, 64)))
    assert out.dtype == torch.float32
    # the validation step runs the bf16-trained model under autocast too
    step = make_eval_step(state.model, 19, compute_dtype=torch.bfloat16)
    hist = step(torch.from_numpy(images[:, :32, :64]),
                torch.from_numpy(labels[:, :32, :64]),
                torch.zeros((19, 19), dtype=torch.int32))
    assert int(hist.sum()) == int((labels[:, :32, :64] < 19).sum())


def test_factory_schedule_and_refusals():
    config = load_config(overrides={
        "training": {"segmentation": {"epochs": 3, "lr_decay_iter": 1}},
        "model": {"bisenet": {"optimizer": {"lr": 0.02,
                                            "head_lr_mult": 10.0}}}})
    state = build_supervised(config, "bisenet", 4, "cpu", seed=1)
    assert state.schedule(0) == pytest.approx(0.02)
    assert state.schedule(12) == pytest.approx(0.0)  # max_iter = 3 x 4
    assert [g["lr_mult"] for g in state.optimizer.param_groups] == [1.0, 10.0]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_supervised(config, "deeplab", 4, "cpu")
    bf = load_config(overrides={"precision": {"compute_dtype": "float16"}})
    with pytest.raises(ValueError, match="compute_dtype"):
        build_supervised(bf, "bisenet", 4, "cpu")
