"""The port's distillation against the JAX package's, and its teacher
loader.

``distillation_kl`` is held to JAX's at rtol 1e-10 in float64.  One step of
a BiSeNet-R18 student at 64x128 (batch 2) under a thin DeepLabV2 teacher
([1, 1, 1, 1] blocks, BN statistics off the identity) runs in float64 on
both packages from the same Flax trees, with SGD: the losses at rtol 1e-8,
parameters and BN running statistics at rtol 1e-6 / atol 1e-10.  With
``alpha = 1`` the step is the supervised step, exactly.

``load_teacher`` reads the port's own checkpoints (the best epoch, else the
latest; ``model``, else ``generator``; the ``ema`` item when asked and
present) and the state dicts that ``rtsds_tpu.export_torch`` writes from a
JAX tree, in its DeepLab layout with a prefix and its reference BiSeNet
layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
from rtsds_tpu.models.pretrained import (
    export_reference_bisenet_state_dict, export_torch_state_dict,
    save_state_dict)
from rtsds_tpu.train.distill import distillation_kl as jax_distillation_kl
from rtsds_tpu.train.distill import make_distill_step as jax_distill_step
from rtsds_tpu.train.state import TrainState as JaxTrainState
from rtsds_tpu_torch.callbacks.checkpoint import CheckpointManager
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2
from rtsds_tpu_torch.models.pretrained import (
    load_flax_variables, load_segmentor_state)
from rtsds_tpu_torch.train.distill import (
    distillation_kl, load_teacher, make_distill_step)
from rtsds_tpu_torch.train.ema import EMA, ema_init
from rtsds_tpu_torch.train.optim import make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import make_train_step
from test_torch_adversarial import _f64, _leaves, _torch_key, _torch_layout
from test_torch_deeplab import THIN, flax_tree

SIZE = (64, 128)
LR = 0.01
T = 2.0
ALPHA = 0.4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch():
    rng = np.random.default_rng(13)
    images = rng.normal(size=(2, *SIZE, 3))
    labels = rng.integers(0, 20, size=(2, *SIZE)).astype(np.int32)
    return images, labels


def test_distillation_kl_matches_jax_in_float64(rng):
    s = rng.normal(size=(2, 19, 10, 14))
    t = rng.normal(scale=2.0, size=(2, 19, 10, 14))
    with jax.enable_x64(True):
        want = float(jax_distillation_kl(
            jnp.asarray(s.transpose(0, 2, 3, 1)),
            jnp.asarray(t.transpose(0, 2, 3, 1)), 3.0))
    got = distillation_kl(torch.from_numpy(s), torch.from_numpy(t), 3.0)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-10)
    assert float(distillation_kl(torch.from_numpy(t), torch.from_numpy(t))) \
        == pytest.approx(0.0, abs=1e-12)


@pytest.fixture(scope="module")
def trees():
    student = FlaxBiSeNet(num_classes=19)
    s_vars = _f64(dict(jax.jit(lambda k, x: student.init(k, x, train=True))(
        jax.random.key(0), jnp.zeros((2, *SIZE, 3)))))
    t_vars = _f64(flax_tree(THIN, (1, *SIZE, 3), seed=3))
    return s_vars, t_vars


@pytest.fixture(scope="module")
def jax_step(trees):
    s_vars, t_vars = trees
    images, labels = _batch()
    tx = optax.sgd(LR)
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(jnp.asarray, s_vars["params"])
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               s_vars["batch_stats"]),
            opt_state=tx.init(params),
            apply_fn=FlaxBiSeNet(num_classes=19).apply, tx=tx)
        step = jax_distill_step(FlaxDeepLab(num_classes=19,
                                            layers=THIN).apply,
                                ignore_index=19, temperature=T, alpha=ALPHA,
                                donate=False)
        new, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, t_vars),
                            jnp.asarray(images), jnp.asarray(labels))
        metrics = {k: np.asarray(v) for k, v in metrics.items()}
        after = _f64({"params": new.params, "batch_stats": new.batch_stats})
    return metrics, after


def _student(s_vars, lr=LR):
    model = load_flax_variables(BiSeNet().double(), s_vars)
    return TrainState(model, make_optimizer("SGD", model.parameters(), lr,
                                            momentum=0.0))


def _teacher(t_vars):
    return load_flax_variables(DeepLabV2(layers=THIN).double(), t_vars)


def test_distill_step_matches_jax_in_float64(trees, jax_step):
    want, after = jax_step
    s_vars, t_vars = trees
    state = _student(s_vars)
    teacher = _teacher(t_vars)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    images, labels = _batch()
    got = make_distill_step(teacher, 19, temperature=T, alpha=ALPHA)(
        state, torch.from_numpy(images), torch.from_numpy(labels))
    for k in ("train_loss", "loss_ce", "loss_distill"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-8,
                                   err_msg=k)
    assert int(got["correct"]) == int(want["correct"])
    assert got["total"] == int(want["total"])
    new = state.model.state_dict()
    for path, arr in _leaves(after["params"]):
        key = _torch_key(path)
        np.testing.assert_allclose(new[key].numpy(), _torch_layout(arr),
                                   rtol=1e-6, atol=1e-10, err_msg=key)
    for path, arr in _leaves(after["batch_stats"]):
        key = _torch_key(path, stats=True)
        np.testing.assert_allclose(new[key].numpy(), arr, rtol=1e-6,
                                   atol=1e-10, err_msg=key)
    # the teacher is frozen: eval mode, no gradient, nothing moved
    assert not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k


def test_alpha_one_is_the_supervised_step(trees):
    s_vars, t_vars = trees
    images, labels = (torch.from_numpy(a) for a in _batch())
    distilled, plain = _student(s_vars), _student(s_vars)
    got = make_distill_step(_teacher(t_vars), 19, alpha=1.0)(
        distilled, images, labels)
    want = make_train_step(19)(plain, images, labels)
    assert float(got["train_loss"]) == float(want["train_loss"])
    plain_state = plain.model.state_dict()
    for k, v in distilled.model.state_dict().items():
        assert torch.equal(v, plain_state[k]), k


def _save(directory, epoch, item, model, ema=None, monitor=None):
    state = TrainState(model, make_optimizer("SGD", model.parameters(), LR))
    states = {item: state}
    if ema is not None:
        states["ema"] = EMA(ema)
    CheckpointManager(str(directory)).save(epoch, states, monitor=monitor)


def _deeplab(seed):
    torch.manual_seed(seed)
    return DeepLabV2(layers=THIN)


def test_load_teacher_reads_the_ports_checkpoints(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_teacher(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_teacher(str(tmp_path / "missing"))

    best, latest = _deeplab(1), _deeplab(2)
    ema = {k: v + 1.0 for k, v in ema_init(best).items()}
    _save(tmp_path / "sup", 0, "model", best, ema=ema, monitor=0.9)
    _save(tmp_path / "sup", 1, "model", latest, monitor=0.5)
    # the best epoch, on its EMA weights with its own BN buffers
    got = load_teacher(str(tmp_path / "sup"))
    for k, v in best.state_dict().items():
        assert torch.equal(got[k], ema.get(k, v)), k
    # use_ema=False: the trained weights
    got = load_teacher(str(tmp_path / "sup"), use_ema=False)
    for k, v in best.state_dict().items():
        assert torch.equal(got[k], v), k

    # a DA run's generator, no monitor: the latest epoch; no EMA stored
    _save(tmp_path / "da", 0, "generator", best)
    _save(tmp_path / "da", 3, "generator", latest)
    got = load_teacher(str(tmp_path / "da"))
    teacher = load_segmentor_state(DeepLabV2(layers=THIN), got)
    for k, v in latest.state_dict().items():
        assert torch.equal(teacher.state_dict()[k], v), k


def test_load_teacher_reads_export_torch_files(tmp_path, rng):
    """A JAX tree written by ``export_torch``'s functions, in the DeepLab
    layout with ``--prefix Scale.`` and in the reference BiSeNet layout."""
    x = torch.from_numpy(rng.normal(size=(1, 3, 32, 64)))
    t_vars = flax_tree(THIN, (1, 32, 64, 3), seed=5)
    path = str(tmp_path / "deeplab.pth")
    save_state_dict(export_torch_state_dict(t_vars, prefix="Scale."), path)
    got = load_segmentor_state(DeepLabV2(layers=THIN).double(),
                               load_teacher(path)).eval()
    want = load_flax_variables(DeepLabV2(layers=THIN).double(),
                               _f64(t_vars)).eval()
    with torch.no_grad():
        torch.testing.assert_close(got(x), want(x), rtol=1e-6, atol=1e-6)

    model = FlaxBiSeNet(num_classes=19)
    b_vars = jax.tree_util.tree_map(np.asarray, dict(model.init(
        jax.random.key(1), jnp.zeros((1, 32, 64, 3)), train=True)))
    path = str(tmp_path / "bisenet.pth")
    save_state_dict(export_reference_bisenet_state_dict(b_vars), path)
    state = load_teacher(path)
    assert not any(k.startswith("context_path.features.") for k in state)
    got = load_segmentor_state(BiSeNet().double(), state).eval()
    want = load_flax_variables(BiSeNet().double(), _f64(b_vars)).eval()
    with torch.no_grad():
        torch.testing.assert_close(got(x), want(x), rtol=1e-6, atol=1e-6)
