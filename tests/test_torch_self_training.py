"""The port's self-training step against the JAX package's: pseudo-labels,
ClassMix masks, CBST calibration, and the fused v1 + pseudo-label +
mean-teacher step.

``pseudo_labels`` (one threshold, and one per class) and ``classmix_masks``
(on the uniform scores JAX draws) are exact, the coverage, a float32 mean,
to one float32 rounding; the calibration is exact on the same float64
teacher.  One step of each of the plain self-training
step and the step with ClassMix, MinEnt and FDA runs in float64 on both
packages from the same BiSeNet-R18 and Tiny discriminator trees, with SGD,
ClassMix fed the scores JAX draws (``fold_in(key(seed), step)``, which
torch cannot reproduce) and FDA widened to float64 in the JAX package as
test_torch_fda_entropy.py does; the losses, coverages, G, D, BN running
statistics and the EMA after the step are held to the v1 limits of
test_torch_adversarial.py: losses rtol 1e-8, tensors rtol 1e-6 / atol
1e-10.  Both packages update
the EMA in float32, within those limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rtsds_tpu.ops.fda as jax_fda
from rtsds_tpu.models.bisenet import BiSeNet as FlaxBiSeNet
from rtsds_tpu.models.discriminator import (
    TinyDomainDiscriminator as FlaxTinyDiscriminator)
from rtsds_tpu.train.ema import ema_init as jax_ema_init
from rtsds_tpu.train.self_training import (
    calibrate_class_thresholds as jax_calibrate)
from rtsds_tpu.train.self_training import classmix_masks as jax_classmix
from rtsds_tpu.train.self_training import (
    make_self_training_step as jax_self_training_step)
from rtsds_tpu.train.self_training import pseudo_labels as jax_pseudo_labels
from rtsds_tpu.train.state import TrainState as JaxTrainState
from rtsds_tpu_torch.models.bisenet import BiSeNet
from rtsds_tpu_torch.models.pretrained import load_flax_variables
from rtsds_tpu_torch.train.ema import ema_init
from rtsds_tpu_torch.train.self_training import (
    calibrate_class_thresholds, classmix_masks, classmix_scores,
    make_self_training_step, pseudo_labels)
from test_torch_adversarial import (  # noqa: F401 -- trees: a fixture
    ITERATIONS, LAMBDA, LR_D, LR_G, _batch, _f64, _leaves, _port_states,
    _torch_key, _torch_layout, trees)
from test_torch_fda_entropy import _WideJnp

THRESHOLD = 0.18
SEED = 5
CASES = {
    # name: (classmix, lambda_ent, fda_beta, per-class threshold)
    "plain": (False, 0.0, 0.0, False),
    "classmix_minent_fda": (True, 0.05, 0.05, True),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _threshold(per_class):
    if not per_class:
        return THRESHOLD
    return np.linspace(0.12, 0.24, 19)


def test_pseudo_labels_are_exact(rng):
    logits = rng.normal(scale=2.0, size=(2, 19, 9, 13))
    for thr in (0.3, np.linspace(0.1, 0.6, 19), 1.1):
        with jax.enable_x64(True):
            want_lbl, want_cov = jax_pseudo_labels(
                jnp.asarray(logits.transpose(0, 2, 3, 1)), jnp.asarray(thr),
                ignore_index=19)
            want_lbl, want_cov = np.asarray(want_lbl), float(want_cov)
        got_lbl, got_cov = pseudo_labels(torch.from_numpy(logits), thr, 19)
        assert got_lbl.dtype == torch.int32 and got_cov.dtype == torch.float32
        np.testing.assert_array_equal(got_lbl.numpy(), want_lbl)
        np.testing.assert_allclose(float(got_cov), want_cov, rtol=2 ** -23)
    assert 0.0 < float(pseudo_labels(torch.from_numpy(logits), 0.3)[1]) < 1


def test_classmix_masks_on_jax_scores_are_exact(rng):
    labels = rng.integers(0, 21, size=(3, 12, 16))  # 19, 20: never chosen
    labels[2] = 19  # nothing to choose
    key = jax.random.key(4)
    want = np.asarray(jax_classmix(jnp.asarray(labels), key, 19))
    scores = torch.tensor(np.asarray(jax.random.uniform(key, (3, 19))))
    got = classmix_masks(torch.from_numpy(labels), scores, 19)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2].any() and got[:2].any()


def test_classmix_scores_depend_on_seed_and_step_alone():
    a = classmix_scores(3, 7, 4, 19)
    assert a.shape == (4, 19) and a.dtype == torch.float32
    assert torch.equal(a, classmix_scores(3, 7, 4, 19))
    assert not torch.equal(a, classmix_scores(3, 8, 4, 19))
    assert not torch.equal(a, classmix_scores(4, 7, 4, 19))


def test_calibration_is_exact_on_the_same_teacher(trees, rng):
    gen_vars, _ = trees
    images = [rng.normal(size=(2, 32, 48, 3)) for _ in range(2)]
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            jnp.asarray, {"params": gen_vars["params"],
                          "batch_stats": gen_vars["batch_stats"]})
        want = jax_calibrate(FlaxBiSeNet(num_classes=19).apply, variables,
                             [jnp.asarray(x) for x in images], 19,
                             portion=0.5)
    model = load_flax_variables(BiSeNet().double(), gen_vars).train()
    got = calibrate_class_thresholds(
        model, [(torch.from_numpy(x), None) for x in images], 19,
        portion=0.5)
    assert model.training  # the mode is restored
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got < 0.999).any()


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_step(request, trees):
    """One float64 JAX self-training step: the metrics, the G, D and EMA
    trees after it, and the ClassMix scores it drew."""
    classmix, lambda_ent, fda_beta, per_class = CASES[request.param]
    gen_vars, dis_vars = trees
    src, labels, tgt = _batch()

    def state(variables, apply_fn, lr):
        tx = optax.sgd(lr)
        return JaxTrainState(step=jnp.zeros((), jnp.int32),
                             params=variables["params"],
                             batch_stats=variables.get("batch_stats"),
                             opt_state=tx.init(variables["params"]),
                             apply_fn=apply_fn, tx=tx)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fda, "jnp", _WideJnp())
    try:
        with jax.enable_x64(True):
            gen_vars = jax.tree_util.tree_map(jnp.asarray, gen_vars)
            dis_vars = jax.tree_util.tree_map(jnp.asarray, dis_vars)
            gen = state(gen_vars, FlaxBiSeNet(num_classes=19).apply, LR_G)
            step = jax_self_training_step(
                LAMBDA, ITERATIONS, 19, threshold=_threshold(per_class),
                lambda_pl=0.7, ema_decay=0.99, donate=False,
                lambda_ent=lambda_ent, fda_beta=fda_beta, classmix=classmix,
                classmix_seed=SEED)
            gen, dis, ema, metrics = step(
                gen,
                state(dis_vars, FlaxTinyDiscriminator(num_classes=19).apply,
                      LR_D),
                jax_ema_init(gen.params), jnp.asarray(src),
                jnp.asarray(labels), jnp.asarray(tgt))
            scores = np.array(jax.random.uniform(
                jax.random.fold_in(jax.random.key(SEED), 0),
                (tgt.shape[0], 19)))
            metrics = {k: np.asarray(v) for k, v in metrics.items()}
            after = (_f64({"params": gen.params,
                           "batch_stats": gen.batch_stats}),
                     _f64({"params": dis.params}), _f64(ema))
    finally:
        mp.undo()
    return request.param, metrics, after, scores


def test_self_training_step_matches_jax_in_float64(jax_step, trees):
    name, want, (want_gen, want_dis, want_ema), scores = jax_step
    classmix, lambda_ent, fda_beta, per_class = CASES[name]
    gen, dis = _port_states(trees)
    ema = ema_init(gen.model)
    src, labels, tgt = _batch()
    step = make_self_training_step(
        LAMBDA, ITERATIONS, 19, threshold=_threshold(per_class),
        lambda_pl=0.7, ema_decay=0.99, lambda_ent=lambda_ent,
        fda_beta=fda_beta, classmix=classmix, classmix_seed=SEED)
    got = step(gen, dis, ema, torch.from_numpy(src),
               torch.from_numpy(labels), torch.from_numpy(tgt),
               scores=torch.from_numpy(scores) if classmix else None)
    assert gen.step == dis.step == 1

    keys = sorted(k for k in want if k not in ("correct", "total"))
    assert sorted(k for k in got if k not in ("correct", "total")) == keys
    assert ("mix_coverage" in keys) == classmix
    assert ("loss_entropy" in keys) == bool(lambda_ent)
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    assert 0.0 < float(got["pl_coverage"]) < 1.0
    assert int(got["correct"]) == int(want["correct"])

    new_gen = gen.model.state_dict()
    for path, arr in _leaves(want_gen["params"]):
        key = _torch_key(path)
        np.testing.assert_allclose(new_gen[key].numpy(), _torch_layout(arr),
                                   rtol=1e-6, atol=1e-10, err_msg=f"G {key}")
        np.testing.assert_allclose(
            ema[key].numpy(), _torch_layout(np.asarray(
                _dig(want_ema, path))), rtol=1e-6, atol=1e-10,
            err_msg=f"EMA {key}")
    for path, arr in _leaves(want_gen["batch_stats"]):
        key = _torch_key(path, stats=True)
        np.testing.assert_allclose(new_gen[key].numpy(), arr, rtol=1e-6,
                                   atol=1e-10, err_msg=f"G {key}")
    new_dis = dis.model.state_dict()
    for path, arr in _leaves(want_dis["params"]):
        key = _torch_key(path)
        np.testing.assert_allclose(new_dis[key].numpy(), _torch_layout(arr),
                                   rtol=1e-6, atol=1e-10, err_msg=f"D {key}")


def _dig(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_the_same_seed_and_step_give_the_same_mix(trees):
    """Without scores, the mix is drawn from ``(classmix_seed, step)``: two
    runs from the same states take the same step; another seed another."""
    src, labels, tgt = (torch.from_numpy(a) for a in _batch())

    def run(seed):
        gen, dis = _port_states(trees)
        ema = ema_init(gen.model)
        step = make_self_training_step(LAMBDA, ITERATIONS, 19,
                                       threshold=THRESHOLD, classmix=True,
                                       classmix_seed=seed)
        metrics = step(gen, dis, ema, src, labels, tgt)
        return float(metrics["mix_coverage"]), float(metrics["loss_pseudo"])

    assert run(SEED) == run(SEED)
    mixes = {run(s) for s in (SEED, SEED + 1, SEED + 2)}
    assert len(mixes) > 1


def test_self_training_needs_an_ignore_index():
    with pytest.raises(ValueError, match="ignore_index"):
        make_self_training_step(LAMBDA, ITERATIONS, None)
