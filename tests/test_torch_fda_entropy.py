"""The port's FDA and MinEnt against the JAX package's, alone and inside the
v1, gradient-reversal and v2 adversarial steps.

``rtsds_tpu.ops.fda.fda_source_to_target`` casts its input to float32
whatever its dtype, where the port computes in at least float32.  To hold
the two to one algorithm in float64, the JAX function runs here with that
cast widened to float64 (its module's ``jnp`` seen through a proxy whose
``float32`` is ``float64``); nothing in the JAX package changes.  Then:
the mask exactly; FDA at rtol 1e-9 / atol 1e-12, on same-size and resized
targets, unequal batches and ``beta = 0``; and the steps with
``lambda_ent > 0`` and ``fda_beta > 0`` at the limits of
test_torch_adversarial.py for each variant.  Unpatched, the JAX
function's float32 FFTs and the port's differ by float32 rounding
(ROADMAP C); that gap is held below 1e-5 here.
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
from rtsds_tpu.ops.losses import entropy_loss as jax_entropy_loss
from rtsds_tpu.train.adversarial import (
    make_adversarial_step as jax_adversarial_step)
from rtsds_tpu.train.state import TrainState as JaxTrainState
from rtsds_tpu_torch.ops.fda import fda_source_to_target, low_freq_mask
from rtsds_tpu_torch.ops.losses import entropy_loss
from rtsds_tpu_torch.train.adversarial import make_adversarial_step
from test_torch_adversarial import (  # noqa: F401 -- trees: a fixture
    ITERATIONS, LAMBDA, LIMITS, LR_D, LR_G, VARIANTS, _batch, _f64, _leaves,
    _port_states, _torch_key, _torch_layout, trees)

LAMBDA_ENT = 0.05
FDA_BETA = 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _WideJnp:
    """``jax.numpy`` whose ``float32`` is ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def wide_jax_fda(monkeypatch):
    monkeypatch.setattr(jax_fda, "jnp", _WideJnp())


@pytest.mark.parametrize("h,w,beta", [(64, 96, 0.05), (64, 128, 0.01),
                                      (31, 47, 0.2), (16, 16, 0.0),
                                      (720, 1280, 0.01)])
def test_low_freq_mask_is_exact(h, w, beta):
    got = low_freq_mask(h, w, beta)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_fda.low_freq_mask(h, w, beta))


FDA_CASES = {
    "same_size": ((2, 64, 96, 3), (2, 64, 96, 3), 0.05),
    "resized_target": ((2, 64, 96, 3), (2, 64, 128, 3), 0.05),
    "unequal_batches": ((3, 40, 56, 3), (2, 32, 48, 3), 0.1),
}


@pytest.mark.parametrize("case", sorted(FDA_CASES))
def test_fda_matches_jax_in_float64(case, rng, wide_jax_fda):
    src_shape, tgt_shape, beta = FDA_CASES[case]
    src, tgt = rng.normal(size=src_shape), rng.normal(size=tgt_shape)
    with jax.enable_x64(True):
        want = np.asarray(jax_fda.fda_source_to_target(
            jnp.asarray(src), jnp.asarray(tgt), beta))
    assert want.dtype == np.float64
    got = fda_source_to_target(torch.from_numpy(src), torch.from_numpy(tgt),
                               beta)
    assert got.dtype == torch.float64 and got.shape == src_shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    assert not np.allclose(got.numpy(), src)


def test_fda_with_beta_zero_returns_the_input(rng):
    src = torch.from_numpy(rng.normal(size=(2, 16, 24, 3)))
    tgt = torch.from_numpy(rng.normal(size=(2, 16, 24, 3)))
    assert fda_source_to_target(src, tgt, 0.0) is src
    assert fda_source_to_target(src, tgt, -1.0) is src


def test_fda_against_the_unpatched_jax_function(rng, record_property):
    """The JAX package's own float32 FFTs against the port's: the gap is
    float32 rounding, recorded as ``max_abs_gap`` in the JUnit report, and
    the port keeps the source's dtype (float32 and bfloat16 compute in
    float32)."""
    src, tgt = rng.normal(size=(2, 64, 96, 3)), rng.normal(size=(2, 64, 128,
                                                                  3))
    want = np.asarray(jax_fda.fda_source_to_target(
        jnp.asarray(src, jnp.float32), jnp.asarray(tgt, jnp.float32), 0.05))
    got = fda_source_to_target(torch.from_numpy(src).float(),
                               torch.from_numpy(tgt).float(), 0.05)
    assert got.dtype == torch.float32
    record_property("max_abs_gap", float(np.abs(got.numpy() - want).max()))
    record_property("max_abs_output", float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    half = fda_source_to_target(torch.from_numpy(src).bfloat16(),
                                torch.from_numpy(tgt).float(), 0.05)
    assert half.dtype == torch.bfloat16


def test_entropy_loss_matches_jax_in_float64(rng):
    logits = rng.normal(scale=3.0, size=(2, 19, 12, 20))
    with jax.enable_x64(True):
        want = float(jax_entropy_loss(jnp.asarray(logits.transpose(0, 2, 3,
                                                                   1))))
    got = entropy_loss(torch.from_numpy(logits))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-10)
    assert 0.0 < float(got) < 1.0
    # bf16 logits give a float32 loss
    assert entropy_loss(torch.from_numpy(logits).bfloat16()).dtype == \
        torch.float32


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def jax_step(request, trees):
    """One float64 JAX step of the variant with MinEnt and FDA, FDA widened
    to float64: its metrics and the G and D trees after it."""
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

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fda, "jnp", _WideJnp())
    try:
        with jax.enable_x64(True):
            gen_vars = jax.tree_util.tree_map(jnp.asarray, gen_vars)
            dis_vars = jax.tree_util.tree_map(jnp.asarray, dis_vars)
            step = jax_adversarial_step(
                LAMBDA, ITERATIONS, epochs=1, ignore_index=19,
                variant=variant, donate=False, grl_alpha=grl_alpha,
                lambda_ent=LAMBDA_ENT, fda_beta=FDA_BETA)
            gen, dis, metrics = step(
                state(gen_vars, FlaxBiSeNet(num_classes=19).apply, LR_G),
                state(dis_vars, FlaxTinyDiscriminator(num_classes=19).apply,
                      LR_D),
                jnp.asarray(src), jnp.asarray(labels), jnp.asarray(tgt))
            metrics = {k: np.asarray(v) for k, v in metrics.items()}
            after = (_f64({"params": gen.params,
                           "batch_stats": gen.batch_stats}),
                     _f64({"params": dis.params}))
    finally:
        mp.undo()
    return request.param, metrics, after


def test_da_step_with_minent_and_fda_matches_jax_in_float64(jax_step, trees):
    name, want, (want_gen, want_dis) = jax_step
    variant, grl_alpha = VARIANTS[name]
    loss_rtol, rtol, atol = LIMITS[name]
    gen, dis = _port_states(trees)
    src, labels, tgt = _batch()
    step = make_adversarial_step(LAMBDA, ITERATIONS, 1, 19, variant,
                                 lambda_ent=LAMBDA_ENT, fda_beta=FDA_BETA,
                                 grl_alpha=grl_alpha)
    got = step(gen, dis, torch.from_numpy(src), torch.from_numpy(labels),
               torch.from_numpy(tgt))
    losses = sorted(k for k in want if k not in ("correct", "total"))
    assert "loss_entropy" in losses
    assert sorted(k for k in got if k not in ("correct", "total")) == losses
    for k in losses:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=loss_rtol, atol=1e-12, err_msg=k)
    assert int(got["correct"]) == int(want["correct"])

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


# --- on height bands (the spatial axis) ------------------------------------

def test_banded_log_softmax_and_entropy_equal_the_whole_map(rng):
    """``F.log_softmax`` and MinEnt's entropy on 2 height bands against the
    whole map at rtol 1e-12, and the loss against JAX's at rtol 1e-10."""
    import torch.nn.functional as F

    from rtsds_tpu_torch.parallel.spatial import (
        Bands, _Layout, gather, split_rows)

    logits = rng.normal(scale=3.0, size=(2, 19, 13, 20))
    x = torch.from_numpy(logits)
    bands = Bands(split_rows(x, ["cpu"] * 2, starts=[0, 6]), [0, 6], 13,
                  _Layout(["cpu"] * 2))
    np.testing.assert_allclose(gather(F.log_softmax(bands, dim=1)).numpy(),
                               F.log_softmax(x, dim=1).numpy(), rtol=1e-12,
                               atol=1e-14)
    got = float(entropy_loss(bands))
    np.testing.assert_allclose(got, float(entropy_loss(x)), rtol=1e-12)
    with jax.enable_x64(True):
        want = float(jax_entropy_loss(jnp.asarray(logits.transpose(0, 2, 3,
                                                                   1))))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_fda_on_banded_frames_cuts_the_one_device_result_at_the_bands(rng):
    from rtsds_tpu_torch.parallel.spatial import FrameBands, split_batch

    src = torch.from_numpy(rng.normal(size=(2, 40, 56, 3)))
    tgt = torch.from_numpy(rng.normal(size=(2, 32, 48, 3)))
    frames, _ = split_batch(src, torch.zeros(src.shape[:3]), ["cpu"] * 2)
    t_frames, _ = split_batch(tgt, torch.zeros(tgt.shape[:3]), ["cpu"] * 2)
    got = fda_source_to_target(frames, t_frames, 0.1)
    assert isinstance(got, FrameBands) and got.starts == frames.starts
    want = fda_source_to_target(src, tgt, 0.1)
    assert torch.equal(got.gather(), want)


def test_da_step_with_minent_and_fda_on_bands_equals_one_device_and_jax(
        jax_step, trees):
    """MinEnt (banded logits) and FDA (frames gathered on the first band's
    device, restyled, cut again) in each variant on 2 height bands."""
    from test_torch_adversarial import da_runs, held_to_one_device_and_jax

    name, want, (want_gen, want_dis) = jax_step
    variant, grl_alpha = VARIANTS[name]
    runs = da_runs(trees, (0, 2), variant=variant, grl_alpha=grl_alpha,
                   lambda_ent=LAMBDA_ENT, fda_beta=FDA_BETA)
    assert "loss_entropy" in runs[2][0]
    held_to_one_device_and_jax(runs, 2, want, want_gen, want_dis,
                               LIMITS[name])
