"""The port's schedules and optimizers against the JAX package's (optax),
on the same numpy parameters and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtsds_tpu.train.optim import make_optimizer as jax_make_optimizer
from rtsds_tpu.utils import schedules as jax_schedules
from rtsds_tpu_torch.train import optim
from rtsds_tpu_torch.utils import schedules

MAX_ITER = 12


def _steps():
    return np.arange(0, 2 * MAX_ITER + 1)


@pytest.mark.parametrize("lr_decay_iter", [1, 3])
@pytest.mark.parametrize("warmup", [0, 4])
def test_poly_schedule_matches_jax(lr_decay_iter, warmup):
    ours = schedules.with_warmup(
        schedules.poly_lr_schedule(0.01, MAX_ITER, 0.9, lr_decay_iter),
        warmup)
    theirs = jax_schedules.with_warmup(
        jax_schedules.poly_lr_schedule(0.01, MAX_ITER, 0.9, lr_decay_iter),
        warmup)
    want = [float(theirs(jnp.asarray(s))) for s in _steps()]
    got = [ours(int(s)) for s in _steps()]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got[0] == pytest.approx(0.01 / max(warmup, 1))


@pytest.mark.parametrize("power", [0.9, 0.05])
@pytest.mark.parametrize("warmup", [0, 5])
def test_poly_epoch_schedule_matches_jax(power, warmup):
    """The v1 discriminator's per-epoch decay over 4 epochs of 6 steps:
    rtol 1e-7 (the JAX schedule computes in float32)."""
    ours = schedules.with_warmup(
        schedules.poly_epoch_schedule(1e-4, 4, power, 6), warmup)
    theirs = jax_schedules.with_warmup(
        jax_schedules.poly_epoch_schedule(1e-4, 4, power, 6), warmup)
    steps = np.arange(0, 24)
    want = [float(theirs(jnp.asarray(s))) for s in steps]
    got = [ours(int(s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-7)
    assert got[5] == pytest.approx(got[0] * max(warmup, 1))
    assert got[6] < got[5]  # epoch 1 starts at step 6


@pytest.mark.parametrize("lambda_", [0.1, 0.25])
def test_lambda_adv_schedule_matches_jax(lambda_):
    """v2's ``max(lambda, 10 lambda - 0.001 epoch)`` over 1200 steps of 100
    per epoch: rtol 1e-7."""
    ours = schedules.lambda_adv_schedule(lambda_, 100)
    theirs = jax_schedules.lambda_adv_schedule(lambda_, 100)
    steps = np.arange(0, 1200, 7)
    want = [float(theirs(jnp.asarray(s))) for s in steps]
    got = [ours(int(s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-7)
    assert got[0] == pytest.approx(10 * lambda_)


def test_lambda_adv_schedule_at_its_floor():
    """Where ``10 lambda - 0.001 epoch`` falls to lambda (epoch 18 for
    lambda 0.002) the JAX schedule loses digits to cancellation: it
    computes in float32, and measured up to 4.6e-7 relative from the exact
    value here.  So the port is held to the exact float64 formula, and to
    JAX at rtol 1e-6."""
    ours = schedules.lambda_adv_schedule(0.002, 1)
    theirs = jax_schedules.lambda_adv_schedule(0.002, 1)
    steps = range(0, 30)
    got = [ours(s) for s in steps]
    assert got == [max(0.002, 0.02 - 0.001 * s) for s in steps]
    np.testing.assert_allclose(got, [float(theirs(jnp.asarray(s)))
                                     for s in steps], rtol=1e-6)
    assert got[18] == got[29] == 0.002


def _toy(seed):
    """A param tree with a backbone and a head, and 3 steps of grads."""
    rng = np.random.default_rng(seed)
    shapes = {"context_path": (4, 3), "head": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (2 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name,wd,clip,mult", [
    ("Adam", 0.0, 0.0, 0.0),
    ("Adam", 0.01, 0.0, 0.0),
    ("Adam", 0.0, 1.5, 0.0),
    ("Adam", 0.01, 1.5, 10.0),
    ("SGD", 0.0, 0.0, 0.0),
    ("SGD", 0.01, 1.5, 10.0),   # the SGD chain takes no weight decay
])
def test_optimizer_matches_optax(name, wd, clip, mult):
    params, grads = _toy(0)
    schedule = jax_schedules.poly_lr_schedule(0.1, 5, 0.9)

    multipliers = None
    if mult:
        multipliers = {"context_path": 1.0, "head": mult}
    tx = jax_make_optimizer(name, schedule, weight_decay=wd, momentum=0.9,
                            lr_multipliers=multipliers, grad_clip=clip)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}
    groups = [{"params": [tparams["context_path"]], "lr_mult": 1.0},
              {"params": [tparams["head"]], "lr_mult": mult or 1.0}]
    opt = optim.make_optimizer(
        name, groups, schedules.poly_lr_schedule(0.1, 5, 0.9),
        weight_decay=wd, momentum=0.9, grad_clip=clip)
    for g in grads:
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    assert opt.count == 3
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-5, atol=1e-7)


def test_clip_by_global_norm_only_shrinks():
    a = torch.nn.Parameter(torch.zeros(2))
    a.grad = torch.tensor([3.0, 4.0])  # norm 5
    optim.clip_by_global_norm([a], 10.0)
    assert a.grad.tolist() == [3.0, 4.0]
    optim.clip_by_global_norm([a], 1.0)
    np.testing.assert_allclose(a.grad.numpy(), [0.6, 0.8], rtol=1e-6)


def test_head_param_groups_split_the_backbone():
    from rtsds_tpu_torch.models.bisenet import BiSeNet

    model = BiSeNet()
    one = optim.head_param_groups(model, 0.0)
    assert len(one) == 1 and len(one[0]["params"]) == len(
        list(model.parameters()))
    backbone, head = optim.head_param_groups(model, 10.0)
    assert len(backbone["params"]) == len(
        list(model.context_path.parameters()))
    assert head["lr_mult"] == 10.0
    assert len(backbone["params"]) + len(head["params"]) == len(
        list(model.parameters()))


def test_state_dict_round_trip_keeps_the_count():
    p = torch.nn.Parameter(torch.ones(3))
    opt = optim.make_optimizer("Adam", [p], 0.1)
    p.grad = torch.ones(3)
    opt.step()
    q = torch.nn.Parameter(torch.ones(3))
    other = optim.make_optimizer("Adam", [q], 0.1)
    other.load_state_dict(opt.state_dict())
    assert other.count == 1
    with pytest.raises(ValueError, match="Adam or SGD"):
        optim.make_optimizer("RMSprop", [p], 0.1)
