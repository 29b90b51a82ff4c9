"""One DeepLabV2 train step of the port against the JAX package's, in
float64, on a thin ([1, 1, 1, 1]) model from one Flax tree.

The supervised step runs under Adam, SGD (at batch 1, which DeepLab trains
at), Adam with weight decay, and Adam with ``head_lr_mult`` 10, each with
the batch-norm affines frozen as both trainers freeze them.  The loss and
every tensor after the step match at rtol 1e-6 / atol 1e-10; the frozen
affines stay bit-for-bit still under SGD and under Adam without weight
decay, and under Adam with weight decay they move by the decay alone, as
the JAX chain moves them (it zeroes the frozen updates before
``add_decayed_weights``).  One DA v1 step with a thin DeepLab generator and
the Tiny discriminator matches at the limits test_torch_adversarial.py
holds v1 to: losses rtol 1e-8, tensors rtol 1e-6 / atol 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtsds_tpu.models.deeplabv2 import DeepLabV2 as FlaxDeepLab
from rtsds_tpu.models.deeplabv2 import frozen_bn_mask, lr_multiplier_mask
from rtsds_tpu.models.discriminator import (
    TinyDomainDiscriminator as FlaxTinyDiscriminator)
from rtsds_tpu.train.adversarial import (
    make_adversarial_step as jax_adversarial_step)
from rtsds_tpu.train.optim import make_optimizer as jax_make_optimizer
from rtsds_tpu.train.state import TrainState as JaxTrainState
from rtsds_tpu.train.supervised import make_train_step as jax_train_step
from rtsds_tpu_torch.models.deeplabv2 import DeepLabV2, frozen_bn_parameters
from rtsds_tpu_torch.models.discriminator import TinyDomainDiscriminator
from rtsds_tpu_torch.models.pretrained import (
    load_flax_variables, state_dict_from_flax)
from rtsds_tpu_torch.train.adversarial import make_adversarial_step
from rtsds_tpu_torch.train.optim import head_param_groups, make_optimizer
from rtsds_tpu_torch.train.state import TrainState
from rtsds_tpu_torch.train.supervised import make_train_step
from test_torch_deeplab import THIN, flax_tree

SIZE = (33, 65)
LR = 0.01
# name: (optimizer, weight decay, head_lr_mult, batch)
CASES = {"adam": ("Adam", 0.0, 0.0, 2), "sgd_b1": ("SGD", 0.0, 0.0, 1),
         "adam_weight_decay": ("Adam", 0.05, 0.0, 2),
         "adam_head_lr_mult": ("Adam", 0.0, 10.0, 2)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _batch(n, size=SIZE, seed=3):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, *size, 3))
    labels = rng.integers(0, 20, size=(n, *size)).astype(np.int32)
    return images, labels


def _port_model(variables) -> DeepLabV2:
    """A float64 thin DeepLabV2 holding ``variables`` exactly."""
    model = DeepLabV2(layers=THIN).double()
    own = model.state_dict()
    for k, v in state_dict_from_flax(variables).items():
        own[k].copy_(v)
    return model


@pytest.fixture(scope="module")
def tree():
    return _f64(flax_tree(THIN, (1, *SIZE, 3), seed=7))


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_step(request, tree):
    """One float64 JAX supervised step of the case: the metrics and the
    variables after it."""
    name, wd, head, n = CASES[request.param]
    images, labels = _batch(n)
    tx = jax_make_optimizer(
        name, LR, weight_decay=wd, momentum=0.9, frozen_mask=frozen_bn_mask,
        lr_multipliers=(lambda p: lr_multiplier_mask(p, head)) if head
        else None)
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               tree["batch_stats"]),
            opt_state=tx.init(params),
            apply_fn=FlaxDeepLab(num_classes=19, layers=THIN).apply, tx=tx)
        new, metrics = jax_train_step(ignore_index=19, donate=False)(
            state, jnp.asarray(images), jnp.asarray(labels))
        metrics = {k: np.asarray(v) for k, v in metrics.items()}
        after = _f64({"params": new.params, "batch_stats": new.batch_stats})
    return request.param, metrics, after


def test_supervised_step_matches_jax_in_float64(jax_step, tree):
    case, want, after = jax_step
    name, wd, head, n = CASES[case]
    images, labels = _batch(n)
    model = _port_model(tree)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    frozen = frozen_bn_parameters(model)
    state = TrainState(model, make_optimizer(
        name, head_param_groups(model, head), LR, weight_decay=wd,
        momentum=0.9, frozen=frozen))
    got = make_train_step(19)(state, torch.from_numpy(images),
                              torch.from_numpy(labels))
    assert state.step == 1
    np.testing.assert_allclose(float(got["train_loss"]),
                               float(want["train_loss"]), rtol=1e-6)
    assert int(got["correct"]) == int(want["correct"])

    new = model.state_dict()
    for k, v in state_dict_from_flax(after).items():
        np.testing.assert_allclose(new[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-10, err_msg=k)
    names = {id(p): k for k, p in model.named_parameters()}
    frozen_keys = [names[id(p)] for p in frozen]
    moved = [k for k in frozen_keys if not torch.equal(new[k], before[k])]
    if name == "Adam" and wd:
        # the decay moves every nonzero one (the BN biases start at 0)
        nonzero = [k for k in frozen_keys if before[k].abs().sum() > 0]
        assert nonzero and moved == nonzero
    else:
        assert moved == []
        # the JAX step keeps them exactly still too
        jax_after = state_dict_from_flax(after)
        assert all(torch.equal(jax_after[k], before[k]) for k in frozen_keys)
    # the unfrozen parameters did train
    assert not torch.equal(new["layer6.conv2d_list.0.weight"],
                           before["layer6.conv2d_list.0.weight"])


def test_deeplab_trains_at_batch_one():
    model = DeepLabV2(layers=THIN)
    state = TrainState(model, make_optimizer("SGD", model.parameters(), LR))
    images, labels = _batch(1, (32, 48))
    m = make_train_step(19)(state, torch.from_numpy(images).float(),
                            torch.from_numpy(labels))
    assert state.step == 1 and torch.isfinite(m["train_loss"])


LAMBDA, ITERATIONS, LR_G, LR_D = 0.1, 5, 0.01, 0.02
SRC, TGT = (64, 96), (64, 128)


@pytest.fixture(scope="module")
def jax_da_step(tree):
    """One float64 JAX DA v1 step with the thin DeepLab generator (BN
    affines frozen) and the Tiny discriminator, SGD on both."""
    rng = np.random.default_rng(8)
    src = rng.normal(size=(2, *SRC, 3))
    tgt = rng.normal(size=(2, *TGT, 3))
    labels = rng.integers(0, 20, size=(2, *SRC)).astype(np.int32)
    dis_vars = _f64(dict(FlaxTinyDiscriminator(num_classes=19).init(
        jax.random.key(1), jnp.zeros((2, *TGT, 19)))))

    def state(variables, apply_fn, tx):
        return JaxTrainState(step=jnp.zeros((), jnp.int32),
                             params=variables["params"],
                             batch_stats=variables.get("batch_stats"),
                             opt_state=tx.init(variables["params"]),
                             apply_fn=apply_fn, tx=tx)

    with jax.enable_x64(True):
        gen_vars = jax.tree_util.tree_map(jnp.asarray, tree)
        d_vars = jax.tree_util.tree_map(jnp.asarray, dis_vars)
        step = jax_adversarial_step(LAMBDA, ITERATIONS, epochs=1,
                                    ignore_index=19, variant="v1",
                                    donate=False)
        gen, dis, metrics = step(
            state(gen_vars, FlaxDeepLab(num_classes=19, layers=THIN).apply,
                  jax_make_optimizer("SGD", LR_G, momentum=0.0,
                                     frozen_mask=frozen_bn_mask)),
            state(d_vars, FlaxTinyDiscriminator(num_classes=19).apply,
                  optax.sgd(LR_D)),
            jnp.asarray(src), jnp.asarray(labels), jnp.asarray(tgt))
        metrics = {k: np.asarray(v) for k, v in metrics.items()}
        after = (_f64({"params": gen.params, "batch_stats": gen.batch_stats}),
                 _f64({"params": dis.params}))
    return (src, labels, tgt), dis_vars, metrics, after


def test_da_v1_step_with_a_deeplab_generator_matches_jax(jax_da_step, tree):
    (src, labels, tgt), dis_vars, want, (want_gen, want_dis) = jax_da_step
    gen_model = _port_model(tree)
    dis_model = load_flax_variables(TinyDomainDiscriminator().double(),
                                    dis_vars)
    before = {k: v.clone() for k, v in gen_model.state_dict().items()}
    gen = TrainState(gen_model, make_optimizer(
        "SGD", gen_model.parameters(), LR_G, momentum=0.0,
        frozen=frozen_bn_parameters(gen_model)))
    dis = TrainState(dis_model, make_optimizer(
        "SGD", dis_model.parameters(), LR_D, momentum=0.0))
    got = make_adversarial_step(LAMBDA, ITERATIONS, 1, 19, "v1")(
        gen, dis, torch.from_numpy(src), torch.from_numpy(labels),
        torch.from_numpy(tgt))
    for k in ("loss_gen_source", "loss_adversarial", "loss_disc_source",
              "loss_disc_target"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    assert int(got["correct"]) == int(want["correct"])
    for model, tree_after, net in ((gen_model, want_gen, "G"),
                                   (dis_model, want_dis, "D")):
        new = model.state_dict()
        for k, v in state_dict_from_flax(tree_after).items():
            np.testing.assert_allclose(new[k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-10, err_msg=f"{net} {k}")
    new = gen_model.state_dict()
    for p in frozen_bn_parameters(gen_model):
        k = next(n for n, q in gen_model.named_parameters() if q is p)
        assert torch.equal(new[k], before[k]), k
