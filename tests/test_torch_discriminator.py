"""The port's discriminators, gradient reversal and adaptive pooling against
the JAX package's, on the same numpy inputs and the same Flax weights
(through the weight bridge, ``strict=True``).

Tolerances: discriminator outputs and input gradients in float32 rtol 1e-5
/ atol 1e-6; the gradient reversal exactly; adaptive pooling rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.models import discriminator as flax_dis
from rtsds_tpu.ops.pool import adaptive_avg_pool2d as jax_pool
from rtsds_tpu_torch.models import discriminator
from rtsds_tpu_torch.models.pretrained import (
    load_flax_variables, state_dict_from_flax)
from rtsds_tpu_torch.ops.pool import adaptive_avg_pool2d

MODELS = {"tiny": (flax_dis.TinyDomainDiscriminator,
                   discriminator.TinyDomainDiscriminator),
          "fc": (flax_dis.DomainDiscriminator,
                 discriminator.DomainDiscriminator)}


def _softmax_maps(seed, shape=(2, 64, 96, 19)):
    """NHWC softmax maps, as the discriminators see them."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(3 * x), axis=-1))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _flax_pair(name, key, **kwargs):
    flax_cls, torch_cls = MODELS[name]
    flax_model = flax_cls(num_classes=19, **kwargs)
    variables = jax.tree_util.tree_map(
        np.asarray, flax_model.init(key, jnp.zeros((2, 64, 96, 19))))
    return flax_model, variables, torch_cls(num_classes=19, **kwargs)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_discriminator_matches_flax(name, key):
    flax_model, variables, model = _flax_pair(name, key)
    load_flax_variables(model, variables)
    assert set(state_dict_from_flax(variables)) == set(model.state_dict())
    x = _softmax_maps(1)
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.shape == (2, 1, 1, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_discriminator_input_gradient_matches_flax(name, key):
    """The gradient the generator receives through D."""
    kwargs = {"with_grl": True, "lambda_": 0.3} if name == "fc" else {}
    flax_model, variables, model = _flax_pair(name, key, **kwargs)
    load_flax_variables(model, variables)
    x = _softmax_maps(2, (2, 32, 48, 19))
    weights = np.random.default_rng(3).normal(size=(2, 1, 1, 1))
    want = jax.grad(lambda v: jnp.sum(
        flax_model.apply(variables, v) * weights))(jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    (model(xt) * torch.from_numpy(weights.astype(np.float32))).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("alpha", [0.1, 1.0, 2.5])
def test_gradient_reversal_matches_jax_vjp_exactly(alpha):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 7)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda v: flax_dis.gradient_reversal(v, alpha),
                       jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = discriminator.gradient_reversal(xt, alpha)
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(out))
    yt.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


def test_upsampler_matches_flax(key):
    flax_model = flax_dis.UpSampler(num_classes=19)
    x = _softmax_maps(5, (1, 6, 10, 19))
    variables = jax.tree_util.tree_map(
        np.asarray, flax_model.init(key, jnp.asarray(x)))
    model = load_flax_variables(discriminator.UpSampler(19), variables)
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.shape == (1, 19, 48, 80)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)


def test_bridge_rejects_a_discriminator_tree_missing_a_layer(key):
    _, variables, model = _flax_pair("fc", key)
    del variables["params"]["conv3"]
    with pytest.raises(KeyError, match="conv3"):
        load_flax_variables(model, variables)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((37, 53), (16, 24)),     # odd ratios, overlapping windows
    ((64, 96), (64, 128)),    # a width that grows: v2's source -> target
    ((45, 80), (32, 64)),     # 720x1280 -> 512x1024 over 16
    ((9, 7), (4, 5)),
])
def test_adaptive_avg_pool_matches_jax(in_hw, out_hw):
    """Integer-valued inputs: the JAX pool sums through a float32
    summed-area table, whose rounding grows with the map (4e-6 absolute
    at 64x96 on normal samples); on integers it is exact, so the
    comparison holds the windows."""
    x = np.random.default_rng(6).integers(-8, 9, (2, *in_hw, 3)).astype(
        np.float32)
    want = np.asarray(jax_pool(jnp.asarray(x), out_hw))
    got = adaptive_avg_pool2d(_nchw(x), out_hw)
    assert got.shape == (2, 3, *out_hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5)


def test_adaptive_avg_pool_is_the_identity_at_the_same_size():
    x = torch.rand((2, 19, 8, 12))
    assert adaptive_avg_pool2d(x, (8, 12)) is x
    chw = adaptive_avg_pool2d(x[0], (4, 6))
    torch.testing.assert_close(chw, adaptive_avg_pool2d(x, (4, 6))[0])
