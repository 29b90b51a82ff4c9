"""The port's losses against the JAX package's, on the same numpy logits
(NCHW here, NHWC there) and labels: rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.ops import losses as jax_losses
from rtsds_tpu_torch.ops import losses

SHAPE = (2, 19, 37, 53)  # N, C, H, W


def _case(seed, ignored_share=0.2):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal(SHAPE)).astype(np.float32)
    labels = rng.integers(0, 19, (SHAPE[0], *SHAPE[2:])).astype(np.int32)
    labels[rng.random(labels.shape) < ignored_share] = 19
    return logits, labels


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("ignore_index,ignored_share", [
    (19, 0.2), (19, 1.0), (None, 0.0), (5, 0.0)])
def test_cross_entropy_matches_jax(ignore_index, ignored_share):
    logits, labels = _case(0, ignored_share)
    want = float(jax_losses.cross_entropy(_nhwc(logits), jnp.asarray(labels),
                                          ignore_index))
    got = losses.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), ignore_index)
    assert got.dtype == torch.float32 and torch.isfinite(got)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    if ignored_share == 1.0:
        assert float(got) == 0.0  # not NaN: the count is clamped to 1


def test_three_head_loss_matches_jax():
    heads = [_case(s)[0] for s in (1, 2, 3)]
    _, labels = _case(4)
    want = float(jax_losses.segmentation_loss(
        tuple(_nhwc(h) for h in heads), jnp.asarray(labels), 19))
    got = losses.segmentation_loss(tuple(torch.from_numpy(h) for h in heads),
                                   torch.from_numpy(labels), 19)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # a single head, and a tuple with absent aux heads
    one = losses.segmentation_loss(torch.from_numpy(heads[0]),
                                   torch.from_numpy(labels))
    none = losses.segmentation_loss((torch.from_numpy(heads[0]), None, None),
                                    torch.from_numpy(labels))
    want_one = float(jax_losses.segmentation_loss(_nhwc(heads[0]),
                                                  jnp.asarray(labels)))
    np.testing.assert_allclose([float(one), float(none)], [want_one] * 2,
                               rtol=1e-5)


def test_bf16_logits_are_promoted():
    logits, labels = _case(5)
    got = losses.cross_entropy(torch.from_numpy(logits).bfloat16(),
                               torch.from_numpy(labels), 19)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("target", [0.0, 1.0, "array"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bce_with_logits_matches_jax(target, dtype):
    """The discriminator's loss, rtol 1e-6, and its gradient, rtol 1e-6
    and atol 1e-6 of its largest entry (entries where the terms of
    ``sigmoid(x) - y`` cancel keep only absolute precision)."""
    rng = np.random.default_rng(12)
    logits = (4 * rng.standard_normal((4, 1, 3, 5))).astype(dtype)
    if target == "array":
        target = rng.random(logits.shape).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want, want_grad = jax.value_and_grad(jax_losses.bce_with_logits)(
            jnp.asarray(logits), target)
    x = torch.from_numpy(logits).requires_grad_()
    got = losses.bce_with_logits(
        x, torch.from_numpy(target) if isinstance(target, np.ndarray)
        else target)
    got.backward()
    assert got.dtype == x.dtype and got.ndim == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-6,
                               atol=1e-6 * np.abs(want_grad).max())


def test_bce_with_logits_promotes_bf16():
    logits = torch.tensor([[-3.0, 0.5], [2.0, 40.0]]).bfloat16()
    got = losses.bce_with_logits(logits, 1.0)
    assert got.dtype == torch.float32 and torch.isfinite(got)


def test_make_criterion_matches_jax():
    logits, labels = _case(13)
    for cfg, args in (
            ({"name": "CrossEntropy", "ignore_index": 19},
             (logits, labels)),
            ({"name": "CrossEntropy"}, (logits, np.minimum(labels, 18))),
            ({"name": "BCEWithLogits"}, (logits[:, :1], 1.0))):
        want = jax_losses.make_criterion(cfg)(
            _nhwc(args[0]), jnp.asarray(args[1]) if isinstance(
                args[1], np.ndarray) else args[1])
        got = losses.make_criterion(cfg)(
            torch.from_numpy(args[0]), torch.from_numpy(args[1])
            if isinstance(args[1], np.ndarray) else args[1])
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=cfg["name"])
    for make in (jax_losses.make_criterion, losses.make_criterion):
        with pytest.raises(ValueError, match="Invalid loss name. Please "
                                             "select CrossEntropy or "
                                             "BCEWithLogits"):
            make({"name": "Dice"})


@pytest.mark.parametrize("ignored_share", [0.2, 1.0])
def test_three_head_loss_gradient_matches_jax(ignored_share):
    """The gradient the train step backpropagates, per head: rtol 1e-5;
    all zeros, not NaN, on an all-ignored batch."""
    heads = [_case(s, ignored_share)[0] for s in (8, 9, 10)]
    _, labels = _case(11, ignored_share)
    want = jax.grad(lambda hs: jax_losses.segmentation_loss(
        hs, jnp.asarray(labels), 19))(tuple(_nhwc(h) for h in heads))
    got = [torch.from_numpy(h).requires_grad_() for h in heads]
    losses.segmentation_loss(tuple(got), torch.from_numpy(labels),
                             19).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-5, atol=1e-9)
        if ignored_share == 1.0:
            assert not g.grad.any()
