"""The port's resize, blur, augmentation and per-batch transform against the
JAX package's, on the same numpy inputs.  Augmentation draws differ
between a jax.random key and a torch.Generator, so the port's
``apply_augment`` gets the draws the JAX function took from its key.
Images atol 1e-4 on the 0..255 pixel scale (antialiased downscales
included: torch's and jax.image.resize's triangle filters agree to ~5e-5
here), labels exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtsds_tpu.data.native import rgb_to_train_ids as host_remap
from rtsds_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from rtsds_tpu.ops.augment import make_augment_fn as jax_make_augment
from rtsds_tpu.ops.blur import gaussian_blur as jax_blur
from rtsds_tpu.ops.preprocess import make_transform as jax_make_transform
from rtsds_tpu.ops.resize import clamp_labels as jax_clamp
from rtsds_tpu.ops.resize import resize_bilinear as jax_resize
from rtsds_tpu.ops.resize import resize_labels_nearest as jax_nearest
from rtsds_tpu_torch.config import load_config
from rtsds_tpu_torch.ops import augment as augment_mod
from rtsds_tpu_torch.ops.augment import (
    AugmentConfig, AugmentDraws, apply_augment, draw, make_augment_fn)
from rtsds_tpu_torch.ops.blur import gaussian_blur
from rtsds_tpu_torch.ops.preprocess import (
    IMAGENET_MEAN, IMAGENET_STD, make_transform)
from rtsds_tpu_torch.ops.resize import (
    clamp_labels, resize_images, resize_labels_nearest)
from rtsds_tpu_torch.utils.colors import class_colors_for_remap

SHAPE = (2, 37, 53)


def _images(seed, shape=SHAPE):
    return np.random.default_rng(seed).uniform(
        0, 255, (*shape, 3)).astype(np.float32)


def _labels(seed, shape=SHAPE):
    labels = np.random.default_rng(seed).integers(0, 19, shape)
    labels[:, :2] = 255
    return labels.astype(np.int32)


@pytest.mark.parametrize("kernel,sigma", [((5, 9), 0.7), ((3, 3), 2.5),
                                          ((9, 5), 4.9)])
def test_blur_matches_jax(kernel, sigma):
    x = _images(0)
    want = np.asarray(jax_blur(jnp.asarray(x), kernel, sigma))
    got = gaussian_blur(torch.from_numpy(x), kernel, sigma)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    single = gaussian_blur(torch.from_numpy(x[0]), kernel, sigma)
    np.testing.assert_allclose(single.numpy(), want[0], rtol=0, atol=1e-4)


def _jax_draws(cfg: JaxAugmentConfig, key) -> AugmentDraws:
    """The draws ``rtsds_tpu.ops.augment.make_augment_fn`` takes from
    ``key``: the gate, the blur sigma and the flip coin."""
    k_gate, k_blur, k_flip, _, _ = jax.random.split(key, 5)
    lo, hi = cfg.blur_sigma
    return AugmentDraws(
        gate=bool(jax.random.uniform(k_gate, ()) < cfg.apply_p),
        sigma=float(jax.random.uniform(k_blur, (), minval=lo, maxval=hi)),
        flip=bool(jax.random.uniform(k_flip, ()) < cfg.flip_p))


def _keys_covering_every_branch(cfg):
    """Seeds whose draws give each (gate, flip) combination."""
    found = {}
    for seed in range(64):
        d = _jax_draws(cfg, jax.random.key(seed))
        found.setdefault((d.gate, d.flip), seed)
        if len(found) == 4:
            return [found[k] for k in sorted(found)]
    raise AssertionError(f"draws cover only {sorted(found)}")


@pytest.mark.parametrize("flip_labels", [True, False])
def test_gated_augment_matches_jax_with_its_draws(flip_labels):
    jcfg = JaxAugmentConfig(flip_labels=flip_labels)
    cfg = AugmentConfig(flip_labels=flip_labels)
    jax_augment = jax.jit(jax_make_augment(jcfg))
    x, y = _images(1), _labels(2)
    for seed in _keys_covering_every_branch(jcfg):
        key = jax.random.key(seed)
        want_x, want_y = jax_augment(key, jnp.asarray(x), jnp.asarray(y))
        got_x, got_y = apply_augment(cfg, _jax_draws(jcfg, key),
                                     torch.from_numpy(x),
                                     torch.from_numpy(y))
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_draws_come_from_the_generator():
    cfg = AugmentConfig()
    a = draw(cfg, torch.Generator().manual_seed(5))
    assert a == draw(cfg, torch.Generator().manual_seed(5))
    assert 0.1 <= a.sigma <= 5.0
    seen = {draw(cfg, torch.Generator().manual_seed(s)).gate
            for s in range(16)}
    assert seen == {True, False}
    x, y = torch.from_numpy(_images(3)), torch.from_numpy(_labels(3))
    out = make_augment_fn(cfg)(torch.Generator().manual_seed(5), x, y)
    want = apply_augment(cfg, a, x, y)
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def test_augment_config_from_config():
    cfg = AugmentConfig.from_config(load_config())
    assert cfg == AugmentConfig(apply_p=0.5, blur_kernel=(5, 9),
                                blur_sigma=(0.1, 5.0), flip_p=0.5)
    for extra in ({"ColorJitter": {"brightness": 0.5}},
                  {"RandomZoom": {"max": 1.5}}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            AugmentConfig.from_config(
                load_config(overrides={"augmentation": extra}))


def test_resize_identity_is_exact():
    x = _images(4)
    want = np.asarray(jax_resize(jnp.asarray(x), SHAPE[1:], antialias=True))
    got = resize_images(torch.from_numpy(x), SHAPE[1:], antialias=True)
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(got.numpy(), want)


def test_antialiased_downscale_matches_jax():
    x = _images(5, (2, 64, 96))
    for size in ((32, 48), (25, 40)):
        want = np.asarray(jax_resize(jnp.asarray(x), size, antialias=True))
        got = resize_images(torch.from_numpy(x), size, antialias=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("size", [(37, 53), (20, 31), (74, 100)])
def test_nearest_label_resize_and_clamp_match_jax(size):
    y = _labels(6)
    want = np.asarray(jax_clamp(jax_nearest(jnp.asarray(y), size), 0, 19))
    got = clamp_labels(resize_labels_nearest(torch.from_numpy(y), size))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    single = resize_labels_nearest(torch.from_numpy(y[0]), size)
    np.testing.assert_array_equal(single.numpy(),
                                  np.asarray(jax_nearest(jnp.asarray(y[0]),
                                                         size)))
    chan = resize_labels_nearest(torch.from_numpy(y[..., None]), size)
    np.testing.assert_array_equal(chan.numpy()[..., 0], np.asarray(
        jax_nearest(jnp.asarray(y), size)))


def _pixels(normalized):
    """Normalized frames back on the 0..255 pixel scale the tolerance is
    stated on (the normalization divides by std ~0.22, and the training
    recipe does not divide by 255 first)."""
    return (np.asarray(normalized, np.float64) * np.asarray(IMAGENET_STD)
            + np.asarray(IMAGENET_MEAN))


def _rgb_labels(seed):
    rng = np.random.default_rng(seed)
    table = class_colors_for_remap()
    rgb = table[rng.integers(0, 19, SHAPE)]
    rgb[rng.random(SHAPE) < 0.1] = (1, 2, 3)
    return rgb.astype(np.uint8)


@pytest.mark.parametrize("rgb_labels", [False, True])
@pytest.mark.parametrize("size,antialias", [((37, 53), False),
                                            ((30, 40), True)])
def test_make_transform_matches_jax(rgb_labels, size, antialias,
                                   monkeypatch):
    images = _images(7).astype(np.uint8)
    if rgb_labels:
        labels = _rgb_labels(8)
        host = np.stack([host_remap(lbl) for lbl in labels])
    else:
        labels = host = _labels(8)
    jcfg = JaxAugmentConfig()
    key = jax.random.key(_keys_covering_every_branch(jcfg)[-1])  # gate+flip
    want_x, want_y = jax.jit(jax_make_transform(
        size, 19, antialias=antialias, augment_cfg=jcfg))(
            jnp.asarray(images), jnp.asarray(host), key)

    transform = make_transform(size, 19, antialias=antialias,
                               augment_cfg=AugmentConfig(),
                               decode_label_colors=rgb_labels)
    draws = _jax_draws(jcfg, key)

    monkeypatch.setattr(augment_mod, "draw", lambda cfg, generator: draws)
    got_x, got_y = transform(torch.from_numpy(images),
                             torch.from_numpy(labels), torch.Generator())
    assert got_x.dtype == torch.float32 and got_y.dtype == torch.int32
    np.testing.assert_allclose(_pixels(got_x.numpy()), _pixels(want_x),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    assert int(got_y.max()) == 19  # void clamps to the ignored id


def test_transform_without_augment_needs_no_generator():
    images, labels = _images(9).astype(np.uint8), _labels(9)
    want_x, want_y = jax_make_transform(SHAPE[1:], 19, antialias=False)(
        jnp.asarray(images), jnp.asarray(labels))
    got_x, got_y = make_transform(SHAPE[1:], 19, antialias=False)(
        torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(_pixels(got_x.numpy()), _pixels(want_x),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    with pytest.raises(ValueError, match="Generator"):
        make_transform(SHAPE[1:], augment_cfg=AugmentConfig())(
            torch.from_numpy(images), torch.from_numpy(labels))
