"""The port's resize, blur, augmentation and per-batch transform against the
JAX package's, on the same numpy inputs.  Augmentation draws differ
between a jax.random key and a torch.Generator, so the port's
``apply_augment`` gets the draws the JAX function took from its key.
Images atol 1e-4 on the 0..255 pixel scale (antialiased downscales
included: torch's and jax.image.resize's triangle filters agree to ~5e-5
here), labels exact."""

import dataclasses

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
    for extra, fields in (
            ({"ColorJitter": {"brightness": 0.5}},
             {"color_jitter": (0.5, 0.0, 0.0, 0.0)}),
            ({"RandomZoom": {"max": 1.5}}, {"zoom_max": 1.5, "zoom_p": 0.5}),
            ({"ColorJitter": {"brightness": 0.2, "contrast": 0.3,
                              "saturation": 0.4, "hue": 0.1},
              "RandomZoom": {"max": 2.0, "p": 0.25}},
             {"color_jitter": (0.2, 0.3, 0.4, 0.1), "zoom_max": 2.0,
              "zoom_p": 0.25})):
        config = load_config(overrides={"augmentation": extra})
        cfg = AugmentConfig.from_config(config)
        for name, value in fields.items():
            assert getattr(cfg, name) == value, name
        # the JAX package parses the same section into the same fields
        want = JaxAugmentConfig.from_config(config)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


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


def _jax_full_draws(cfg: JaxAugmentConfig, key, shape) -> AugmentDraws:
    """Every draw ``rtsds_tpu.ops.augment.make_augment_fn`` takes from
    ``key``, ColorJitter's and RandomZoom's too, as JAX computes them (the
    zoom's scale and translations in float32)."""
    k_gate, k_blur, k_flip, k_cj, k_zoom = jax.random.split(key, 5)
    lo, hi = cfg.blur_sigma
    extra = {}
    if cfg.color_jitter is not None:
        keys = jax.random.split(k_cj, 4)
        for name, strength, k in zip(
                ("brightness", "contrast", "saturation"),
                cfg.color_jitter[:3], keys):
            if strength > 0:
                extra[name] = float(jax.random.uniform(
                    k, (), minval=max(0.0, 1 - strength),
                    maxval=1 + strength))
        h = cfg.color_jitter[3]
        if h > 0:
            extra["hue"] = float(jax.random.uniform(keys[3], (), minval=-h,
                                                    maxval=h))
    if cfg.zoom_max is not None:
        n, height, width = shape
        ks, kp, ky, kx = jax.random.split(k_zoom, 4)
        s = jax.random.uniform(ks, (n,), minval=1.0,
                               maxval=float(cfg.zoom_max))
        extra.update(
            zoom_scale=tuple(np.asarray(s).tolist()),
            zoom_fire=tuple(np.asarray(
                jax.random.uniform(kp, (n,)) < cfg.zoom_p).tolist()),
            zoom_ty=tuple(np.asarray(
                -jax.random.uniform(ky, (n,)) * (s - 1.0) * height).tolist()),
            zoom_tx=tuple(np.asarray(
                -jax.random.uniform(kx, (n,)) * (s - 1.0) * width).tolist()))
    return AugmentDraws(
        gate=bool(jax.random.uniform(k_gate, ()) < cfg.apply_p),
        sigma=float(jax.random.uniform(k_blur, (), minval=lo, maxval=hi)),
        flip=cfg.flip_p is not None
        and bool(jax.random.uniform(k_flip, ()) < cfg.flip_p),
        **extra)


ZOOM_SHAPE = (4, 37, 53)


@pytest.mark.parametrize("options", [
    {"color_jitter": (0.4, 0.4, 0.4, 0.1), "blur_kernel": None,
     "flip_p": None},
    {"color_jitter": (0.0, 0.6, 0.0, 0.0)},
    {"zoom_max": 1.8, "zoom_p": 0.5, "blur_kernel": None, "flip_p": None},
    {"color_jitter": (0.4, 0.4, 0.4, 0.1), "zoom_max": 1.5, "zoom_p": 0.5},
])
def test_jitter_and_zoom_match_jax_with_its_draws(options):
    """ColorJitter, RandomZoom and both with blur and flip: the port fed the
    draws JAX took from each key gives JAX's images (rtol 1e-5 / atol 1e-3
    on the 0..255 range) and exactly its labels.  The keys cover the gate
    open and shut, the flip, and zoom coins that fire and that do not."""
    jcfg = JaxAugmentConfig(**options)
    cfg = AugmentConfig(**options)
    jax_augment = jax.jit(jax_make_augment(jcfg))
    x, y = _images(5, ZOOM_SHAPE), _labels(6, ZOOM_SHAPE)
    seen = set()
    for seed in range(12):
        key = jax.random.key(seed)
        draws = _jax_full_draws(jcfg, key, ZOOM_SHAPE)
        seen.add(("gate", draws.gate))
        seen.add(("flip", draws.flip))
        seen.update(("zoom", f) for f in draws.zoom_fire)
        want_x, want_y = jax_augment(key, jnp.asarray(x), jnp.asarray(y))
        got_x, got_y = apply_augment(cfg, draws, torch.from_numpy(x),
                                     torch.from_numpy(y))
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    assert {("gate", True), ("gate", False)} <= seen
    if cfg.zoom_max is not None:
        assert {("zoom", True), ("zoom", False)} <= seen


def test_zoom_geometry_against_scale_and_translate():
    """One zoom against ``jax.image.scale_and_translate(method='linear')``
    on its own, at the window's extremes: the top-left corner (t = 0) and
    the bottom-right one (t = -(s-1) * size)."""
    x, y = _images(7, (2, 37, 53)), _labels(8, (2, 37, 53))
    s = np.float32(1.7)
    ty = np.float32(-(s - 1) * 37)
    tx = np.float32(-(s - 1) * 53)
    draws = AugmentDraws(gate=True, sigma=1.0, flip=False,
                         zoom_scale=(float(s), float(s)),
                         zoom_fire=(True, True), zoom_ty=(0.0, float(ty)),
                         zoom_tx=(0.0, float(tx)))
    cfg = AugmentConfig(blur_kernel=None, flip_p=None, zoom_max=2.0)
    got_x, got_y = apply_augment(cfg, draws, torch.from_numpy(x),
                                 torch.from_numpy(y))
    for i, t in enumerate(((0.0, 0.0), (ty, tx))):
        want = jax.image.scale_and_translate(
            jnp.asarray(x[i]), x[i].shape, (0, 1), jnp.asarray([s, s]),
            jnp.asarray(t, jnp.float32), method="linear")
        np.testing.assert_allclose(got_x[i].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-3)
    # the top-left window's labels: input pixel floor((x + 0.5) / s)
    rows = np.floor((np.arange(37, dtype=np.float32) + 0.5) / s).astype(int)
    cols = np.floor((np.arange(53, dtype=np.float32) + 0.5) / s).astype(int)
    np.testing.assert_array_equal(got_y[0].numpy(), y[0][rows][:, cols])


def test_jitter_and_zoom_draws_come_from_the_generator():
    cfg = AugmentConfig(color_jitter=(0.4, 0.0, 0.4, 0.1), zoom_max=1.5)
    a = draw(cfg, torch.Generator().manual_seed(3), ZOOM_SHAPE)
    assert a == draw(cfg, torch.Generator().manual_seed(3), ZOOM_SHAPE)
    # the first three draws are those of blur + flip alone
    plain = draw(AugmentConfig(), torch.Generator().manual_seed(3))
    assert (a.gate, a.sigma, a.flip) == (plain.gate, plain.sigma, plain.flip)
    assert a.contrast is None and 0.6 <= a.brightness <= 1.4
    assert -0.1 <= a.hue <= 0.1
    assert len(a.zoom_scale) == ZOOM_SHAPE[0]
    for s, ty, tx in zip(a.zoom_scale, a.zoom_ty, a.zoom_tx):
        assert 1.0 <= s <= 1.5
        assert -(s - 1) * ZOOM_SHAPE[1] <= ty <= 0.0
        assert -(s - 1) * ZOOM_SHAPE[2] <= tx <= 0.0
    with pytest.raises(ValueError, match="per sample"):
        draw(cfg, torch.Generator().manual_seed(3))
    x = torch.from_numpy(_images(3, ZOOM_SHAPE))
    y = torch.from_numpy(_labels(3, ZOOM_SHAPE))
    out = make_augment_fn(cfg)(torch.Generator().manual_seed(3), x, y)
    want = apply_augment(cfg, a, x, y)
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
