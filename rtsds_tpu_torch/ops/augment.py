"""Training augmentation on device batches, with explicit random draws.

The recipe of the original training script: a RandomApply gate with
probability ``p`` around GaussianBlur (sigma drawn from a range),
ColorJitter and RandomHorizontalFlip, and the JAX package's RandomZoom (a
random zoom-in, RandomResizedCrop with the aspect fixed).  Geometric
transforms are applied to the labels too, so pixels keep their class
(``flip_labels=False`` flips the image only, as the original script did).
The order is the JAX package's: zoom, blur, jitter, flip.

One batch gets one set of draws from a ``torch.Generator`` on the CPU, so
drawing never waits on the GPU: the gate, the blur sigma, the flip coin and
the jitter factors are the batch's; the zoom draws are per sample.  The
draws are plain Python numbers, and :func:`apply_augment` is a
deterministic function of them.

Under the data axis (``parallel/distributed.py``) a rank holds its slice
of the global batch, and draws as one process would for the whole global
batch: the batch's draws once, the zoom's for every global sample, of
which it keeps those of its own samples (:func:`rank_slice`, at the
positions ``parallel/distributed.py:shard_positions`` gives the loader).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from rtsds_tpu_torch.config import parse_float_list, parse_int_list
from rtsds_tpu_torch.ops.blur import gaussian_blur
from rtsds_tpu_torch.parallel.distributed import (
    rank, shard_positions, world_size)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    apply_p: float = 0.5                      # the RandomApply gate
    blur_kernel: tuple[int, int] | None = (5, 9)
    blur_sigma: tuple[float, float] = (0.1, 5.0)
    flip_p: float | None = 0.5
    # ColorJitter strengths: brightness, contrast, saturation, hue
    color_jitter: tuple[float, float, float, float] | None = None
    flip_labels: bool = True
    # RandomZoom: zoom into a 1/s window, s ~ U[1, zoom_max], at a random
    # position, each sample with probability zoom_p
    zoom_max: float | None = None
    zoom_p: float = 0.5

    @classmethod
    def from_config(cls, config) -> "AugmentConfig":
        aug = config.augmentation
        blur_kernel = blur_sigma = None
        if aug.get("GaussianBlur") is not None:
            gb = aug["GaussianBlur"]
            ks = parse_int_list(gb["kernel_size"])
            blur_kernel = (ks[0], ks[1] if len(ks) > 1 else ks[0])
            sg = parse_float_list(gb["sigma"])
            blur_sigma = (sg[0], sg[-1])
        flip_p = None
        if aug.get("RandomHorizontalFlip") is not None:
            flip_p = float(aug["RandomHorizontalFlip"]["p"])
        cj = None
        if aug.get("ColorJitter") is not None:
            c = aug["ColorJitter"]
            cj = (float(c.get("brightness", 0)), float(c.get("contrast", 0)),
                  float(c.get("saturation", 0)), float(c.get("hue", 0)))
        zoom_max, zoom_p = None, 0.5
        if aug.get("RandomZoom") is not None:
            z = aug["RandomZoom"]
            zoom_max = float(z.get("max", 1.5))
            zoom_p = float(z.get("p", 0.5))
        return cls(apply_p=float(aug.get("p", 0.5)), blur_kernel=blur_kernel,
                   blur_sigma=blur_sigma or (0.1, 5.0), flip_p=flip_p,
                   color_jitter=cj, zoom_max=zoom_max, zoom_p=zoom_p)

    @property
    def zooms(self) -> bool:
        return self.zoom_max is not None and self.zoom_max > 1.0


@dataclasses.dataclass(frozen=True)
class AugmentDraws:
    gate: bool
    sigma: float
    flip: bool
    # ColorJitter, one of each for the batch: the brightness, contrast and
    # saturation factors and the hue shift; None where that strength is 0
    brightness: float | None = None
    contrast: float | None = None
    saturation: float | None = None
    hue: float | None = None
    # RandomZoom, one of each per sample: the scale s, the fire coin, and
    # the translation in pixels, ty in [-(s-1)H, 0] and tx in [-(s-1)W, 0]
    zoom_scale: tuple[float, ...] = ()
    zoom_fire: tuple[bool, ...] = ()
    zoom_ty: tuple[float, ...] = ()
    zoom_tx: tuple[float, ...] = ()


def draw(cfg: AugmentConfig, generator: torch.Generator,
         shape: tuple[int, int, int] | None = None) -> AugmentDraws:
    """One batch's draws: the gate, the blur sigma and the flip coin, then
    the jitter factors (with ColorJitter) and the per-sample zooms (with
    RandomZoom, which needs the batch's ``shape``, (N, H, W)).  Factors
    are uniform in [max(0, 1-s), 1+s] and the hue shift in [-h, h], as
    torchvision and the JAX package draw them."""
    u = torch.rand(3, generator=generator, dtype=torch.float64).tolist()
    lo, hi = cfg.blur_sigma
    extra = {}
    if cfg.color_jitter is not None:
        v = torch.rand(4, generator=generator, dtype=torch.float64).tolist()
        for name, strength, x in zip(("brightness", "contrast", "saturation"),
                                     cfg.color_jitter[:3], v):
            if strength > 0:
                low = max(0.0, 1.0 - strength)
                extra[name] = low + (1.0 + strength - low) * x
        hue = cfg.color_jitter[3]
        if hue > 0:
            extra["hue"] = -hue + 2.0 * hue * v[3]
    if cfg.zooms:
        if shape is None:
            raise ValueError("RandomZoom draws per sample: pass the batch's "
                             "(N, H, W)")
        n, h, w = shape
        v = torch.rand(4, n, generator=generator, dtype=torch.float64)
        scale = 1.0 + (cfg.zoom_max - 1.0) * v[0]
        extra.update(zoom_scale=tuple(scale.tolist()),
                     zoom_fire=tuple((v[1] < cfg.zoom_p).tolist()),
                     zoom_ty=tuple((-v[2] * (scale - 1.0) * h).tolist()),
                     zoom_tx=tuple((-v[3] * (scale - 1.0) * w).tolist()))
    return AugmentDraws(gate=u[0] < cfg.apply_p, sigma=lo + (hi - lo) * u[1],
                        flip=cfg.flip_p is not None and u[2] < cfg.flip_p,
                        **extra)


_LUMA = (0.299, 0.587, 0.114)


def color_jitter(image: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
    """Brightness, contrast, saturation and hue, in that order, on (N, H, W,
    3) float32 RGB in 0..255, with the JAX package's arithmetic: the
    contrast mean per image over H, W and C of the luma-weighted pixel,
    times 3; the hue a YIQ rotation; the result clipped to [0, 255]."""
    luma = torch.tensor(_LUMA, dtype=torch.float32, device=image.device)
    if draws.brightness is not None:
        image = image * draws.brightness
    if draws.contrast is not None:
        mean = (image * luma).mean(dim=(-3, -2, -1), keepdim=True) * 3.0
        image = (image - mean) * draws.contrast + mean
    if draws.saturation is not None:
        gray = (image * luma).sum(dim=-1, keepdim=True)
        image = (image - gray) * draws.saturation + gray
    if draws.hue is not None:
        image = _hue_shift(image, draws.hue)
    return torch.clamp(image, 0.0, 255.0)


def _hue_shift(image: torch.Tensor, shift: float) -> torch.Tensor:
    """A hue rotation by ``shift`` turns, as a rotation of the YIQ chroma
    plane (the JAX package's approximation of an HSV hue shift)."""
    angle = shift * 2.0 * math.pi
    cos, sin = math.cos(angle), math.sin(angle)
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    i = 0.596 * r - 0.274 * g - 0.322 * b
    q = 0.211 * r - 0.523 * g + 0.312 * b
    i, q = i * cos - q * sin, i * sin + q * cos
    return torch.stack([y + 0.956 * i + 0.621 * q,
                        y - 0.272 * i - 0.647 * q,
                        y - 1.106 * i + 1.703 * q], dim=-1)


def _linear_taps(n_out: int, n_in: int, scale: torch.Tensor,
                 shift: torch.Tensor):
    """The two-tap triangle filter of ``jax.image.scale_and_translate(
    method="linear")`` along one axis, per sample: output pixel x samples
    input ``(x + 0.5)/s - t/s - 0.5``.  Returns the (N, n_out) low and
    high tap indices and their weights; a tap outside the input is
    clamped onto the border, which equals dropping it and renormalizing
    the other, and a sample outside [-0.5, n_in - 0.5] weighs nothing."""
    x = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    inv = 1.0 / scale[:, None]
    pos = (x + 0.5) * inv - shift[:, None] * inv - 0.5
    low = torch.floor(pos)
    frac = pos - low
    inside = ((pos >= -0.5) & (pos <= n_in - 0.5)).to(torch.float32)
    lo = low.long().clamp(0, n_in - 1)
    hi = (low.long() + 1).clamp(0, n_in - 1)
    return lo, hi, (1.0 - frac) * inside, frac * inside


def random_zoom(image: torch.Tensor, label: torch.Tensor,
                draws: AugmentDraws):
    """Zoom each fired sample of (N, H, W, C) float ``image`` into its (s,
    ty, tx) window and resample it to full size: the image bilinearly, as
    ``jax.image.scale_and_translate(method="linear")`` for s >= 1, and the
    (N, H, W) labels to the nearest pixel ``floor((x + 0.5 - t)/s)``,
    clamped; samples whose coin did not fire are kept.  Explicit gathers
    in float32 on the image's device."""
    n, h, w = image.shape[:3]
    dev = image.device
    scale = torch.tensor(draws.zoom_scale, dtype=torch.float32, device=dev)
    ty = torch.tensor(draws.zoom_ty, dtype=torch.float32, device=dev)
    tx = torch.tensor(draws.zoom_tx, dtype=torch.float32, device=dev)
    batch = torch.arange(n, device=dev)[:, None]
    y0, y1, wy0, wy1 = _linear_taps(h, h, scale, ty)
    x0, x1, wx0, wx1 = _linear_taps(w, w, scale, tx)
    img = image.to(torch.float32)
    rows = (img[batch, y0] * wy0[..., None, None]
            + img[batch, y1] * wy1[..., None, None]).transpose(1, 2)
    zoomed = (rows[batch, x0] * wx0[..., None, None]
              + rows[batch, x1] * wx1[..., None, None]).transpose(1, 2)
    src_y = torch.floor(
        (torch.arange(h, dtype=torch.float32, device=dev) + 0.5
         - ty[:, None]) / scale[:, None]).long().clamp(0, h - 1)
    src_x = torch.floor(
        (torch.arange(w, dtype=torch.float32, device=dev) + 0.5
         - tx[:, None]) / scale[:, None]).long().clamp(0, w - 1)
    zoomed_label = label[batch, src_y].transpose(1, 2)[batch, src_x]
    zoomed_label = zoomed_label.transpose(1, 2)
    zoomed = zoomed.to(image.dtype)
    fire = torch.tensor(draws.zoom_fire, dtype=torch.bool, device=dev)
    return (torch.where(fire[:, None, None, None], zoomed, image),
            torch.where(fire[:, None, None], zoomed_label, label))


def apply_augment(cfg: AugmentConfig, draws: AugmentDraws,
                  image: torch.Tensor, label: torch.Tensor):
    """Augment (N, H, W, 3) float images in 0..255 and (N, H, W) labels.

    Nothing happens unless the gate is open; then the zoom runs (its fired
    samples), the blur, the jitter, and the flip when its coin says so.
    """
    if not draws.gate:
        return image, label
    if cfg.zooms:
        image, label = random_zoom(image, label, draws)
    if cfg.blur_kernel is not None:
        image = gaussian_blur(image, cfg.blur_kernel, draws.sigma)
    if cfg.color_jitter is not None:
        image = color_jitter(image, draws)
    if draws.flip:
        image = torch.flip(image, dims=(-2,))       # the W axis of NHWC
        if cfg.flip_labels:
            label = torch.flip(label, dims=(-1,))   # the W axis of NHW
    return image, label


def rank_slice(draws: AugmentDraws, positions: list[int]) -> AugmentDraws:
    """The draws of the samples at ``positions`` of the batch: the
    per-sample zoom draws picked, the batch's draws kept."""
    if not draws.zoom_scale:
        return draws

    def pick(values):
        return [values[i] for i in positions]
    return dataclasses.replace(
        draws, zoom_scale=pick(draws.zoom_scale),
        zoom_fire=pick(draws.zoom_fire), zoom_ty=pick(draws.zoom_ty),
        zoom_tx=pick(draws.zoom_tx))


def make_augment_fn(cfg: AugmentConfig, micro_batches: int = 1) -> Callable:
    """``augment(generator, image, label) -> (image, label)``; under the
    data axis ``image`` is this rank's share of the global batch, laid out
    for ``micro_batches`` as the loader lays it out."""

    def augment(generator, image, label):
        if not cfg.zooms:  # only the zoom draws per sample
            return apply_augment(cfg, draw(cfg, generator), image, label)
        n, h, w = image.shape[:3]
        world = world_size()
        draws = draw(cfg, generator, (n * world, h, w))
        positions = shard_positions(n * world, rank(), world, micro_batches)
        return apply_augment(cfg, rank_slice(draws, positions), image,
                             label)

    return augment
