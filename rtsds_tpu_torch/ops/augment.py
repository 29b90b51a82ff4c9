"""Training augmentation on device batches, with explicit random draws.

The recipe of the original training script: a RandomApply gate with
probability ``p`` around GaussianBlur (sigma drawn from a range) and
RandomHorizontalFlip.  The flip is applied to the labels too, so pixels
keep their class (``flip_labels=False`` flips the image only, as the
original script did).

One batch gets one set of draws (gate, sigma, flip) from a
``torch.Generator`` on the CPU, so drawing never waits on the GPU; the
draws are plain Python numbers, and :func:`apply_augment` is a
deterministic function of them.  ColorJitter and RandomZoom are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from rtsds_tpu_torch.config import parse_float_list, parse_int_list
from rtsds_tpu_torch.ops.blur import gaussian_blur


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    apply_p: float = 0.5                      # the RandomApply gate
    blur_kernel: tuple[int, int] | None = (5, 9)
    blur_sigma: tuple[float, float] = (0.1, 5.0)
    flip_p: float | None = 0.5
    flip_labels: bool = True

    @classmethod
    def from_config(cls, config) -> "AugmentConfig":
        aug = config.augmentation
        for name in ("ColorJitter", "RandomZoom"):
            if aug.get(name) is not None:
                raise NotImplementedError(
                    f"augmentation.{name} is not ported yet to "
                    f"rtsds_tpu_torch; remove it from the config or use "
                    f"rtsds_tpu")
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
        return cls(apply_p=float(aug.get("p", 0.5)), blur_kernel=blur_kernel,
                   blur_sigma=blur_sigma or (0.1, 5.0), flip_p=flip_p)


@dataclasses.dataclass(frozen=True)
class AugmentDraws:
    gate: bool
    sigma: float
    flip: bool


def draw(cfg: AugmentConfig, generator: torch.Generator) -> AugmentDraws:
    """One batch's draws: the gate, the blur sigma and the flip coin."""
    u = torch.rand(3, generator=generator, dtype=torch.float64).tolist()
    lo, hi = cfg.blur_sigma
    return AugmentDraws(gate=u[0] < cfg.apply_p, sigma=lo + (hi - lo) * u[1],
                        flip=cfg.flip_p is not None and u[2] < cfg.flip_p)


def apply_augment(cfg: AugmentConfig, draws: AugmentDraws,
                  image: torch.Tensor, label: torch.Tensor):
    """Augment (N, H, W, 3) float images in 0..255 and (N, H, W) labels.

    Nothing happens unless the gate is open; then the blur runs, and the
    flip when its coin says so.
    """
    if not draws.gate:
        return image, label
    if cfg.blur_kernel is not None:
        image = gaussian_blur(image, cfg.blur_kernel, draws.sigma)
    if draws.flip:
        image = torch.flip(image, dims=(-2,))       # the W axis of NHWC
        if cfg.flip_labels:
            label = torch.flip(label, dims=(-1,))   # the W axis of NHW
    return image, label


def make_augment_fn(cfg: AugmentConfig) -> Callable:
    """``augment(generator, image, label) -> (image, label)``."""

    def augment(generator, image, label):
        return apply_augment(cfg, draw(cfg, generator), image, label)

    return augment
