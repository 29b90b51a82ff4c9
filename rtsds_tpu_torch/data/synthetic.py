"""Synthetic segmentation data for tests, smoke runs and benchmarks.

Deterministic (image, label) pairs: coarse blocks of one class, each
tinted with its class's color plus noise.  With ``fixed_tints=True`` one
class -> color mapping is shared by every dataset with the same
``num_classes`` (independent of ``seed``), so a model can learn it; by
default each image draws its own mapping.
"""

from __future__ import annotations

import numpy as np


class SyntheticSegDataset:
    def __init__(self, length: int = 16,
                 image_size: tuple[int, int] = (64, 128),
                 num_classes: int = 19, seed: int = 0,
                 fixed_tints: bool = False):
        self.length = length
        self.image_size = tuple(image_size)
        self.num_classes = num_classes
        self.seed = seed
        self.tints = (np.random.default_rng(123456789 + num_classes)
                      .integers(40, 215, size=(num_classes, 3))
                      if fixed_tints else None)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """(H, W, 3) uint8 image and (H, W) int32 label."""
        rng = np.random.default_rng(self.seed * 100003 + int(idx))
        h, w = self.image_size
        gh, gw = max(h // 8, 1), max(w // 8, 1)
        coarse = rng.integers(0, self.num_classes,
                              size=(h // gh + 1, w // gw + 1))
        label = np.kron(coarse, np.ones((gh, gw), dtype=np.int64))[:h, :w]
        tints = (rng.integers(40, 215, size=(self.num_classes, 3))
                 if self.tints is None else self.tints)
        image = tints[label] + rng.normal(0, 12, size=(h, w, 3))
        image = np.clip(image, 0, 255).astype(np.uint8)
        return image, label.astype(np.int32)
