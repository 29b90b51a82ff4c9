"""The per-batch transform of the training data, written out plainly.

Labels: each pixel's colour is looked up in the 19 Cityscapes training
colours, first match wins, and a colour that is not among them is void,
which the loss ignores (id 19).  Images: uint8 to float32 and the ImageNet
normalization of 0-255 values (the training recipe's, without a division
by 255).  Frames arrive at the training size, so nothing is resized.
"""

from __future__ import annotations

import numpy as np
import torch

# Cityscapes' colours of the 19 training classes, in trainId order
TRAIN_COLORS = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]], dtype=np.uint8)
IGNORE = 19
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def label_ids(rgb: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 colours -> (N, H, W) int32 trainIds, void 19."""
    ids = torch.full(rgb.shape[:-1], IGNORE, dtype=torch.int32,
                     device=rgb.device)
    for cls in reversed(range(len(TRAIN_COLORS))):
        colour = torch.as_tensor(TRAIN_COLORS[cls], device=rgb.device)
        ids[(rgb == colour).all(dim=-1)] = cls
    return ids


def normalize(images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> normalized float32 (N, H, W, 3)."""
    mean = torch.tensor(MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(STD, dtype=torch.float32, device=images.device)
    return (images.float() - mean) / std
