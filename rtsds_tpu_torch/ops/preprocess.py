"""Input normalization.

The training recipe normalizes 0-255 floats with the ImageNet mean and std
without dividing by 255 first; that quirk is the default, because weights
trained with it expect it.  ``correct_preprocessing=True`` divides by 255.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(image: torch.Tensor,
              correct_preprocessing: bool = False) -> torch.Tensor:
    """ImageNet normalization of (..., H, W, 3) images -> float32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=image.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=image.device)
    image = image.to(torch.float32)
    if correct_preprocessing:
        image = image / 255.0
    return (image - mean) / std
