"""Input normalization and the per-batch device transform.

The training recipe normalizes 0-255 floats with the ImageNet mean and std
without dividing by 255 first; that quirk is the default, because weights
trained with it expect it.  ``correct_preprocessing=True`` divides by 255.

:func:`make_transform` is the pipeline each loaded batch goes through on
the device: [RGB label remap] -> [augment] -> resize -> normalize ->
label resize -> clamp of the labels to [0, num_classes].  Raw GTA5 labels
are colour-coded; with ``decode_label_colors`` they arrive as (N, H, W, 3)
uint8 and the remap kernel turns them into trainIds on the device, where
void (255) then clamps to ``num_classes``, the id the loss ignores.
"""

from __future__ import annotations

from typing import Callable

import torch

from rtsds_tpu_torch.ops.augment import AugmentConfig, make_augment_fn
from rtsds_tpu_torch.ops.cuda.remap import rgb_to_train_ids_cuda
from rtsds_tpu_torch.ops.resize import (
    clamp_labels, resize_images, resize_labels_nearest)

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


def make_transform(image_size: tuple[int, int], num_classes: int = 19,
                   antialias: bool = True,
                   augment_cfg: AugmentConfig | None = None,
                   correct_preprocessing: bool = False,
                   decode_label_colors: bool = False,
                   color_table=None, micro_batches: int = 1) -> Callable:
    """``transform(image, label, generator=None) -> (image, label)``.

    Input: (N, H, W, 3) uint8/float images in 0..255 and (N, H, W) integer
    labels, or (N, H, W, 3) uint8 colour-coded labels with
    ``decode_label_colors``, all on one device.  Output: normalized float32
    (N, H, W, 3) images at ``image_size`` and int32 labels.  With
    ``augment_cfg`` the transform needs the batch's ``generator``;
    ``micro_batches`` is the loader's layout of a rank's share
    (``data/multihost.py``).
    """
    augment = make_augment_fn(augment_cfg, micro_batches) \
        if augment_cfg is not None else None

    def transform(image, label, generator=None):
        image = image.to(torch.float32)
        if decode_label_colors:
            label = rgb_to_train_ids_cuda(label, color_table)
        if augment is not None:
            if generator is None:
                raise ValueError("augmentation needs a torch.Generator")
            image, label = augment(generator, image, label)
        image = resize_images(image, image_size, antialias=antialias)
        image = normalize(image, correct_preprocessing)
        label = resize_labels_nearest(label, image_size)
        label = clamp_labels(label, 0, num_classes)
        return image, label

    return transform
