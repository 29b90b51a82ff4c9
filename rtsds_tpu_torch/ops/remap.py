"""GTA5 RGB-coded label -> Cityscapes trainId remap, in plain PyTorch.

Each pixel's colour is compared, channel by channel, with the (C, 3) colour
table; the index of the first matching row is its trainId, and a pixel that
matches no row gets ``default_id`` (255, the void id; the original
training script's zero-initialised loop gave 0, 'road': ``default_id=0``).

This is the CPU path of :func:`rtsds_tpu_torch.ops.cuda.remap.
rgb_to_train_ids_cuda` and the reference its CUDA kernel is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from rtsds_tpu_torch.utils.colors import class_colors_for_remap


def rgb_to_train_ids(rgb: torch.Tensor, color_table=None,
                     default_id: int = 255) -> torch.Tensor:
    """(..., 3) uint8/int RGB label colours -> (...) int32 trainIds.

    ``color_table`` is a (C, 3) array of RGB keys, one per trainId; the
    default is the 19-class table of
    :func:`rtsds_tpu_torch.utils.colors.class_colors_for_remap`.
    """
    if rgb.shape[-1:] != (3,):
        raise ValueError(f"expected (..., 3) RGB, got {tuple(rgb.shape)}")
    if color_table is None:
        color_table = class_colors_for_remap()
    table = torch.as_tensor(np.asarray(color_table), dtype=torch.int64,
                            device=rgb.device)
    px = rgb.to(torch.int64)
    # (..., 1, 3) == (C, 3) -> (..., C)
    matches = (px[..., None, :] == table).all(dim=-1)
    # argmax returns the first of equal maxima: the first matching key
    ids = matches.to(torch.uint8).argmax(dim=-1).to(torch.int32)
    return torch.where(matches.any(dim=-1), ids,
                       torch.full_like(ids, default_id))
