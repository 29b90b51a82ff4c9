"""Adaptive average pooling of NCHW maps, as the v2 adversarial step uses it
to bring the source's segmentation maps to the target's size.

Output cell ``i`` averages the input rows ``[floor(i * H / OH), ceil((i + 1)
* H / OH))``, and the same for columns: torch's own windows, so
``F.adaptive_avg_pool2d`` computes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool2d(x: torch.Tensor,
                        output_size: tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) or (C, H, W) -> spatial size ``output_size`` (OH, OW);
    ``x`` itself when it already has that size."""
    if tuple(x.shape[-2:]) == tuple(output_size):
        return x
    return F.adaptive_avg_pool2d(x, tuple(output_size))
