"""Domain discriminators and gradient reversal (NCHW).

  * :class:`DomainDiscriminator`: the fully convolutional discriminator of
    Tsai et al. (CVPR'18): convs 4x4 stride 2 (19 -> 64 -> 128 -> 256 ->
    512 -> 1) with LeakyReLU(0.2), no BN, a global mean to (N, 1, 1, 1),
    and an optional gradient reversal on the output;
  * :class:`TinyDomainDiscriminator`: two convs, the config's default;
  * :class:`GradientReversal`: identity forward, ``-alpha * grad``
    backward;
  * :class:`UpSampler`: 8x bilinear upsample and a 1x1 conv.

The input is the softmaxed segmentation map (N, 19, H, W); the output is
(N, 1, 1, 1) logits in at least float32, whatever the compute dtype.
Submodules carry the Flax scopes' names, so a Flax tree loads through
:func:`~rtsds_tpu_torch.models.pretrained.load_flax_variables`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rtsds_tpu_torch.models.layers import conv, global_avg_pool
from rtsds_tpu_torch.ops.resize import upsample_bilinear
from rtsds_tpu_torch.parallel.spatial import Bands
from rtsds_tpu_torch.utils.dtypes import at_least_f32

LEAKY_SLOPE = 0.2


class GradientReversal(torch.autograd.Function):
    """``GradientReversal.apply(x, alpha)``: ``x`` forward, the incoming
    gradient times ``-alpha`` backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, alpha: float) -> torch.Tensor:
        ctx.alpha = float(alpha)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return -ctx.alpha * grad, None


def gradient_reversal(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """:class:`GradientReversal` of ``x``; of height bands
    (``parallel/spatial.py``) band by band, so that each band's gradient is
    reversed."""
    if isinstance(x, Bands):
        return x._per_band(lambda p: GradientReversal.apply(p, alpha))
    return GradientReversal.apply(x, alpha)


class UpSampler(nn.Module):
    """8x bilinear upsample, then a 1x1 conv."""

    def __init__(self, num_classes: int = 19):
        super().__init__()
        self.conv = conv(num_classes, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_bilinear(x, 8))


class DomainDiscriminator(nn.Module):
    """The fully convolutional discriminator; ``with_grl`` reverses the
    gradient at the output, scaled by ``lambda_``."""

    def __init__(self, num_classes: int = 19, with_grl: bool = False,
                 lambda_: float = 0.1):
        super().__init__()
        self.with_grl = with_grl
        self.lambda_ = lambda_
        channels = (num_classes, 64, 128, 256, 512)
        for i in range(4):
            self.add_module(f"conv{i + 1}",
                            conv(channels[i], channels[i + 1], 4, 2, 1))
        self.classifier = conv(512, 1, 4, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = F.leaky_relu(layer(x), LEAKY_SLOPE)
        x = at_least_f32(global_avg_pool(self.classifier(x)))
        if self.with_grl:
            x = gradient_reversal(x, self.lambda_)
        return x


class TinyDomainDiscriminator(nn.Module):
    """conv1 4x4/s2 -> LeakyReLU(0.2) -> classifier 4x4/s2 -> global mean."""

    def __init__(self, num_classes: int = 19):
        super().__init__()
        self.conv1 = conv(num_classes, 64, 4, 2, 1)
        self.classifier = conv(64, 1, 4, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv1(x), LEAKY_SLOPE)
        return at_least_f32(global_avg_pool(self.classifier(x)))
