"""DeepLabV2: a dilated ResNet-101 and a summed ASPP classifier (NCHW).

  * stem: 7x7 stride-2 conv, BN, ReLU, 3x3 stride-2 max pool with
    ``ceil_mode``
  * Bottleneck stages [3, 4, 23, 3] with the stride on the first 1x1 conv;
    layer3 runs at dilation 2 and layer4 at dilation 4, both at stride 1,
    so the features stay at 1/8 of the input; every dilated stage's first
    block projects its skip
  * ``layer6``: four 3x3 convs with bias, dilation and padding 6/12/18/24,
    their outputs summed
  * the logits resized bilinearly (half-pixel, no antialias) to the input
    size; train mode returns ``(logits, None, None)``, the shape of
    BiSeNet's three heads

Submodule names follow the torch ResNet (``layer3.5.downsample.1``) and
the ASPP's ``layer6.conv2d_list.2``, so the state-dict keys are those the
JAX package's export gives.  The stem and the classifier start from
``normal(0, 0.01)`` with zero biases, the bottlenecks from torch's default
conv init, as in the JAX package.

Batch norm: the affine parameters never train (:func:`frozen_bn_parameters`
names them for the optimizer), while the statistics run in batch mode in
train mode, as the reference's DeepLab does.  ``bn_eval`` instead keeps
every BN on its running statistics in train mode too, and leaves them
unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rtsds_tpu_torch.models.layers import (
    Stem7x7, batch_norm, conv, max_pool_3x3_s2, normal_001_)
from rtsds_tpu_torch.models.resnet import Bottleneck
from rtsds_tpu_torch.ops.resize import resize_bilinear
from rtsds_tpu_torch.utils.dtypes import at_least_f32

# (width, stride, dilation) of each stage
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))


class ASPP(nn.Module):
    """Sum of four dilated 3x3 convs with bias."""

    def __init__(self, in_channels: int, num_classes: int,
                 dilations: tuple[int, ...] = (6, 12, 18, 24)):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            conv(in_channels, num_classes, 3, 1, d, bias=True, dilation=d)
            for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2d_list[0](x)
        for branch in self.conv2d_list[1:]:
            out = out + branch(x)
        return out


class DeepLabV2(nn.Module):
    """DeepLabV2 on (N, 3, H, W) input; eval returns (N, classes, H, W)
    logits, at least float32 unless ``output_f32=False``.  ``remat``
    recomputes each bottleneck's activations in the backward instead of
    keeping them; ``bn_eval`` is described in the module docstring."""

    def __init__(self, num_classes: int = 19,
                 layers: tuple[int, ...] = (3, 4, 23, 3),
                 output_f32: bool = True, remat: bool = False,
                 bn_eval: bool = False):
        super().__init__()
        self.output_f32 = output_f32
        self.bn_eval = bn_eval
        self.conv1 = Stem7x7(3, 64)
        self.bn1 = batch_norm(64)
        in_channels = 64
        for stage, ((width, stride, dilation), depth) in enumerate(
                zip(STAGES, layers)):
            blocks = []
            for i in range(depth):
                first = i == 0
                needs_proj = first and (
                    stride != 1 or in_channels != width * 4
                    or dilation in (2, 4))
                block = Bottleneck(in_channels, width,
                                   stride if first else 1, needs_proj,
                                   dilation=dilation, stride_in_1x1=True)
                block.remat = remat
                blocks.append(block)
                in_channels = width * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.layer6 = ASPP(in_channels, num_classes)
        normal_001_(self.conv1, *self.layer6.conv2d_list)
        self.train()

    def train(self, mode: bool = True) -> "DeepLabV2":
        super().train(mode)
        if self.bn_eval:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.train(False)
        return self

    @staticmethod
    def is_head(name: str) -> bool:
        """Whether parameter ``name`` takes ``head_lr_mult``: the ASPP
        classifier."""
        return name.split(".")[0] == "layer6"

    def forward(self, x: torch.Tensor):
        in_size = x.shape[-2:]
        out = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))), ceil_mode=True)
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        out = resize_bilinear(self.layer6(out), in_size)
        if self.output_f32:
            out = at_least_f32(out)
        if self.training:
            return out, None, None
        return out


def frozen_bn_parameters(model: nn.Module) -> list[nn.Parameter]:
    """The batch-norm affine parameters that never train: every ``bn*``
    module's and every ``downsample.1``'s weight and bias."""
    frozen = []
    for name, p in model.named_parameters():
        scopes = name.split(".")[:-1]
        if any(s.startswith("bn") for s in scopes) or \
                ".".join(scopes[-2:]) == "downsample.1":
            frozen.append(p)
    return frozen
