"""BiSeNet: bilateral real-time segmentation network (NCHW).

  * spatial path: three stride-2 ConvBlocks, 3 -> 64 -> 128 -> 256 at 1/8
  * context path: ResNet-18/101 giving (1/16, 1/32, tail) features
  * an attention refinement module (ARM) on each context feature, the 1/32
    branch multiplied by the tail
  * both context branches upsampled to 1/8, concatenated with the spatial
    path and fused (FFM: concat -> 3x3 ConvBlock -> SE-style gate)
  * a 1x1 classifier and an 8x bilinear upsample to the input size

In train mode the forward also returns the two auxiliary heads
(``supervision1/2``), upsampled to the input size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rtsds_tpu_torch.models.layers import (
    ConvBlock, batch_norm, conv, global_avg_pool, kaiming_normal_relu_)
from rtsds_tpu_torch.models.resnet import FEATURE_CHANNELS, build_contextpath
from rtsds_tpu_torch.ops.resize import resize_bilinear, upsample_bilinear
from rtsds_tpu_torch.utils.dtypes import at_least_f32


class SpatialPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.convblock1 = ConvBlock(3, 64)
        self.convblock2 = ConvBlock(64, 128)
        self.convblock3 = ConvBlock(128, 256)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convblock3(self.convblock2(self.convblock1(x)))


class AttentionRefinementModule(nn.Module):
    """Channel gate: global pool -> 1x1 conv -> BN -> sigmoid -> multiply."""

    def __init__(self, features: int):
        super().__init__()
        self.conv = conv(features, features, 1)
        self.bn = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.bn(self.conv(global_avg_pool(x))))
        return x * gate


class FeatureFusionModule(nn.Module):
    """Concat -> ConvBlock (3x3, stride 1) -> SE-style gate -> mul + add."""

    def __init__(self, num_classes: int, in_channels: int):
        super().__init__()
        self.convblock = ConvBlock(in_channels, num_classes, stride=1)
        self.conv1 = conv(num_classes, num_classes, 1)
        self.conv2 = conv(num_classes, num_classes, 1)

    def forward(self, *parts: torch.Tensor) -> torch.Tensor:
        feature = self.convblock(torch.cat(parts, dim=1))
        gate = global_avg_pool(feature)
        gate = torch.sigmoid(self.conv2(F.relu(self.conv1(gate))))
        return feature * gate + feature


class BiSeNet(nn.Module):
    """BiSeNet on (N, 3, H, W) input; eval returns (N, classes, H, W) logits.

    ``fast_head`` applies the final 1x1 conv before the 8x upsample: both
    are linear and the upsample's weights sum to one, so the result is the
    same up to rounding while the conv runs on 64x fewer pixels.
    ``output_f32=False`` keeps the logits in the compute dtype, for callers
    that only take their argmax.  ``remat`` recomputes the context path's
    residual blocks in the backward instead of keeping their activations.
    ``with_interpolation=False`` returns the fused 1/8-resolution logits:
    no final 1x1 ``conv`` (the module has no ``conv.*`` parameters) and no
    8x upsample.  ``s2d_stem=True`` is accepted for the JAX package's
    configurations and computes the plain stride-2 stems: its
    space-to-depth stem is an exact re-layout for the TPU's matrix unit,
    with the same parameters and results.
    """

    # the attention gates batch-normalize a pooled (N, C, 1, 1) map, whose
    # statistics one frame cannot give
    min_train_batch = 2

    def __init__(self, num_classes: int = 19, context_path: str = "resnet18",
                 fast_head: bool = True, output_f32: bool = True,
                 remat: bool = False, with_interpolation: bool = True,
                 s2d_stem: bool = False):
        super().__init__()
        c16, c32 = FEATURE_CHANNELS[context_path]
        self.fast_head = fast_head
        self.with_interpolation = with_interpolation
        self.s2d_stem = s2d_stem
        self.output_f32 = output_f32
        self.spatial_path = SpatialPath()
        self.context_path = build_contextpath(context_path, remat=remat)
        self.arm1 = AttentionRefinementModule(c16)
        self.arm2 = AttentionRefinementModule(c32)
        self.supervision1 = conv(c16, num_classes, 1)
        self.supervision2 = conv(c32, num_classes, 1)
        self.ffm = FeatureFusionModule(num_classes, 256 + c16 + c32)
        if with_interpolation:
            self.conv = conv(num_classes, num_classes, 1)
        for name, child in self.named_children():
            if name != "context_path":
                kaiming_normal_relu_(child)

    @staticmethod
    def is_head(name: str) -> bool:
        """Whether parameter ``name`` takes ``head_lr_mult``: every module
        but the pretrained context path."""
        return name.split(".")[0] != "context_path"

    def forward(self, x: torch.Tensor):
        sx = self.spatial_path(x)
        cx1, cx2, tail = self.context_path(x)
        cx1 = self.arm1(cx1)
        cx2 = self.arm2(cx2) * tail
        cx1 = resize_bilinear(cx1, sx.shape[-2:])
        cx2 = resize_bilinear(cx2, sx.shape[-2:])

        result = self.ffm(sx, cx1, cx2)
        if self.with_interpolation:
            if self.fast_head:
                result = upsample_bilinear(self.conv(result), 8)
            else:
                result = self.conv(upsample_bilinear(result, 8))
        if self.output_f32:
            result = at_least_f32(result)
        if not self.training:
            return result

        in_size = x.shape[-2:]
        cx1_sup = at_least_f32(resize_bilinear(self.supervision1(cx1),
                                               in_size))
        cx2_sup = at_least_f32(resize_bilinear(self.supervision2(cx2),
                                               in_size))
        return result, cx1_sup, cx2_sup
