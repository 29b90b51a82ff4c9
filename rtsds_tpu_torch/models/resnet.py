"""ResNet context paths for BiSeNet (NCHW).

Submodules are named as torchvision names them (``conv1``, ``bn1``,
``layer2.0.conv1``, ``layer2.0.downsample.0/1``), so the state-dict keys
are those of a torchvision ResNet and of the JAX package's export.
torchvision itself is not a dependency.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rtsds_tpu_torch.models.layers import (
    Stem7x7, batch_norm, conv, global_avg_pool, max_pool_3x3_s2,
    rematerialized)


def _projection(in_channels: int, out_channels: int,
                stride: int) -> nn.Sequential:
    return nn.Sequential(conv(in_channels, out_channels, 1, stride, 0,
                              bias=False),
                         batch_norm(out_channels))


class _Block(nn.Module):
    """A residual block; with ``remat`` set, its activations are recomputed
    in the backward instead of kept (:func:`rematerialized`)."""

    remat = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return rematerialized(self, self.residual, x)
        return self.residual(x)


class BasicBlock(_Block):
    """Two 3x3 convs plus an identity or projection skip."""

    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(in_channels, features, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(features)
        self.conv2 = conv(features, features, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(features)
        self.downsample = (_projection(in_channels, features, stride)
                           if downsample else None)

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(_Block):
    """1x1 -> 3x3 (strided) -> 1x1 (4x wider) plus a skip.

    ``stride_in_1x1`` moves the stride to the first 1x1 conv, the original
    ResNet placement that DeepLabV2 uses; ``dilation`` dilates (and pads)
    the 3x3 conv.
    """

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1,
                 stride_in_1x1: bool = False):
        super().__init__()
        out_channels = features * self.expansion
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = conv(in_channels, features, 1, s1, 0, bias=False)
        self.bn1 = batch_norm(features)
        self.conv2 = conv(features, features, 3, s3, dilation, bias=False,
                          dilation=dilation)
        self.bn2 = batch_norm(features)
        self.conv3 = conv(features, out_channels, 1, 1, 0, bias=False)
        self.bn3 = batch_norm(out_channels)
        self.downsample = (_projection(in_channels, out_channels, stride)
                           if downsample else None)

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


_STAGES = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
}

# context-path channels at (1/16, 1/32) resolution per backbone
FEATURE_CHANNELS = {"resnet18": (256, 512), "resnet101": (1024, 2048)}


class ResNetBackbone(nn.Module):
    """Returns (C3 at 1/16, C4 at 1/32, tail), where ``tail`` is the global
    average of C4 with shape (N, C, 1, 1).  ``remat`` recomputes each
    residual block's activations in the backward instead of keeping
    them."""

    def __init__(self, arch: str = "resnet18", remat: bool = False):
        super().__init__()
        block, depths = _STAGES[arch]
        self.conv1 = Stem7x7(3, 64)
        self.bn1 = batch_norm(64)
        in_channels = 64
        for stage, (width, depth) in enumerate(zip((64, 128, 256, 512),
                                                   depths)):
            blocks = []
            for i in range(depth):
                stride = 2 if (stage > 0 and i == 0) else 1
                needs_proj = i == 0 and (
                    stride != 1 or in_channels != width * block.expansion)
                blocks.append(block(in_channels, width, stride, needs_proj))
                blocks[-1].remat = remat
                in_channels = width * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        x = self.layer2(self.layer1(x))
        feature3 = self.layer3(x)
        feature4 = self.layer4(feature3)
        return feature3, feature4, global_avg_pool(feature4)


def build_contextpath(name: str, remat: bool = False) -> ResNetBackbone:
    if name not in _STAGES:
        raise ValueError(f"unsupported context_path network {name!r}")
    return ResNetBackbone(arch=name, remat=remat)
