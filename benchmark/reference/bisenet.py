"""BiSeNet with a ResNet-18 context path (Yu et al., ECCV 2018,
arXiv:1808.00897), as the reference RTSDS code builds it.

Spatial path: three 3x3 stride-2 conv-BN-ReLU blocks to 1/8.  Context
path: ResNet-18's features at 1/16 and 1/32 and the global mean of the
latter; an attention refinement module (global mean, 1x1 conv, BN,
sigmoid, multiply) on each, the 1/32 branch multiplied by the global
mean; both resized to 1/8.  Fusion: concat, 3x3 conv-BN-ReLU to the
classes, a squeeze gate (mean, 1x1, ReLU, 1x1, sigmoid), ``f * g + f``.
Head: 8x bilinear upsample, then a 1x1 conv.  In train mode two auxiliary
heads, 1x1 convs of the two refined context features, resized to the
input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import BasicBlock, bn, conv, resize


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, stride=2):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, stride, 1, bias=False)
        self.bn = bn(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv1(x)))


class SpatialPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.convblock1 = ConvBlock(3, 64)
        self.convblock2 = ConvBlock(64, 128)
        self.convblock3 = ConvBlock(128, 256)

    def forward(self, x):
        return self.convblock3(self.convblock2(self.convblock1(x)))


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = bn(64)
        cin = 64
        for i, width in enumerate((64, 128, 256, 512)):
            stride = 1 if i == 0 else 2
            blocks = [BasicBlock(cin, width, stride, stride != 1),
                      BasicBlock(width, width, 1, False)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            cin = width

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        f3 = self.layer3(self.layer2(self.layer1(x)))
        f4 = self.layer4(f3)
        return f3, f4, f4.mean(dim=(2, 3), keepdim=True)


class ARM(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = conv(c, c, 1)
        self.bn = bn(c)

    def forward(self, x):
        return x * torch.sigmoid(self.bn(self.conv(
            x.mean(dim=(2, 3), keepdim=True))))


class FFM(nn.Module):
    def __init__(self, classes, cin):
        super().__init__()
        self.convblock = ConvBlock(cin, classes, stride=1)
        self.conv1 = conv(classes, classes, 1)
        self.conv2 = conv(classes, classes, 1)

    def forward(self, *parts):
        f = self.convblock(torch.cat(parts, dim=1))
        g = torch.sigmoid(self.conv2(F.relu(self.conv1(
            f.mean(dim=(2, 3), keepdim=True)))))
        return f * g + f


class BiSeNet(nn.Module):
    def __init__(self, classes: int = 19):
        super().__init__()
        self.spatial_path = SpatialPath()
        self.context_path = ResNet18()
        self.arm1 = ARM(256)
        self.arm2 = ARM(512)
        self.supervision1 = conv(256, classes, 1)
        self.supervision2 = conv(512, classes, 1)
        self.ffm = FFM(classes, 256 + 256 + 512)
        self.conv = conv(classes, classes, 1)

    def forward(self, x):
        s = self.spatial_path(x)
        c1, c2, tail = self.context_path(x)
        c1 = resize(self.arm1(c1), s.shape[-2:])
        c2 = resize(self.arm2(c2) * tail, s.shape[-2:])
        f = self.ffm(s, c1, c2)
        out = self.conv(resize(f, x.shape[-2:]))
        if not self.training:
            return out
        return (out, resize(self.supervision1(c1), x.shape[-2:]),
                resize(self.supervision2(c2), x.shape[-2:]))


def build(classes: int) -> BiSeNet:
    return BiSeNet(classes)
