"""The reference RTSDS code's Tiny domain discriminator: a 4x4 stride-2
conv to 64 channels, LeakyReLU(0.2), a 4x4 stride-2 conv to one channel,
the global mean."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import conv


class TinyDiscriminator(nn.Module):
    def __init__(self, classes: int = 19):
        super().__init__()
        self.conv1 = conv(classes, 64, 4, 2, 1)
        self.classifier = conv(64, 1, 4, 2, 1)

    def forward(self, x):
        x = F.leaky_relu(self.conv1(x), 0.2)
        return self.classifier(x).mean(dim=(2, 3), keepdim=True)


def build(classes: int) -> TinyDiscriminator:
    return TinyDiscriminator(classes)
