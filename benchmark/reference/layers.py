"""Building blocks of the reference models (NCHW, float32).

Module names follow torchvision's ResNet, so that a state dict of the
reference loads into the program's models and back.  ``Conv`` applies the
model's precision (``lowp.py``) to its input and weight.  A residual
block may recompute its activations in the backward
(``checkpoint_blocks``): the values are the same, the memory far less, and
the batch norms' running statistics, which the reference never reads,
advance twice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.lowp import CASTS


class Conv(nn.Conv2d):
    cast = staticmethod(CASTS["float32"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(self.cast(x), self.cast(self.weight), self.bias,
                        self.stride, self.padding, self.dilation)


def conv(cin, cout, k=3, stride=1, padding=0, bias=True, dilation=1):
    return Conv(cin, cout, k, stride=stride, padding=padding,
                dilation=dilation, bias=bias)


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def set_precision(model: nn.Module, name: str) -> nn.Module:
    """Every ``Conv`` of ``model`` computes in precision ``name``."""
    for m in model.modules():
        if isinstance(m, Conv):
            m.cast = CASTS[name]
    return model


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear, half-pixel centres, no antialias."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class Residual(nn.Module):
    checkpointed = False

    @property
    def last_bn(self) -> nn.BatchNorm2d:
        """The batch norm that ends the residual branch."""
        return self.bn3 if hasattr(self, "bn3") else self.bn2

    def forward(self, x):
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(self.body, x, use_reentrant=False)
        return self.body(x)


class BasicBlock(Residual):
    def __init__(self, cin, width, stride, project):
        super().__init__()
        self.conv1 = conv(cin, width, 3, stride, 1, bias=False)
        self.bn1 = bn(width)
        self.conv2 = conv(width, width, 3, 1, 1, bias=False)
        self.bn2 = bn(width)
        self.downsample = (nn.Sequential(conv(cin, width, 1, stride, 0,
                                              bias=False), bn(width))
                           if project else None)

    def body(self, x):
        skip = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + skip)


class Bottleneck(Residual):
    """1x1 (carrying the stride) -> 3x3 dilated -> 1x1 four times wider."""

    def __init__(self, cin, width, stride, project, dilation):
        super().__init__()
        self.conv1 = conv(cin, width, 1, stride, 0, bias=False)
        self.bn1 = bn(width)
        self.conv2 = conv(width, width, 3, 1, dilation, bias=False,
                          dilation=dilation)
        self.bn2 = bn(width)
        self.conv3 = conv(width, width * 4, 1, 1, 0, bias=False)
        self.bn3 = bn(width * 4)
        self.downsample = (nn.Sequential(conv(cin, width * 4, 1, stride, 0,
                                              bias=False), bn(width * 4))
                           if project else None)

    def body(self, x):
        skip = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + skip)


def checkpoint_blocks(model: nn.Module, on: bool = True) -> nn.Module:
    for m in model.modules():
        if isinstance(m, Residual):
            m.checkpointed = on
    return model
