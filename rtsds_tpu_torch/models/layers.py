"""Shared building blocks (NCHW).

Batch norm is plain ``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``: the JAX
package's ``TorchBatchNorm`` exists only to reproduce these semantics.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def conv(in_channels: int, out_channels: int, kernel: int = 3,
         stride: int = 1, padding: int = 0, bias: bool = True,
         dilation: int = 1) -> nn.Conv2d:
    """2-D conv with symmetric integer padding."""
    return nn.Conv2d(in_channels, out_channels, kernel, stride=stride,
                     padding=padding, dilation=dilation, bias=bias)


def batch_norm(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def kaiming_normal_relu_(module: nn.Module) -> None:
    """``kaiming_normal_(mode='fan_in', nonlinearity='relu')`` on every conv
    kernel of ``module`` and zero biases: the init of BiSeNet's head convs."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                    nonlinearity="relu")
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def normal_001_(*convs: nn.Conv2d) -> None:
    """``normal(0, 0.01)`` kernels and zero biases: the init of DeepLabV2's
    stem and classifier convs."""
    for m in convs:
        nn.init.normal_(m.weight, 0.0, 0.01)
        if m.bias is not None:
            nn.init.zeros_(m.bias)


class ConvBlock(nn.Module):
    """Conv (no bias) -> BN -> ReLU; default 3x3 stride 2."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 2, padding: int = 1):
        super().__init__()
        self.conv1 = conv(in_channels, out_channels, kernel, stride, padding,
                          bias=False)
        self.bn = batch_norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv1(x)))


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Average over the spatial dims of an (N, C, H, W) tensor."""
    return x.mean(dim=(2, 3), keepdim=keepdims)


class Stem7x7(nn.Conv2d):
    """The ResNet stem: 7x7 stride-2 conv, padding 3, no bias."""

    def __init__(self, in_channels: int = 3, features: int = 64):
        super().__init__(in_channels, features, 7, stride=2, padding=3,
                         bias=False)


def max_pool_3x3_s2(x: torch.Tensor, ceil_mode: bool = False) -> torch.Tensor:
    """``MaxPool2d(kernel_size=3, stride=2, padding=1)``; ``ceil_mode`` keeps
    the partial windows at the high edge (DeepLabV2's stem)."""
    return F.max_pool2d(x, 3, stride=2, padding=1, ceil_mode=ceil_mode)


@contextlib.contextmanager
def _running_stats_untouched(module: nn.Module):
    """Inside the block, ``module``'s batch norms in train mode normalize
    with the batch's statistics as before, but their running statistics
    and counters come out as they went in: the momentum is 0 (so the
    kernel writes back each running value unchanged, and saves for the
    backward what it saved in the first forward) and the counters are put
    back on exit."""
    bns = [m for m in module.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)
           and m.training and m.track_running_stats]
    kept = [(m.momentum, m.num_batches_tracked.clone()) for m in bns]
    for m in bns:
        m.momentum = 0.0
    try:
        yield
    finally:
        for m, (momentum, count) in zip(bns, kept):
            m.momentum = momentum
            m.num_batches_tracked.copy_(count)


def rematerialized(module: nn.Module, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: the activations inside
    are recomputed in the backward instead of kept.  The recompute runs
    ``module``'s batch norms without touching their running statistics, so
    a step advances them once, as it does without remat; a plain
    ``checkpoint`` would advance them a second time."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _running_stats_untouched(module)))
