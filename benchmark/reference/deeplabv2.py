"""DeepLabV2 with ResNet-101 (Chen et al., TPAMI 2017, arXiv:1606.00915).

Stem: 7x7 stride-2 conv, BN, ReLU, 3x3 stride-2 max pool with the partial
windows kept (ceil mode).  Bottleneck stages of 3, 4, 23 and 3 blocks,
the stride on the first 1x1 conv; the third and fourth stages at stride 1
with dilations 2 and 4, so the features stay at 1/8; every stage's first
block projects its skip.  ASPP: four 3x3 convs with bias at dilations 6,
12, 18 and 24, summed; the logits resized bilinearly to the input.  In
train mode the batch norms use the batch's statistics and their affine
parameters do not train (``frozen``).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Bottleneck, bn, conv, resize

STAGES = ((64, 1, 1, 3), (128, 2, 1, 4), (256, 1, 2, 23), (512, 1, 4, 3))


class ASPP(nn.Module):
    def __init__(self, cin, classes):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            conv(cin, classes, 3, 1, d, bias=True, dilation=d)
            for d in (6, 12, 18, 24))

    def forward(self, x):
        return sum(branch(x) for branch in self.conv2d_list)


class DeepLabV2(nn.Module):
    def __init__(self, classes: int = 19):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = bn(64)
        cin = 64
        for i, (width, stride, dilation, depth) in enumerate(STAGES):
            blocks = []
            for j in range(depth):
                blocks.append(Bottleneck(cin, width, stride if j == 0 else 1,
                                         j == 0, dilation))
                cin = width * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.layer6 = ASPP(cin, classes)

    def forward(self, x):
        out = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1,
                           ceil_mode=True)
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        out = resize(self.layer6(out), x.shape[-2:])
        return (out, None, None) if self.training else out


def build(classes: int) -> DeepLabV2:
    return DeepLabV2(classes)


def frozen(model: nn.Module) -> set[str]:
    """The names of the batch norms' affine parameters, which the recipe
    does not train."""
    return {name for name, m in model.named_modules()
            if isinstance(m, nn.BatchNorm2d)
            for name in (f"{name}.weight", f"{name}.bias")}
