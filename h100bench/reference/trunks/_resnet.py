"""The ResNet trunks (He et al., arXiv:1512.03385) as Matterport's Mask
R-CNN builds them, shared by ``resnet50.py`` and ``resnet101.py``, which
differ only in their blocks per stage."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch.nn.functional as F
from torch import nn

from h100bench.flops import Layer, bottleneck_stage, conv_flops, conv_out
from h100bench.reference.model import Conv2d, FrozenBN, nchw, pad_same
from h100bench.reference.trunks._fpn import FPN, PART, neck_layers


class Bottleneck(nn.Module):
    """Matterport's bottleneck: the stride on the 1x1 conv; BN eps 1e-3."""

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, stride=stride)
        self.bn1 = FrozenBN(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.bn2 = FrozenBN(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1)
        self.bn3 = FrozenBN(planes * 4)
        self.downsample = (nn.Sequential(Conv2d(cin, planes * 4, 1, stride=stride),
                                         FrozenBN(planes * 4)) if downsample else None)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + res)


def stage(cin, planes, blocks, stride):
    return nn.Sequential(Bottleneck(cin, planes, stride, True),
                         *[Bottleneck(planes * 4, planes) for _ in range(1, blocks)])


class ResNetFPN(FPN):
    """C1 (7x7 stem), C2..C5 of ``blocks`` bottlenecks each, the FPN neck."""

    def __init__(self, blocks: Sequence[int], out: int = 256):
        super().__init__()
        self.C1 = nn.Sequential(Conv2d(3, 64, 7, stride=2, padding=3), FrozenBN(64))
        self.C2 = stage(64, 64, blocks[0], 1)
        self.C3 = stage(256, 128, blocks[1], 2)
        self.C4 = stage(512, 256, blocks[2], 2)
        self.C5 = stage(1024, 512, blocks[3], 2)
        self.add_neck((256, 512, 1024, 2048), out)

    def forward(self, x):
        y = F.relu(self.C1(nchw(x)))
        y = F.max_pool2d(pad_same(y, 3, 2, -math.inf), 3, 2)
        c2 = self.C2(y)
        c3 = self.C3(c2)
        c4 = self.C4(c3)
        return self.neck(c2, c3, c4, self.C5(c4))


def flop_layers(cfg: Dict, blocks: Sequence[int], trained_levels=()):
    n = conv_out(cfg["image_size"], 7, 2, 3)
    layers = [Layer(conv_flops(n, n, 3, 64, 7), PART)]
    n = math.ceil(n / 2)                                       # SAME max pool
    sizes, cin, grad = [], 64, False
    for k, (planes, count, stride) in enumerate(zip((64, 128, 256, 512), blocks,
                                                   (1, 2, 2, 2)), start=2):
        train = k in trained_levels
        stage_layers, n = bottleneck_stage(n, cin, planes, count, stride, PART, train, grad)
        layers += stage_layers
        grad = grad or train
        sizes.append((n, planes * 4, grad))
        cin = planes * 4
    neck, levels = neck_layers(sizes, cfg["fpn_channels"], bool(trained_levels))
    return layers + neck, levels


def trained_pattern(levels) -> str:
    return "|".join(rf"C{k}\." for k in levels)


def start(fpn, sd, gen) -> None:
    """Nothing: the draw covers every convolution, and ``seeded`` makes
    each frozen batch norm the identity."""


def branches(fpn):
    """Each bottleneck's last batch norm."""
    return [k for k in fpn.state_dict() if k.endswith(".bn3.weight")]


def calibrated(fpn):
    return [m for m in fpn.modules() if isinstance(m, FrozenBN)]
