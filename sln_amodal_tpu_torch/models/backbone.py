"""The trunk by ``Config.backbone``: ResNet + FPN neck, with the reference's
state_dict names, or a Swin Transformer (``models/swin.py``) on the same
neck (:func:`build_trunk`).

The Matterport-style graph of the reference, as in the JAX package's
``models/backbone.py``:

- the bottleneck puts its stride on the **1x1** conv, not the 3x3;
- 3x3 convs pad 1 (TF-'SAME' at stride 1); the stem conv pads 3;
- the stem max pool pads TF-'SAME' (asymmetric at stride 2);
- all BN is frozen, eps 1e-3;
- FPN: lateral 1x1 + nearest 2x top-down + 3x3 smooth; P6 is a stride-2
  subsample of P5.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv2d, FPNNeck, FrozenBatchNorm2d, max_pool_same, nchw
from .swin import SWIN_SIZES, SwinFPN

RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, stride=stride)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (
            nn.Sequential(Conv2d(inplanes, planes * 4, 1, stride=stride),
                          FrozenBatchNorm2d(planes * 4))
            if downsample else None
        )

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


def make_stage(inplanes: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    layers = [Bottleneck(inplanes, planes, stride, downsample=True)]
    layers += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNetFPN(FPNNeck):
    """Backbone + neck: NHWC images [B, H, W, 3] -> (P2, P3, P4, P5, P6),
    each NHWC [B, H/s, W/s, out_channels]."""

    def __init__(self, architecture: str = "resnet101", out_channels: int = 256):
        super().__init__()
        blocks = RESNET_BLOCKS[architecture]
        self.C1 = nn.Sequential(Conv2d(3, 64, 7, stride=2, padding=3),
                                FrozenBatchNorm2d(64))
        self.C2 = make_stage(64, 64, blocks[0], 1)
        self.C3 = make_stage(256, 128, blocks[1], 2)
        self.C4 = make_stage(512, 256, blocks[2], 2)
        self.C5 = make_stage(1024, 512, blocks[3], 2)
        self.add_neck((256, 512, 1024, 2048), out_channels)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = F.relu(self.C1(nchw(x)))
        y = max_pool_same(y, kernel=3, stride=2)
        c2 = self.C2(y)
        c3 = self.C3(c2)
        c4 = self.C4(c3)
        return self.neck(c2, c3, c4, self.C5(c4))


def build_trunk(backbone: str, out_channels: int) -> FPNNeck:
    """The trunk and FPN neck that ``backbone`` names."""
    if backbone in RESNET_BLOCKS:
        return ResNetFPN(backbone, out_channels)
    if backbone in SWIN_SIZES:
        return SwinFPN(SWIN_SIZES[backbone], out_channels)
    raise ValueError(f"unknown backbone {backbone!r}; known: "
                     f"{sorted(RESNET_BLOCKS) + sorted(SWIN_SIZES)}")
