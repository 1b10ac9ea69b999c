"""DeepLabV2-ResNet101-MSC, the frozen "GLM" semantic prior, with the
reference's state_dict names.

As in the JAX package's ``models/deeplab.py``:

- dilated ResNet-101 at output stride 8 (layer4 dilation 2, layer5
  dilation 4), the stride on the 1x1 ``reduce`` conv, frozen BN eps 1e-5;
- ASPP: the sum of four 3x3 convs at atrous rates 6/12/18/24 (with bias);
- multi-scale inference at scales (1.0, 0.5, 0.75): logits bilinearly
  resized to the full-scale logit grid and fused by pixel max.

The dilated convs are cuDNN's; the JAX package's TPU forms of them
(space-to-batch, tap matmuls, the fused 36-tap ASPP matmul) compute the
same function and are not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import FrozenBatchNorm2d, nchw, nhwc, resize_bilinear


class ConvBN(nn.Module):
    """conv (no bias) + frozen BN (eps 1e-5) [+ relu], on NCHW."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                              dilation=dilation, bias=False)
        self.bn = FrozenBatchNorm2d(cout, eps=1e-5)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.relu(y) if self.relu else y


class DLBottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, dilation: int,
                 downsample: bool):
        super().__init__()
        mid = cout // 4
        self.reduce = ConvBN(cin, mid, 1, stride)
        self.conv3x3 = ConvBN(mid, mid, 3, 1, dilation, dilation)
        self.increase = ConvBN(mid, cout, 1, relu=False)
        self.shortcut = ConvBN(cin, cout, 1, stride, relu=False) if downsample else None

    def forward(self, x):
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(self.increase(self.conv3x3(self.reduce(x))) + sc)


class DLResLayer(nn.Module):
    """Blocks named block1..blockN, as in the reference."""

    def __init__(self, n_layers: int, cin: int, cout: int, stride: int, dilation: int):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"block{i + 1}", DLBottleneck(
                cin if i == 0 else cout, cout, stride if i == 0 else 1,
                dilation, downsample=(i == 0)))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"block{i + 1}")(x)
        return x


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBN(3, 64, 7, 2, 3, 1)

    def forward(self, x):
        y = self.conv1(x)
        return F.max_pool2d(y, 3, stride=2, padding=1, ceil_mode=True)


class ASPP(nn.Module):
    def __init__(self, cin: int, n_classes: int, rates: Sequence[int] = (6, 12, 18, 24)):
        super().__init__()
        self.n_rates = len(rates)
        for i, r in enumerate(rates):
            setattr(self, f"c{i}", nn.Conv2d(cin, n_classes, 3, padding=r, dilation=r))

    def forward(self, x):
        out = self.c0(x)
        for i in range(1, self.n_rates):
            out = out + getattr(self, f"c{i}")(x)
        return out


class DeepLabV2(nn.Module):
    """NCHW images -> NCHW logits at output stride 8."""

    def __init__(self, n_classes: int = 182, n_blocks: Tuple[int, ...] = (3, 4, 23, 3)):
        super().__init__()
        self.layer1 = Stem()
        self.layer2 = DLResLayer(n_blocks[0], 64, 256, 1, 1)
        self.layer3 = DLResLayer(n_blocks[1], 256, 512, 2, 1)
        self.layer4 = DLResLayer(n_blocks[2], 512, 1024, 1, 2)
        self.layer5 = DLResLayer(n_blocks[3], 1024, 2048, 1, 4)
        self.aspp = ASPP(2048, n_classes)

    def forward(self, x):
        y = self.layer1(x)
        y = self.layer5(self.layer4(self.layer3(self.layer2(y))))
        return self.aspp(y)


class DeepLabV2MSC(nn.Module):
    """Multi-scale fusion wrapper: NHWC images [B, H, W, 3] -> float32 NHWC
    logits [B, h, w, n_classes] on the full-scale grid."""

    def __init__(self, n_classes: int = 182, scales: Tuple[float, ...] = (0.5, 0.75)):
        super().__init__()
        self.base = DeepLabV2(n_classes)
        self.scales = tuple(scales)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = nhwc(self.base(nchw(x)))
        out_hw = tuple(logits.shape[1:3])
        fused = logits.to(torch.float32)
        h, w = x.shape[1:3]
        for p in self.scales:
            xs = resize_bilinear(x, (int(h * p), int(w * p)))
            ls = nhwc(self.base(nchw(xs)))
            fused = torch.maximum(fused, resize_bilinear(ls, out_hw).to(torch.float32))
        return fused
