"""The FPN neck that the trunks share: laterals, the top-down path, the
smoothing convs and P6, on a trunk's outputs C2..C5, and its FLOP layers."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.nn.functional as F
from torch import nn

from h100bench.flops import Layer, conv_flops
from h100bench.reference.model import Conv2d, nhwc

PART = "trunk_fpn"


class FPN(nn.Module):
    """Base of a trunk's network. A subclass builds its trunk, then calls
    :meth:`add_neck` (so the state dict lists the trunk first) and returns
    :meth:`neck` of its C2..C5 (NCHW) from ``forward``."""

    def add_neck(self, channels: Sequence[int], out: int) -> None:
        for lvl, cin in zip(range(2, 6), channels):
            setattr(self, f"P{lvl}_conv1", Conv2d(cin, out, 1))
            setattr(self, f"P{lvl}_conv2", nn.Sequential(nn.Identity(),
                                                         Conv2d(out, out, 3, padding=1)))

    def neck(self, c2, c3, c4, c5):
        """NHWC P2..P6."""
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        p5 = self.P5_conv1(c5)
        p4 = self.P4_conv1(c4) + up(p5)
        p3 = self.P3_conv1(c3) + up(p4)
        p2 = self.P2_conv1(c2) + up(p3)
        outs = [self.P2_conv2(p2), self.P3_conv2(p3), self.P4_conv2(p4), self.P5_conv2(p5)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return [nhwc(p) for p in outs]


def neck_layers(sizes: Sequence[Tuple[int, int, bool]], out: int,
                trained: bool) -> Tuple[list, list]:
    """(layers, level sizes P2..P6) of the neck over C2..C5 given as (size,
    channels, whether a gradient reaches it); ``trained``: the neck's
    weights train."""
    layers = []
    for n, ch, grad in sizes:
        layers += [Layer(conv_flops(n, n, ch, out, 1), PART, trained, grad),
                   Layer(conv_flops(n, n, out, out, 3), PART, trained, trained)]
    levels = [n for n, _, _ in sizes] + [math.ceil(sizes[-1][0] / 2)]
    return layers, levels
