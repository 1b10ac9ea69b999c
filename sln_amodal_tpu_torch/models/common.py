"""Shared building blocks of the port's models.

Public functions take and return the JAX package's NHWC layout; the modules
run their convolutions on NCHW views of NHWC memory (PyTorch's
``channels_last``), so moving between the two layouts costs no copy.

Numerical conventions follow the reference graphs: frozen batch norm
(stored statistics applied as a scale and shift), TF-"SAME" pads where the
reference pads with its SamePad2d shim, half-pixel bilinear resizes with no
antialias.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view."""
    return x.permute(0, 2, 3, 1)


class FrozenBatchNorm2d(nn.Module):
    """Inference-mode batch norm on NCHW: y = x * scale + shift with
    scale = weight / sqrt(running_var + eps), shift = bias - mean * scale.

    The statistics are buffers named like ``nn.BatchNorm2d``'s, so the
    reference state_dict loads into it; they are never trained."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        scale = inv.to(x.dtype)
        shift = (self.bias - self.running_mean * inv).to(x.dtype)
        return x * scale[None, :, None, None] + shift[None, :, None, None]


def same_pad_amounts(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-'SAME' pad (before, after) for one spatial dim (the reference's
    SamePad2d rule)."""
    out = math.ceil(size / stride)
    pad = max((out - 1) * stride + kernel - size, 0)
    before = pad // 2
    return before, pad - before


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """TF-'SAME' padding of an NCHW tensor."""
    top, bottom = same_pad_amounts(x.shape[2], kernel, stride)
    left, right = same_pad_amounts(x.shape[3], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Max pool with TF-'SAME' padding on NCHW (pads with -inf)."""
    return F.max_pool2d(pad_same(x, kernel, stride, value=-math.inf), kernel, stride)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def subsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Stride-2 subsample of an NCHW tensor (the reference's
    MaxPool2d(kernel=1, stride=2) for FPN P6)."""
    return x[:, :, ::2, ::2]


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC [B, H, W, C] with half-pixel centers and no
    antialias, for up- and downscale (``align_corners=False``); computes in
    the input's dtype."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(nchw(x), size=tuple(size), mode="bilinear", align_corners=False)
    return nhwc(y)


def resize_bilinear_2d(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """:func:`resize_bilinear` for a channel-less [B, H, W] map."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x[:, None], size=tuple(size), mode="bilinear", align_corners=False)
    return y[:, 0]
