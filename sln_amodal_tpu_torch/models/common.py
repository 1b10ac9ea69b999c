"""Shared building blocks of the port's models.

Public functions take and return the JAX package's NHWC layout; the modules
run their convolutions on NCHW views of NHWC memory (PyTorch's
``channels_last``), so moving between the two layouts costs no copy.

Numerical conventions follow the reference graphs: frozen batch norm
(stored statistics applied as a scale and shift), TF-"SAME" pads where the
reference pads with its SamePad2d shim, half-pixel bilinear resizes with no
antialias.

Layers compute in their input's dtype, as flax's ``nn.Conv(dtype=...)``
does: :class:`Conv2d`, :class:`ConvTranspose2d` and :class:`Linear` cast
their parameters (float32 or float64) to it at use, a no-op where they
already hold it. In bfloat16 the resizes are the JAX package's two matmuls
with bfloat16 interpolation weights.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: weight and bias cast to it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype: weight and bias cast to it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype),
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype: weight and bias cast to it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last axis in its input's dtype: weight and
    bias cast to it. ATen keeps the mean and variance of a bfloat16 input
    in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, _cast(self.weight, x.dtype),
                            _cast(self.bias, x.dtype), self.eps)


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


class FPNNeck(nn.Module):
    """The FPN neck that every trunk shares: a lateral 1x1 conv on each of
    C2..C5, the nearest 2x top-down path, a 3x3 smooth conv on each sum,
    and P6 as a stride-2 subsample of P5. A trunk subclasses it, builds its
    stages, then calls :meth:`add_neck` (so the state_dict lists the trunk
    first) and returns :meth:`neck` of its C2..C5."""

    def add_neck(self, channels, out_channels: int) -> None:
        """``channels``: the in-channels of C2..C5."""
        for lvl, cin in zip(range(2, 6), channels):
            setattr(self, f"P{lvl}_conv1", Conv2d(cin, out_channels, 1))
            # index 0 is the reference's SamePad2d(3, 1), folded into the
            # conv's symmetric padding 1 (the same pads at stride 1)
            setattr(self, f"P{lvl}_conv2", nn.Sequential(
                nn.Identity(), Conv2d(out_channels, out_channels, 3, padding=1)))

    def neck(self, c2, c3, c4, c5) -> Tuple[torch.Tensor, ...]:
        """NCHW C2..C5 -> NHWC (P2, P3, P4, P5, P6)."""
        p5 = self.P5_conv1(c5)
        p4 = self.P4_conv1(c4) + upsample_nearest_2x(p5)
        p3 = self.P3_conv1(c3) + upsample_nearest_2x(p4)
        p2 = self.P2_conv1(c2) + upsample_nearest_2x(p3)
        p5 = self.P5_conv2(p5)
        p4 = self.P4_conv2(p4)
        p3 = self.P3_conv2(p3)
        p2 = self.P2_conv2(p2)
        p6 = subsample_2x(p5)
        return tuple(nhwc(p) for p in (p2, p3, p4, p5, p6))


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Row-stochastic interpolation matrix [n_out, n_in] (float64) with the
    weights of ``F.interpolate(mode='bilinear', align_corners=False)``:
    src = max((i + 0.5) * n_in / n_out - 0.5, 0), two-tap linear."""
    scale = n_in / n_out
    i = np.arange(n_out)
    src = np.maximum((i + 0.5) * scale - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w = src - i0
    mat = np.zeros((n_out, n_in), np.float64)
    mat[i, i0] += 1.0 - w
    mat[i, i1] += w
    return mat


_RESIZE_WEIGHTS = {}


def _resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """:func:`_resize_matrix` rounded to bfloat16, on ``device``; kept per
    (sizes, device), unless it is the stand-in tensor of a trace (a
    ``torch.export`` fake tensor), which no later call may see."""
    key = (n_in, n_out, device)
    w = _RESIZE_WEIGHTS.get(key)
    if w is None:
        with torch.inference_mode(False):
            w = torch.from_numpy(_resize_matrix(n_in, n_out)).to(device, torch.bfloat16)
        if type(w) is torch.Tensor:
            _RESIZE_WEIGHTS[key] = w
    return w


def _resize_bf16(x: torch.Tensor, size: Tuple[int, int], spec: str) -> torch.Tensor:
    """The JAX package's bfloat16 resize: one matmul per resized axis with
    bfloat16 weights, each rounded to bfloat16 (``spec`` names the axes
    after the batch and the two spatial ones: "c" or "")."""
    h, w = x.shape[1:3]
    oh, ow = size
    if oh != h:
        x = torch.einsum(f"oh,bhw{spec}->bow{spec}", _resize_weights(h, oh, x.device), x)
    if ow != w:
        x = torch.einsum(f"pw,bhw{spec}->bhp{spec}", _resize_weights(w, ow, x.device), x)
    return x


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC [B, H, W, C] with half-pixel centers and no
    antialias, for up- and downscale (``align_corners=False``); computes in
    the input's dtype (bfloat16 as separable matmuls)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    if x.dtype == torch.bfloat16:
        return _resize_bf16(x, size, "c")
    y = F.interpolate(nchw(x), size=tuple(size), mode="bilinear", align_corners=False)
    return nhwc(y)


def resize_bilinear_2d(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """:func:`resize_bilinear` for a channel-less [B, H, W] map."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    if x.dtype == torch.bfloat16:
        return _resize_bf16(x, size, "")
    y = F.interpolate(x[:, None], size=tuple(size), mode="bilinear", align_corners=False)
    return y[:, 0]
