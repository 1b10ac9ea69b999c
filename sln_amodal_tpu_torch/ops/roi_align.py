"""Crop-and-resize (RoIAlign): sampling geometry and the plain PyTorch versions.

TF-legacy crop_and_resize semantics, as in the reference CUDA kernel and the
JAX package's ``ops/roi_align.py``: normalized (y1, x1, y2, x2) boxes, sample
coordinates scaled by ``(dim - 1)``, bilinear interpolation, the
extrapolation value outside the map. FPN levels follow the FPN paper's rule.

- :func:`sample_geometry` — the per-sample geometry of the plain version;
  the CUDA kernel (``csrc/roi_align.cu``) computes the same geometry itself,
  bit for bit as the card computes these PyTorch ops.
- :func:`pyramid_roi_align_plain` — port of ``pyramid_roi_align_gather_batched``,
  the exact oracle of the TPU RoIAlign kernel.
- :func:`crop_and_resize` — single-map crop (the GLM-prior crop of the mask
  head), computed outside any kernel in the JAX package too.

The geometry is float32 whatever the box dtype, as in the reference. Its
arithmetic is written out as XLA compiles the JAX reference's (jitted, as its
model runs): the division by ``out_size - 1`` becomes a product with the
float32 reciprocal, and ``lo * dim1 + step * scale`` one fused multiply-add
(evaluated exactly through float64 here). Spelling both out keeps the sample
positions of the two packages bit-identical; an ulp there moves a sample by
up to 1e-5 of a cell, which the float64 parity tests would see.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

F32 = torch.float32


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (the product of two float32
    values is exact in float64)."""
    return (a.double() * b.double() + c.double()).to(F32)


def _coords(lo: torch.Tensor, hi: torch.Tensor, out_size: int, dim1) -> torch.Tensor:
    """[N, out_size] float32 sample coordinates along one axis; lo/hi [N]
    normalized edges, dim1 the (pixel extent - 1), scalar or [N]."""
    if out_size > 1:
        recip = float(np.float32(1.0) / np.float32(out_size - 1))
        scale = (hi - lo) * dim1 * recip
        steps = torch.arange(out_size, dtype=F32, device=lo.device)
        start = lo * dim1
        return _fma_f32(steps[None, :], scale[:, None], start[:, None])
    return (0.5 * (lo + hi) * dim1)[:, None]


def roi_levels(boxes: torch.Tensor, image_area: float, min_level: int = 2,
               max_level: int = 5) -> torch.Tensor:
    """FPN-paper level of each normalized box [N, 4], in the boxes' dtype:
    round(4 + log2(sqrt(hw) / (224 / sqrt(area)))) clamped to
    [min_level, max_level]; round() is half-to-even."""
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    size = torch.sqrt(torch.clamp_min(h * w, 1e-12))
    lvl = 4.0 + torch.log2(size / (224.0 / math.sqrt(image_area)))
    return torch.clamp(torch.round(lvl), min_level, max_level).to(torch.int32)


def sample_geometry(shapes, boxes: torch.Tensor, crop_size, image_shape):
    """Sampling geometry of boxes [N, 4] over pyramid levels of ``shapes``
    ((H_l, W_l, ...) per level).

    Returns (lvl_idx [N] int64, valid_y [N, ch] bool, valid_x [N, cw] bool,
    top, bottom, y_lerp [N, ch] f32, left, right, x_lerp [N, cw] f32), the
    corner indices clamped to the level and held as float32 integers."""
    ch, cw = crop_size
    dev = boxes.device
    heights = torch.tensor([float(s[0]) for s in shapes], dtype=F32, device=dev)
    widths = torch.tensor([float(s[1]) for s in shapes], dtype=F32, device=dev)

    lvl = roi_levels(boxes, float(image_shape[0] * image_shape[1]))
    lvl_idx = torch.clamp(lvl - 2, 0, len(shapes) - 1).long()
    h_l = heights[lvl_idx]
    w_l = widths[lvl_idx]

    boxes = boxes.to(F32)
    y1, x1, y2, x2 = boxes.unbind(1)
    in_y = _coords(y1, y2, ch, h_l - 1.0)
    in_x = _coords(x1, x2, cw, w_l - 1.0)
    hmax = (h_l - 1.0)[:, None]
    wmax = (w_l - 1.0)[:, None]
    valid_y = (in_y >= 0) & (in_y <= hmax)
    valid_x = (in_x >= 0) & (in_x <= wmax)
    zero = torch.zeros((), dtype=F32, device=dev)
    top = torch.minimum(torch.maximum(torch.floor(in_y), zero), hmax)
    bottom = torch.minimum(torch.maximum(torch.ceil(in_y), zero), hmax)
    y_lerp = in_y - torch.floor(in_y)
    left = torch.minimum(torch.maximum(torch.floor(in_x), zero), wmax)
    right = torch.minimum(torch.maximum(torch.ceil(in_x), zero), wmax)
    x_lerp = in_x - torch.floor(in_x)
    return lvl_idx, valid_y, valid_x, top, bottom, y_lerp, left, right, x_lerp


def pyramid_roi_align_plain(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    crop_size: Tuple[int, int],
    image_shape: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """Multi-level RoIAlign over a batch of FPN pyramids, as one gather.

    features: [B, H_l, W_l, C] maps ordered P2, P3, ...; boxes [B, N, 4]
    normalized. Returns [B, N, ch, cw, C]. The lerp runs in the feature
    dtype in the order of the reference gather path."""
    b, n = boxes.shape[:2]
    shapes = [tuple(f.shape[1:]) for f in features]
    c = shapes[0][-1]
    dev = boxes.device
    sizes = [int(sh[0] * sh[1]) for sh in shapes]
    total = int(sum(sizes))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                           dtype=torch.int64, device=dev)
    widths = torch.tensor([int(sh[1]) for sh in shapes], dtype=torch.int64,
                          device=dev)

    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1).reshape(b * total, c)

    (lvl_idx, valid_y, valid_x, top, bottom, y_lerp, left, right,
     x_lerp) = sample_geometry(shapes, boxes.reshape(b * n, 4), crop_size, image_shape)

    wl_i = widths[lvl_idx][:, None, None]
    img_off = torch.arange(b, device=dev).repeat_interleave(n) * total
    off_i = (offsets[lvl_idx] + img_off)[:, None, None]
    y_lerp = y_lerp.to(flat.dtype)
    x_lerp = x_lerp.to(flat.dtype)

    def flat_idx(yy, xx):
        return off_i + yy.long()[:, :, None] * wl_i + xx.long()[:, None, :]

    tl = flat[flat_idx(top, left)]
    tr = flat[flat_idx(top, right)]
    bl = flat[flat_idx(bottom, left)]
    br = flat[flat_idx(bottom, right)]

    top_v = tl + (tr - tl) * x_lerp[:, None, :, None]
    bot_v = bl + (br - bl) * x_lerp[:, None, :, None]
    out = top_v + (bot_v - top_v) * y_lerp[:, :, None, None]

    valid = valid_y[:, :, None, None] & valid_x[:, None, :, None]
    out = torch.where(valid, out, torch.full((), extrapolation_value,
                                             dtype=flat.dtype, device=dev))
    return out.reshape(b, n, *out.shape[1:])


def crop_and_resize(
    image: torch.Tensor,
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """Bilinear crop-and-resize from one feature map.

    image [B, H, W, C] (NHWC); boxes [N, 4] normalized (y1, x1, y2, x2);
    box_indices [N], the image each box samples. Returns [N, ch, cw, C]."""
    _, h, w, _ = image.shape
    ch, cw = crop_size
    boxes = boxes.to(F32)
    y1, x1, y2, x2 = boxes.unbind(1)

    in_y = _coords(y1, y2, ch, float(h) - 1.0)
    in_x = _coords(x1, x2, cw, float(w) - 1.0)
    valid_y = (in_y >= 0) & (in_y <= h - 1)
    valid_x = (in_x >= 0) & (in_x <= w - 1)

    top = torch.floor(in_y)
    bottom = torch.ceil(in_y)
    y_lerp = (in_y - top).to(image.dtype)
    left = torch.floor(in_x)
    right = torch.ceil(in_x)
    x_lerp = (in_x - left).to(image.dtype)

    top = torch.clamp(top, 0, h - 1).long()
    bottom = torch.clamp(bottom, 0, h - 1).long()
    left = torch.clamp(left, 0, w - 1).long()
    right = torch.clamp(right, 0, w - 1).long()

    bi = box_indices.long()[:, None, None]

    def gather(yy, xx):
        return image[bi, yy[:, :, None], xx[:, None, :], :]

    tl = gather(top, left)
    tr = gather(top, right)
    bl = gather(bottom, left)
    br = gather(bottom, right)

    top_v = tl + (tr - tl) * x_lerp[:, None, :, None]
    bot_v = bl + (br - bl) * x_lerp[:, None, :, None]
    out = top_v + (bot_v - top_v) * y_lerp[:, :, None, None]

    valid = valid_y[:, :, None, None] & valid_x[:, None, :, None]
    return torch.where(valid, out, torch.full((), extrapolation_value,
                                              dtype=image.dtype, device=image.device))
