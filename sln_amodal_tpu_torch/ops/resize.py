"""Squash resize of uint8 frames: Pillow's fixed-point bilinear, the plain
PyTorch version.

``PIL.Image.resize(size, Image.BILINEAR)`` on an 8-bit image (Pillow's
``libImaging/Resample.c``) is separable and exact in integers once its
coefficient tables are made:

- for each axis, output index ``i`` reads input indices ``[lo, lo + n)``
  with weights made in float64 (``center = (i + 0.5) * scale``, a tent of
  support ``max(scale, 1)``, normalised by its sum) and rounded to int32 at
  ``PRECISION_BITS`` (:func:`coefficients`);
- the horizontal pass runs first, into a uint8 intermediate:
  ``clip((2**21 + sum(px * k)) >> 22, 0, 255)``; the vertical pass then
  runs on that intermediate in the same integer form.

So the float work is all in the tables, made on the host, and a resize
that does this integer arithmetic on those tables equals Pillow's bit for
bit. The op ``sln_amodal::resize_bilinear_u8`` (``ops/library.py``) takes a
batch of raw HWC frames packed back to back in one uint8 buffer, a table of
(byte offset, height, width) per frame, and the output side ``S``, and
returns ``[N, S, S, 3]`` uint8: :func:`resize_bilinear_u8_plain` here is
its CPU implementation, the CUDA kernel ``csrc/resize_bilinear.cu``
(``ops/resize_cuda.py``) its CUDA one.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

PRECISION_BITS = 22
CHANNELS = 3


@functools.lru_cache(maxsize=64)
def coefficients(in_len: int, out_len: int) -> np.ndarray:
    """Pillow's bilinear coefficient table from ``in_len`` to ``out_len``
    samples: int32 ``[out_len, 2 + ksize]``, each row ``(lo, n, k_0 ..
    k_{ksize-1})``, the weights past ``n`` zero; ``ksize = 2 * ceil(support)
    + 1``. ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` vectorised:
    the same float64 operations in the same order. Read-only (cached)."""
    scale = in_len / out_len
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_len) + 0.5) * scale
    # (int) in C truncates toward zero
    lo = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    n = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_len) - lo
    taps = np.arange(ksize)
    arg = ((taps[None] + lo[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)
    weights = np.where(taps[None] < n[:, None], np.maximum(1.0 - np.abs(arg), 0.0), 0.0)
    total = np.zeros(out_len)
    for t in range(ksize):          # Pillow's running sum, in its order
        total = total + weights[:, t]
    weights = np.where(total[:, None] != 0.0, weights / np.where(total == 0.0, 1.0, total)[:, None],
                       weights)
    scaled = weights * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(scaled < 0, scaled - 0.5, scaled + 0.5)).astype(np.int32)
    table = np.concatenate([lo[:, None].astype(np.int32), n[:, None].astype(np.int32), fixed], 1)
    table.flags.writeable = False
    return table


def _pass(x: torch.Tensor, table: np.ndarray, dim: int) -> torch.Tensor:
    """One axis of the resample on int32 values ``x`` along ``dim``: Pillow's
    ``ImagingResample{Horizontal,Vertical}_8bpc``, clipped to 0..255."""
    t = torch.tensor(table, device=x.device)
    lo, k = t[:, 0].long(), t[:, 2:]
    shape = [1] * x.dim()
    shape[dim] = t.shape[0]
    acc = None
    for tap in range(k.shape[1]):
        # a tap past n has weight 0: its clamped index reads a real sample
        picked = x.index_select(dim, (lo + tap).clamp_max(x.shape[dim] - 1))
        term = picked * k[:, tap].view(shape)
        acc = term if acc is None else acc + term
    return ((acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS).clamp_(0, 255)


def resize_bilinear_plain(frame: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """One uint8 frame ``[h, w, c]`` -> ``[out_h, out_w, c]`` uint8, equal to
    ``PIL.Image.resize((out_w, out_h), Image.BILINEAR)``."""
    h, w = frame.shape[:2]
    mid = _pass(frame.to(torch.int32), coefficients(w, out_w), 1)
    return _pass(mid, coefficients(h, out_h), 0).to(torch.uint8)


def resize_bilinear_u8_plain(packed: torch.Tensor, table: torch.Tensor, size: int) -> torch.Tensor:
    """The op on the CPU: each frame of ``packed`` (uint8, HWC back to back;
    ``table`` int64 ``[N, 3]`` of byte offset, height, width) squash-resized
    to ``size`` squared, ``[N, size, size, 3]`` uint8."""
    out = torch.empty((table.shape[0], size, size, CHANNELS), dtype=torch.uint8,
                      device=packed.device)
    for i, (offset, h, w) in enumerate(table.tolist()):
        frame = packed[offset:offset + h * w * CHANNELS].view(h, w, CHANNELS)
        out[i] = resize_bilinear_plain(frame, size, size)
    return out
