"""Squash resize of raw frames on the card: the CUDA kernel's launch and the
wrapper the detector calls.

:func:`resize_bilinear_u8` calls the custom op
``sln_amodal::resize_bilinear_u8`` (``ops/library.py``): frames packed on a
CUDA device go to :func:`launch_resize_bilinear`, the hand-written kernel
``csrc/resize_bilinear.cu`` (one launch per call of up to
``FRAMES_PER_LAUNCH`` frames); frames on the CPU go to the plain version
:func:`.resize.resize_bilinear_u8_plain`. There is no fallback from one to
the other. The frame table (byte offset, height, width) stays on the host
in both cases: the launch reads it to pick each frame's coefficient tables
and passes each frame's descriptor in the launch's parameters, so only the
raw bytes cross to the card.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..cuda_build import INT, VOIDP, CudaKernel
from .resize import CHANNELS, coefficients

RESIZE_KERNEL = CudaKernel("resize_bilinear.cu", {
    "resize_bilinear": (VOIDP, VOIDP, VOIDP, INT, INT, INT, INT, VOIDP),
})

FRAMES_PER_LAUNCH = 64          # the kernel's kMaxFrames
BAND = 8                        # output rows per block
SHARED_BYTES = 227 * 1024       # the most shared memory a block can have on Hopper

# coefficient tables on each device, uploaded at the first frame of a size
_TABLES: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def resize_bilinear_u8(packed: torch.Tensor, table: torch.Tensor, size: int) -> torch.Tensor:
    """Raw uint8 HWC frames back to back in ``packed`` (on the device that
    resizes them) and their host table, int64 ``[N, 3]`` of byte offset,
    height and width -> ``[N, size, size, 3]`` uint8, each frame squash-resized
    as ``PIL.Image.resize((size, size), Image.BILINEAR)`` resizes it
    (``ops/resize.py`` defines what it computes)."""
    return torch.ops.sln_amodal.resize_bilinear_u8.default(packed, table, int(size))


def device_coefficients(in_len: int, out_len: int, device: torch.device) -> torch.Tensor:
    """:func:`.resize.coefficients` on ``device``, uploaded once per length
    pair and device (a blocking copy: complete before any stream reads it)."""
    key = (in_len, out_len, device)
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = torch.tensor(coefficients(in_len, out_len), device=device)
    return table


@functools.lru_cache(maxsize=256)
def band_rows(in_len: int, out_len: int, band: int) -> int:
    """The most input rows one band of ``band`` output rows reads, from its
    first row's ``lo`` to its last row's ``lo + n``."""
    table = coefficients(in_len, out_len)
    first = np.arange(0, out_len, band)
    last = np.minimum(first + band, out_len) - 1
    return int((table[last, 0] + table[last, 1] - table[first, 0]).max())


def launch_resize_bilinear(packed: torch.Tensor, table: torch.Tensor,
                           size: int) -> torch.Tensor:
    """The kernel on frames packed on a CUDA device (the op's CUDA
    implementation): checks, the output, one launch per
    ``FRAMES_PER_LAUNCH`` frames."""
    if packed.device.type != "cuda":
        raise ValueError(f"packed must be on a CUDA device, got {packed.device}")
    if packed.dtype != torch.uint8 or packed.dim() != 1:
        raise ValueError(f"packed must be a 1-D uint8 tensor, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if (table.device.type != "cpu" or table.dtype != torch.int64 or table.dim() != 2
            or table.shape[1] != 3):
        raise ValueError(f"table must be a CPU int64 [N, 3] tensor, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    if size <= 0:
        raise ValueError(f"size must be positive, got {size}")
    frames = table.numpy()
    offsets, heights, widths = frames[:, 0], frames[:, 1], frames[:, 2]
    if len(frames) and ((heights <= 0).any() or (widths <= 0).any() or (offsets < 0).any()
                        or (offsets + heights * widths * CHANNELS > packed.numel()).any()):
        raise ValueError(f"the frame table {frames.tolist()} does not fit a packed buffer "
                         f"of {packed.numel()} bytes")
    dev = packed.device
    out = torch.empty((len(frames), size, size, CHANNELS), dtype=torch.uint8, device=dev)
    if not len(frames):
        return out
    # a block holds the input rows its band reads (about 8 times the
    # downscale plus the taps: some 75 rows of a 1024-wide frame fit)
    pitch = -(-size * CHANNELS // 16) * 16
    rows = max(band_rows(h, size, BAND) for h in set(heights.tolist()))
    if rows * pitch > SHARED_BYTES:
        raise ValueError(f"a frame of height {heights.max()} reads {rows} rows for {BAND} "
                         f"output rows: more than a block's shared memory holds at size {size}")
    descriptors = np.empty((len(frames), 6), np.int64)
    for i, (offset, h, w) in enumerate(frames.tolist()):
        hcoef, vcoef = device_coefficients(w, size, dev), device_coefficients(h, size, dev)
        descriptors[i] = (offset, hcoef.data_ptr(), vcoef.data_ptr(), w,
                          hcoef.shape[1], vcoef.shape[1])
    packed = packed.contiguous()
    for first in range(0, len(frames), FRAMES_PER_LAUNCH):
        chunk = descriptors[first:first + FRAMES_PER_LAUNCH]
        RESIZE_KERNEL.launch("resize_bilinear", dev, packed.data_ptr(), out[first].data_ptr(),
                             chunk.ctypes.data, len(chunk), size, BAND, rows)
        RESIZE_KERNEL.launches += 1
    return out
