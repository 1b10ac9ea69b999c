"""Batched FPN RoIAlign: the CUDA kernel's wrapper.

A CUDA tensor goes to the hand-written kernel ``csrc/roi_align.cu`` (the port
of the TPU kernel ``sln_amodal_tpu/ops/roi_patch_pallas.py::_patch_kernel``);
a CPU tensor goes to the plain version :func:`.roi_align.pyramid_roi_align_plain`.
There is no fallback from one to the other. Both compute their geometry with
:func:`.roi_align.sample_geometry`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..cuda_build import DOUBLE, INT, VOIDP, CudaKernel
from .roi_align import pyramid_roi_align_plain, sample_geometry

ROI_ALIGN_KERNEL = CudaKernel("roi_align.cu", {
    "roi_align_batched": (VOIDP, VOIDP, VOIDP, INT, INT, INT, INT, INT,
                          VOIDP, VOIDP, VOIDP, VOIDP, VOIDP, VOIDP, VOIDP,
                          VOIDP, VOIDP, DOUBLE, INT, VOIDP, VOIDP),
})

MAX_LEVELS = 4


def pyramid_roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    crop_size: Tuple[int, int],
    image_shape: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """Multi-level RoIAlign: features [B, H_l, W_l, C] (P2..P5, NHWC,
    contiguous), boxes [B, N, 4] normalized. Returns [B, N, ch, cw, C]."""
    features = list(features)
    if boxes.device.type == "cpu":
        return pyramid_roi_align_plain(
            features, boxes, crop_size, image_shape, extrapolation_value)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if not 1 <= len(features) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {len(features)}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, N, 4], got {tuple(boxes.shape)}")
    b, n = boxes.shape[:2]
    dtype = features[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"features must be float32 or float64, got {dtype}")
    c = features[0].shape[-1]
    for f in features:
        if f.device != boxes.device or f.dtype != dtype:
            raise ValueError("levels and boxes must share device and dtype")
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"level must be [B={b}, H, W, C={c}], got {tuple(f.shape)}")
        if not f.is_contiguous():
            raise ValueError("levels must be contiguous NHWC tensors")
    ch, cw = crop_size
    shapes = [tuple(f.shape[1:]) for f in features]
    (lvl_idx, valid_y, valid_x, top, bottom, y_lerp, left, right,
     x_lerp) = sample_geometry(shapes, boxes.reshape(b * n, 4), crop_size, image_shape)
    i32 = torch.int32
    geom = [
        lvl_idx.to(i32), top.to(i32), bottom.to(i32), y_lerp.to(dtype),
        valid_y.to(torch.uint8), left.to(i32), right.to(i32), x_lerp.to(dtype),
        valid_x.to(torch.uint8),
    ]
    geom = [g.contiguous() for g in geom]
    out = torch.empty((b, n, ch, cw, c), dtype=dtype, device=boxes.device)
    if b * n == 0:
        return out
    padded = features + [features[0]] * (MAX_LEVELS - len(features))
    ptrs = (ctypes.c_void_p * MAX_LEVELS)(*[f.data_ptr() for f in padded])
    heights = (ctypes.c_int * MAX_LEVELS)(*[int(f.shape[1]) for f in padded])
    widths = (ctypes.c_int * MAX_LEVELS)(*[int(f.shape[2]) for f in padded])
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        ROI_ALIGN_KERNEL.call(
            "roi_align_batched", ctypes.addressof(ptrs), ctypes.addressof(heights),
            ctypes.addressof(widths), c, b, n, ch, cw,
            *[g.data_ptr() for g in geom], float(extrapolation_value),
            int(dtype == torch.float64), out.data_ptr(), stream)
    ROI_ALIGN_KERNEL.launches += 1
    return out
