"""Batched FPN RoIAlign: the CUDA kernel's wrapper.

A CUDA tensor goes to the hand-written kernel ``csrc/roi_align.cu`` (the port
of the TPU kernel ``sln_amodal_tpu/ops/roi_patch_pallas.py::_patch_kernel``);
a CPU tensor goes to the plain version :func:`.roi_align.pyramid_roi_align_plain`.
There is no fallback from one to the other. The kernel computes its own
sampling geometry from the boxes (the plain version's
:func:`.roi_align.sample_geometry`, bit for bit as the card computes it), so
a call is one launch and the wrapper adds only its checks and the output's
allocation.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..cuda_build import DOUBLE, FLOAT, INT, VOIDP, CudaKernel
from .roi_align import pyramid_roi_align_plain

ROI_ALIGN_KERNEL = CudaKernel("roi_align.cu", {
    "roi_align_batched": (VOIDP, VOIDP, VOIDP, INT, INT, INT, INT, INT, INT,
                          VOIDP, INT, DOUBLE, FLOAT, FLOAT, DOUBLE, INT, VOIDP,
                          VOIDP),
})

MAX_LEVELS = 4


@functools.lru_cache(maxsize=None)
def level_scale_reciprocal(image_shape: Tuple[int, int], dtype: torch.dtype) -> float:
    """The factor by which ``roi_levels``' division ``size / (224 /
    sqrt(area))`` multiplies on the card: ATen's true division by a CPU
    scalar multiplies by the scalar's float64 reciprocal, rounded to the
    tensor's dtype (held on the card by
    ``test_torch_cuda.py::test_level_rule_divides_as_the_kernel_multiplies``)."""
    inv = 1.0 / (224.0 / math.sqrt(float(image_shape[0] * image_shape[1])))
    return float(np.float32(inv)) if dtype == torch.float32 else inv


@functools.lru_cache(maxsize=None)
def _step_reciprocal(out_size: int) -> float:
    """float32 1 / (out_size - 1), as ``roi_align._coords`` scales by it."""
    return float(np.float32(1.0) / np.float32(out_size - 1)) if out_size > 1 else 0.0


def pyramid_roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    crop_size: Tuple[int, int],
    image_shape: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """Multi-level RoIAlign: features [B, H_l, W_l, C] (P2..P5, NHWC,
    contiguous, 16-byte aligned, float32 or float64; on the card C a
    multiple of 4 in float32, of 2 in float64), boxes [B, N, 4] normalized (float32 or
    float64, whatever the features' dtype). Returns [B, N, ch, cw, C]."""
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
    if boxes.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"boxes must be float32 or float64, got {boxes.dtype}")
    b, n = boxes.shape[:2]
    dtype = features[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"features must be float32 or float64, got {dtype}")
    c = features[0].shape[-1]
    for f in features:
        if f.device != boxes.device or f.dtype != dtype:
            raise ValueError("levels must share the boxes' device and one dtype")
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"level must be [B={b}, H, W, C={c}], got {tuple(f.shape)}")
        if not f.is_contiguous():
            raise ValueError("levels must be contiguous NHWC tensors")
    ch, cw = crop_size
    boxes = boxes.contiguous()
    out = torch.empty((b, n, ch, cw, c), dtype=dtype, device=boxes.device)
    # the kernel moves channels as 16-byte vectors
    vec = 16 // out.element_size()
    if c % vec or any(t.data_ptr() % 16 for t in features + [out]):
        raise ValueError(f"C must be a multiple of {vec} and the levels 16-byte aligned")
    if b * n == 0 or c == 0:
        return out
    ptrs = (ctypes.c_void_p * MAX_LEVELS)(*[f.data_ptr() for f in features])
    heights = (ctypes.c_int * MAX_LEVELS)(*[int(f.shape[1]) for f in features])
    widths = (ctypes.c_int * MAX_LEVELS)(*[int(f.shape[2]) for f in features])
    ROI_ALIGN_KERNEL.launch(
        "roi_align_batched", boxes.device, ctypes.addressof(ptrs),
        ctypes.addressof(heights), ctypes.addressof(widths), len(features), c, b, n,
        ch, cw, boxes.data_ptr(), int(boxes.dtype == torch.float64),
        level_scale_reciprocal(tuple(image_shape), boxes.dtype), _step_reciprocal(ch),
        _step_reciprocal(cw), float(extrapolation_value), int(dtype == torch.float64),
        out.data_ptr())
    ROI_ALIGN_KERNEL.launches += 1
    return out
