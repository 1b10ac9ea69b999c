"""Batched FPN RoIAlign and its gradient: the CUDA kernels' launches and
the wrappers the model calls.

:func:`pyramid_roi_align` calls the custom op ``sln_amodal::roi_align``
and :func:`pyramid_roi_align_backward` the op ``sln_amodal::roi_align_backward``
(``ops/library.py``, which also registers the first one's gradient as the
second):

- forward: a CUDA tensor goes to :func:`launch_roi_align`, the hand-written
  kernel ``csrc/roi_align.cu`` (the port of the TPU kernel
  ``sln_amodal_tpu/ops/roi_patch_pallas.py::_patch_kernel``), a CPU tensor
  to the plain version :func:`.roi_align.pyramid_roi_align_plain`;
- backward (the JAX package's custom VJP, ``ops/roi_align.py:650-673``): a
  CUDA tensor goes to :func:`launch_roi_align_backward`, the deterministic
  kernel ``csrc/roi_align_backward.cu``, a CPU tensor to
  :func:`.roi_align.pyramid_roi_align_backward_plain`; the boxes get no
  gradient (the JAX VJP gives zeros, and the model detaches the ROIs).

There is no fallback from a kernel to its plain version. Both kernels
compute their own sampling geometry from the boxes (the plain version's
:func:`.roi_align.sample_geometry`, bit for bit as the card computes it,
from the shared ``csrc/roi_align_geometry.cuh``), so each call is one launch
and the launch function adds only its checks and the outputs' allocation.
Under ``torch.no_grad``, or when no level requires a gradient, the forward
is the one launch and nothing is saved for a backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..cuda_build import DOUBLE, FLOAT, INT, VOIDP, CudaKernel

ROI_ALIGN_KERNEL = CudaKernel("roi_align.cu", {
    "roi_align_batched": (VOIDP, VOIDP, VOIDP, INT, INT, INT, INT, INT, INT,
                          VOIDP, INT, DOUBLE, FLOAT, FLOAT, DOUBLE, INT, VOIDP,
                          VOIDP),
})
ROI_ALIGN_BACKWARD_KERNEL = CudaKernel("roi_align_backward.cu", {
    "roi_align_backward_batched": (VOIDP, VOIDP, VOIDP, INT, INT, INT, INT, INT, INT,
                                   VOIDP, INT, DOUBLE, FLOAT, FLOAT, VOIDP, INT, INT,
                                   INT, VOIDP),
})

MAX_LEVELS = 4
# the kernels' feature dtype codes (csrc/roi_align_geometry.cuh)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# the backward kernel's block: 256 threads, one row buffer of float32
# [widest level, channel chunk] in shared memory, ROIs scanned 256 at a time
BACKWARD_THREADS = 256
BACKWARD_SMEM_BYTES = 160 * 1024


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


def _check_inputs(features: Sequence[torch.Tensor], boxes: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
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
    if dtype not in DTYPE_CODES:
        raise ValueError(f"features must be float32, float64 or bfloat16, got {dtype}")
    c = features[0].shape[-1]
    for f in features:
        if f.device != boxes.device or f.dtype != dtype:
            raise ValueError("levels must share the boxes' device and one dtype")
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"level must be [B={b}, H, W, C={c}], got {tuple(f.shape)}")
        if not f.is_contiguous():
            raise ValueError("levels must be contiguous NHWC tensors")
    # the kernels move channels as 16-byte vectors
    vec = 16 // features[0].element_size()
    if c % vec or any(f.data_ptr() % 16 for f in features):
        raise ValueError(f"C must be a multiple of {vec} and the levels 16-byte aligned")


def launch_roi_align(
    features: List[torch.Tensor],
    boxes: torch.Tensor,
    crop_size: Sequence[int],
    image_shape: Sequence[int],
    extrapolation_value: float,
) -> torch.Tensor:
    """The forward kernel on CUDA tensors (the op's CUDA implementation):
    checks, the output, one launch. Returns [B, N, ch, cw, C]."""
    _check_inputs(features, boxes)
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    ch, cw = crop_size
    boxes = boxes.contiguous()
    out = torch.empty((b, n, ch, cw, c), dtype=dtype, device=boxes.device)
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
        _step_reciprocal(cw), float(extrapolation_value), DTYPE_CODES[dtype], out.data_ptr())
    ROI_ALIGN_KERNEL.launches += 1
    return out


def backward_chunk(c: int, w_max: int, ch: int, cw: int) -> Tuple[int, int]:
    """(channels per block, ROIs per scan pass) of the backward kernel: up to
    64 channels (a power of two dividing the block), halved until the row
    buffer, the column taps and the pass's entries fit the shared memory."""
    rois = max(1, min(BACKWARD_THREADS, 4096 // max(ch, 1)))
    chunk = min(64, 1 << max(0, (c - 1).bit_length()))
    fixed = cw * 16 + rois * 12 + rois * ch * 8
    while chunk > 1 and w_max * chunk * 4 + fixed > BACKWARD_SMEM_BYTES:
        chunk //= 2
    if w_max * chunk * 4 + fixed > BACKWARD_SMEM_BYTES:
        raise ValueError(f"a level {w_max} wide with crop {ch}x{cw} does not fit the "
                         "backward kernel's shared memory")
    return chunk, rois


def launch_roi_align_backward(
    grad: torch.Tensor,
    boxes: torch.Tensor,
    heights: Sequence[int],
    widths: Sequence[int],
    crop_size: Sequence[int],
    image_shape: Sequence[int],
    dtype: torch.dtype,
) -> List[torch.Tensor]:
    """The backward kernel on CUDA tensors (the op's CUDA implementation):
    the gradient into each level, [B, H_l, W_l, C] of ``dtype``, from grad
    [B, N, ch, cw, C]; deterministic (bit-equal across launches)."""
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    b, n = boxes.shape[:2]
    c = grad.shape[-1]
    ch, cw = crop_size
    grads = [torch.empty((b, h, w, c), dtype=dtype, device=boxes.device)
             for h, w in zip(heights, widths)]
    if b == 0 or c == 0:
        return grads
    _check_inputs(grads, boxes)
    if tuple(grad.shape) != (b, n, ch, cw, c) or grad.dtype != dtype:
        raise ValueError(f"grad must be [{b}, {n}, {ch}, {cw}, {c}] of {dtype}, got "
                         f"{tuple(grad.shape)} of {grad.dtype}")
    if n == 0:
        for g in grads:
            g.zero_()
        return grads
    grad = grad.contiguous()
    if grad.data_ptr() % 16:
        raise ValueError("grad must be 16-byte aligned")
    boxes = boxes.contiguous()
    chunk, rois = backward_chunk(c, max(widths), ch, cw)
    ptrs = (ctypes.c_void_p * MAX_LEVELS)(*[g.data_ptr() for g in grads])
    c_heights = (ctypes.c_int * MAX_LEVELS)(*[int(h) for h in heights])
    c_widths = (ctypes.c_int * MAX_LEVELS)(*[int(w) for w in widths])
    ROI_ALIGN_BACKWARD_KERNEL.launch(
        "roi_align_backward_batched", boxes.device, ctypes.addressof(ptrs),
        ctypes.addressof(c_heights), ctypes.addressof(c_widths), len(grads), c, b, n,
        ch, cw, boxes.data_ptr(), int(boxes.dtype == torch.float64),
        level_scale_reciprocal(tuple(image_shape), boxes.dtype), _step_reciprocal(ch),
        _step_reciprocal(cw), grad.data_ptr(), DTYPE_CODES[dtype], chunk, rois)
    ROI_ALIGN_BACKWARD_KERNEL.launches += 1
    return grads


def pyramid_roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    crop_size: Tuple[int, int],
    image_shape: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """Multi-level RoIAlign: features [B, H_l, W_l, C] (P2..P5, NHWC,
    contiguous, 16-byte aligned, float32, float64 or bfloat16; on the card
    C a multiple of 4 in float32, of 2 in float64, of 8 in bfloat16), boxes
    [B, N, 4] normalized (float32 or float64, whatever the features' dtype).
    Returns [B, N, ch, cw, C] in the features' dtype, differentiable in the
    features."""
    return torch.ops.sln_amodal.roi_align.default(
        list(features), boxes, [int(s) for s in crop_size], [int(s) for s in image_shape],
        float(extrapolation_value))


def pyramid_roi_align_backward(
    grad: torch.Tensor,
    boxes: torch.Tensor,
    shapes: Sequence[Tuple[int, int, int]],
    crop_size: Tuple[int, int],
    image_shape: Tuple[int, int],
    dtype: torch.dtype,
) -> Tuple[torch.Tensor, ...]:
    """Gradient into each level ([B, H_l, W_l, C] of ``dtype`` for each
    (H_l, W_l, C) of ``shapes``; C is grad's) from grad [B, N, ch, cw, C]:
    the kernel on the card, the plain version on the CPU."""
    return tuple(torch.ops.sln_amodal.roi_align_backward.default(
        grad, boxes, [int(h) for h, _, _ in shapes], [int(w) for _, w, _ in shapes],
        [int(s) for s in crop_size], [int(s) for s in image_shape], dtype))
