"""Batched greedy NMS: the CUDA kernel's launch and the wrapper the model
calls.

:func:`nms_sorted_batched` calls the custom op
``sln_amodal::nms_sorted_batched`` (``ops/library.py``): a CUDA tensor goes
to :func:`launch_nms`, the hand-written kernel ``csrc/nms.cu`` (the port of
the TPU kernel ``sln_amodal_tpu/ops/nms_pallas.py::_nms_kernel``); a CPU
tensor goes to the plain version :func:`.nms.nms_sorted_batched_plain`.
There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ..cuda_build import FLOAT, INT, VOIDP, CudaKernel

NMS_KERNEL = CudaKernel("nms.cu", {
    "nms_sorted_batched": (VOIDP, VOIDP, INT, INT, INT, FLOAT, INT, INT,
                           VOIDP, VOIDP, VOIDP, VOIDP),
})


def nms_sorted_batched(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    max_outputs: int,
    iou_threshold: float,
    suppress_at_equal: bool = False,
    pad_value: int = -1,
):
    """Greedy NMS over score-sorted boxes [B, N, 4] with validity [B, N].

    Returns (keep [B, max_outputs] int32, keep_valid [B, max_outputs] bool),
    the contract of the JAX package's ``nms_sorted_pallas_batched``."""
    return torch.ops.sln_amodal.nms_sorted_batched.default(
        boxes, valid, int(max_outputs), float(iou_threshold), bool(suppress_at_equal),
        int(pad_value))


def launch_nms(boxes: torch.Tensor, valid: torch.Tensor, max_outputs: int,
               iou_threshold: float, suppress_at_equal: bool, pad_value: int):
    """The kernel on CUDA tensors (the op's CUDA implementation): checks,
    outputs and scratch, one launch."""
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, N, 4], got {tuple(boxes.shape)}")
    if tuple(valid.shape) != tuple(boxes.shape[:2]) or valid.dtype != torch.bool:
        raise ValueError("valid must be a bool [B, N] tensor")
    if valid.device != boxes.device:
        raise ValueError("boxes and valid must be on the same device")
    if boxes.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"boxes must be float32 or float64, got {boxes.dtype}")
    b, n = boxes.shape[:2]
    dev = boxes.device
    # the reference casts the boxes to float32 whatever their dtype; the
    # kernel reads each box as one 16-byte load
    boxes32 = boxes.to(torch.float32).contiguous()
    if boxes32.data_ptr() % 16:
        boxes32 = boxes32.clone()
    valid = valid.contiguous()
    col_blocks = (n + 63) // 64
    mask = torch.empty((b, col_blocks, (col_blocks + 1) * 64), dtype=torch.int64, device=dev)
    keep = torch.empty((b, max_outputs), dtype=torch.int32, device=dev)
    keep_valid = torch.empty((b, max_outputs), dtype=torch.bool, device=dev)
    if b == 0 or max_outputs == 0:
        return keep, keep_valid
    if n == 0:
        keep.fill_(pad_value)
        keep_valid.zero_()
        return keep, keep_valid
    NMS_KERNEL.launch(
        "nms_sorted_batched", dev, boxes32.data_ptr(), valid.data_ptr(), b, n,
        max_outputs, float(iou_threshold), int(suppress_at_equal), int(pad_value),
        mask.data_ptr(), keep.data_ptr(), keep_valid.data_ptr())
    NMS_KERNEL.launches += 1
    return keep, keep_valid
