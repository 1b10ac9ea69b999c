"""Greedy NMS over score-sorted boxes: the plain PyTorch version.

Port of the JAX package's ``ops/nms.py::nms_sorted``, batched: boxes
[B, N, 4] (y1, x1, y2, x2) sorted by descending score, a validity mask
[B, N]. Greedy selection in index order, legacy +1 IoU, a box is suppressed
at IoU > threshold (>= with ``suppress_at_equal``). Boxes are cast to
float32 whatever their dtype, as in the reference, so the keeps of a
float64 pipeline are those of its float32-rounded boxes.

This is the reference the CUDA kernel (``csrc/nms.cu``) is held against;
:func:`sln_amodal_tpu_torch.ops.nms_cuda.nms_sorted_batched` calls it for
tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .boxes import box_iou_plus_one


def nms_sorted_batched_plain(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    max_outputs: int,
    iou_threshold: float,
    suppress_at_equal: bool = False,
    pad_value: int = -1,
):
    """Returns (keep [B, max_outputs] int32 indices in score order, padded
    with ``pad_value``; keep_valid [B, max_outputs] bool)."""
    b = boxes.shape[0]
    dev = boxes.device
    boxes = boxes.to(torch.float32)
    # the IoU is float32, so compare against the float32 threshold
    thr = float(np.float32(iou_threshold))
    alive = valid.to(torch.bool).clone()
    keep = torch.full((b, max_outputs), pad_value, dtype=torch.int32, device=dev)
    keep_valid = torch.zeros((b, max_outputs), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    for i in range(max_outputs):
        has = alive.any(dim=1)
        idx = alive.to(torch.uint8).argmax(dim=1)  # first alive = best score
        iou = box_iou_plus_one(boxes[rows, idx][:, None, :], boxes)[:, 0]
        sup = iou >= thr if suppress_at_equal else iou > thr
        new_alive = alive & ~sup
        new_alive[rows, idx] = False
        alive = torch.where(has[:, None], new_alive, alive)
        keep[:, i] = torch.where(has, idx.to(torch.int32),
                                 torch.full_like(keep[:, i], pad_value))
        keep_valid[:, i] = has
    return keep, keep_valid
