"""Proposal layer: RPN outputs -> top-K -> deltas -> clip -> NMS -> ROIs.

Port of the JAX package's ``detect/proposal.py::proposal_layer_batched``:
scores sorted descending, the top ``pre_nms_limit`` anchors refined by
(deltas * RPN_BBOX_STD_DEV), clipped to the image, greedy NMS (legacy +1
IoU, suppress at ``>``), the first ``proposal_count`` kept, normalized to
[0, 1]. Fixed-size outputs with a validity mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.boxes import apply_box_deltas, clip_boxes, device_constant
from ..ops.nms_cuda import nms_sorted_batched


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, in descending
    order with ties broken by the lower index first (``lax.top_k``'s
    order; ``torch.topk`` promises no order for ties)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def proposal_layer_batched(
    rpn_probs: torch.Tensor,
    rpn_deltas: torch.Tensor,
    anchors: torch.Tensor,
    *,
    proposal_count: int,
    nms_threshold: float,
    image_size: int,
    rpn_bbox_std_dev,
    pre_nms_limit: int = 6000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """rpn_probs [B, A, 2], rpn_deltas [B, A, 4], anchors [A, 4] pixels.

    Returns (proposals [B, proposal_count, 4] normalized, zero-padded;
    valid [B, proposal_count] bool). The NMS runs on the CUDA kernel for
    CUDA tensors and on the plain version for CPU tensors."""
    scores = rpn_probs[..., 1]
    dt = torch.promote_types(rpn_deltas.dtype, torch.float32)
    std = device_constant(rpn_bbox_std_dev, dt, rpn_deltas.device)
    deltas = rpn_deltas.to(dt) * std

    k = min(pre_nms_limit, anchors.shape[0])
    order = top_k_indices(scores, k)                                # [B, k]
    deltas = torch.gather(deltas, 1, order[..., None].expand(-1, -1, 4))
    top_anchors = anchors[order]                                    # [B, k, 4]

    boxes = apply_box_deltas(top_anchors.to(dt), deltas)
    boxes = clip_boxes(boxes, (0.0, 0.0, float(image_size), float(image_size)))

    keep, keep_valid = nms_sorted_batched(
        boxes, torch.ones(boxes.shape[:2], dtype=torch.bool, device=boxes.device),
        max_outputs=proposal_count, iou_threshold=nms_threshold)
    kept = torch.gather(boxes, 1, keep.clamp_min(0).long()[..., None].expand(-1, -1, 4))
    kept = torch.where(keep_valid[..., None], kept, torch.zeros_like(kept))
    return kept / float(image_size), keep_valid
