"""Detection layer (inference): classify, refine, keep the top detections.

Port of the JAX package's ``detect/detection.py::refine_detections``, batched
over images (the reference lifts it over the batch with ``vmap``):

- per-ROI argmax class and its class-specific deltas (scaled by
  RPN_BBOX_STD_DEV), scaled to pixels, clipped to the window, rounded;
- keep foreground (class_id > 0) valid ROIs, optionally after per-class NMS
  (``use_nms``; the reference ships USE_NMS=False);
- the top ``max_instances`` by score, descending, ties by lower index;
- rows (y1, x1, y2, x2, class_id, score) in pixels, all-zero past the last
  detection.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.boxes import apply_box_deltas, clip_boxes, device_constant
from ..ops.nms_cuda import nms_sorted_batched
from .proposal import top_k_indices


def refine_detections(
    rois: torch.Tensor,
    roi_valid: torch.Tensor,
    probs: torch.Tensor,
    deltas: torch.Tensor,
    windows: torch.Tensor,
    *,
    image_size: int,
    bbox_std_dev,
    max_instances: int,
    min_confidence: float = 0.0,
    use_nms: bool = False,
    nms_threshold: float = 0.3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """rois [B, R, 4] normalized; roi_valid [B, R]; probs [B, R, C];
    deltas [B, R, C, 4]; windows [B, 4] pixel windows (y1, x1, y2, x2).

    Returns (detections [B, max_instances, 6], valid [B, max_instances])."""
    b, r = rois.shape[:2]
    dev = rois.device
    class_ids = probs.argmax(dim=-1)                                  # [B, R]
    class_scores = torch.gather(probs, 2, class_ids[..., None])[..., 0]
    deltas_specific = torch.gather(
        deltas, 2, class_ids[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]

    dt = torch.promote_types(rois.dtype, torch.float32)
    std = device_constant(bbox_std_dev, dt, dev)
    refined = apply_box_deltas(rois.to(dt), deltas_specific.to(dt) * std)
    refined = refined * float(image_size)
    win = windows.to(torch.float32).to(dt)
    refined = torch.round(clip_boxes(
        refined, tuple(win[:, i:i + 1] for i in range(4))))

    keep = (class_ids > 0) & roi_valid
    if min_confidence > 0:
        keep = keep & (class_scores >= min_confidence)

    neg_inf = torch.full((), -torch.inf, dtype=class_scores.dtype, device=dev)
    if use_nms:
        # per-class NMS; with the single foreground class there is one class
        score_key = torch.where(keep, class_scores, neg_inf)
        order = top_k_indices(score_key, r)
        sorted_boxes = torch.gather(refined, 1, order[..., None].expand(-1, -1, 4))
        sorted_valid = torch.gather(keep, 1, order)
        nms_keep, nms_valid = nms_sorted_batched(
            sorted_boxes, sorted_valid, max_outputs=r, iou_threshold=nms_threshold)
        target = torch.gather(order, 1, nms_keep.clamp_min(0).long())
        target = torch.where(nms_valid, target, torch.full_like(target, r))
        keep_after = torch.zeros((b, r + 1), dtype=torch.bool, device=dev)
        keep_after.scatter_(1, target, True)
        keep = keep & keep_after[:, :r]

    score_key = torch.where(keep, class_scores, neg_inf)
    k = min(max_instances, r)
    top_idx = top_k_indices(score_key, k)
    top_scores = torch.gather(score_key, 1, top_idx)
    valid = top_scores > -torch.inf

    det_boxes = torch.gather(refined, 1, top_idx[..., None].expand(-1, -1, 4))
    det_ids = torch.gather(class_ids, 1, top_idx).to(torch.float32)
    det_scores = torch.gather(class_scores, 1, top_idx)
    detections = torch.cat(
        [det_boxes, det_ids[..., None].to(dt), det_scores[..., None].to(dt)], dim=-1)
    detections = torch.where(valid[..., None], detections, torch.zeros_like(detections))
    if k < max_instances:
        detections = torch.nn.functional.pad(detections, (0, 0, 0, max_instances - k))
        valid = torch.nn.functional.pad(valid, (0, max_instances - k))
    return detections, valid
