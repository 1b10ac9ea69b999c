"""Box geometry on tensors. Boxes are ``(y1, x1, y2, x2)`` rows.

The operations run in the same order as the JAX package's ``ops/boxes.py``,
so that float32 results agree bit for bit where no fused multiply-add is
involved.
"""

from __future__ import annotations

import torch

LOG_DELTA_CLIP = 10.0  # guards exp overflow -> inf-inf NaN boxes


def apply_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply (dy, dx, log dh, log dw) refinements to boxes [..., 4]."""
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    center_y = boxes[..., 0] + 0.5 * height + deltas[..., 0] * height
    center_x = boxes[..., 1] + 0.5 * width + deltas[..., 1] * width
    height = height * torch.exp(deltas[..., 2].clamp(-LOG_DELTA_CLIP, LOG_DELTA_CLIP))
    width = width * torch.exp(deltas[..., 3].clamp(-LOG_DELTA_CLIP, LOG_DELTA_CLIP))
    y1 = center_y - 0.5 * height
    x1 = center_x - 0.5 * width
    return torch.stack([y1, x1, y1 + height, x1 + width], dim=-1)


def clip_boxes(boxes: torch.Tensor, window) -> torch.Tensor:
    """Clip boxes [..., 4] to a window (y1, x1, y2, x2) of scalars or of
    tensors that broadcast against ``boxes[..., 0]``."""
    wy1, wx1, wy2, wx2 = window
    return torch.stack(
        [
            torch.clamp(boxes[..., 0], wy1, wy2),
            torch.clamp(boxes[..., 1], wx1, wx2),
            torch.clamp(boxes[..., 2], wy1, wy2),
            torch.clamp(boxes[..., 3], wx1, wx2),
        ],
        dim=-1,
    )


def box_iou_plus_one(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., N1, N2] with the legacy +1 pixel convention of the
    reference NMS kernels. Leading batch dims broadcast."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    y1 = torch.maximum(b1[..., 0], b2[..., 0])
    x1 = torch.maximum(b1[..., 1], b2[..., 1])
    y2 = torch.minimum(b1[..., 2], b2[..., 2])
    x2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (y2 - y1 + 1.0).clamp_min(0.0) * (x2 - x1 + 1.0).clamp_min(0.0)
    area1 = (b1[..., 2] - b1[..., 0] + 1.0) * (b1[..., 3] - b1[..., 1] + 1.0)
    area2 = (b2[..., 2] - b2[..., 0] + 1.0) * (b2[..., 3] - b2[..., 1] + 1.0)
    union = area1 + area2 - inter
    return inter / torch.where(union != 0, union, torch.ones_like(union))


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., N1, N2] (continuous coordinates, no +1), as the
    JAX package's ``ops/boxes.py::box_iou``; a zero union gives 0."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    y1 = torch.maximum(b1[..., 0], b2[..., 0])
    x1 = torch.maximum(b1[..., 1], b2[..., 1])
    y2 = torch.minimum(b1[..., 2], b2[..., 2])
    x2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = area1 + area2 - inter
    return inter / torch.where(union > 0, union, torch.ones_like(union))


def box_refinement(box: torch.Tensor, gt_box: torch.Tensor) -> torch.Tensor:
    """(dy, dx, log dh, log dw) that turn ``box`` into ``gt_box``, rows
    [..., 4]; zero-size boxes give a log of 1 (0), as in the JAX package."""
    height = box[..., 2] - box[..., 0]
    width = box[..., 3] - box[..., 1]
    center_y = box[..., 0] + 0.5 * height
    center_x = box[..., 1] + 0.5 * width

    gt_height = gt_box[..., 2] - gt_box[..., 0]
    gt_width = gt_box[..., 3] - gt_box[..., 1]
    gt_center_y = gt_box[..., 0] + 0.5 * gt_height
    gt_center_x = gt_box[..., 1] + 0.5 * gt_width

    safe_h = torch.where(height != 0, height, torch.ones_like(height))
    safe_w = torch.where(width != 0, width, torch.ones_like(width))
    dy = (gt_center_y - center_y) / safe_h
    dx = (gt_center_x - center_x) / safe_w
    dh = torch.log(torch.where((gt_height > 0) & (height > 0), gt_height / safe_h,
                               torch.ones_like(height)))
    dw = torch.log(torch.where((gt_width > 0) & (width > 0), gt_width / safe_w,
                               torch.ones_like(width)))
    return torch.stack([dy, dx, dh, dw], dim=-1)
