"""Detection-target layer (training): sample ROIs, build the heads' targets.

Port of the JAX package's ``detect/targets.py::detection_target_layer``,
batched over images (the JAX model lifts it over the batch with ``vmap``):

- positives: proposals with IoU >= 0.5 against a real GT box, a random
  subsample of at most ``train_rois * roi_positive_ratio``;
- negatives: IoU < 0.5 and away from crowd boxes, ``int(pos / ratio) - pos``
  of them, none when there is no positive;
- a fixed [train_rois] table per image: positive slots first, then the
  negatives, then padding (``valid`` marks the real rows);
- per positive: its GT box as normalized deltas (/ ``bbox_std_dev``) and
  its GT layer masks cropped to the ROI at ``mask_shape`` and rounded.

The random priorities come from an explicit ``torch.Generator`` (drawn on
the CPU, so one seed gives the same draws on every device), or are given as
tensors: the JAX package draws them with ``jax.random``, whose numbers no
torch generator gives, so the tests feed its draws in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.boxes import box_iou, box_refinement, device_constant
from ..ops.roi_align import crop_and_resize


class RoiTargets(NamedTuple):
    rois: torch.Tensor        # [B, T, 4] normalized
    class_ids: torch.Tensor   # [B, T] int32 (0 = background / padding)
    deltas: torch.Tensor      # [B, T, 4]
    masks: torch.Tensor       # [B, T, L, mh, mw] float32 in {0, 1}
    valid: torch.Tensor       # [B, T] bool: real (positive or negative) rows
    positive: torch.Tensor    # [B, T] bool


def _take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values [B, P, ...] gathered at index [B, T] along P."""
    b = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[b, index]


def detection_target_layer(
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    gt_class_ids: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_masks: torch.Tensor,
    *,
    train_rois: int,
    roi_positive_ratio: float,
    mask_shape,
    bbox_std_dev,
    generator: Optional[torch.Generator] = None,
    pos_uniform: Optional[torch.Tensor] = None,
    neg_uniform: Optional[torch.Tensor] = None,
) -> RoiTargets:
    """Target sampling for a batch.

    proposals [B, P, 4] normalized, zero-padded; proposal_valid [B, P] bool;
    gt_class_ids [B, G] (0 padding, < 0 crowd); gt_boxes [B, G, 4]
    normalized; gt_masks [B, G, L, H, W]. The uniform priorities [B, P] are
    ``pos_uniform``/``neg_uniform`` when given, else drawn from
    ``generator`` (positives' draw first)."""
    b, p = proposals.shape[:2]
    g = gt_boxes.shape[1]
    t = train_rois
    mh, mw = mask_shape
    num_layers = gt_masks.shape[2]
    dev = proposals.device
    if pos_uniform is None or neg_uniform is None:
        draws = torch.rand((2, b, p), generator=generator, dtype=torch.float32)
        pos_uniform, neg_uniform = draws.to(dev)

    gt_real = gt_class_ids > 0
    crowd = gt_class_ids < 0

    overlaps = box_iou(proposals, gt_boxes)                          # [B, P, G]
    minus_one = torch.full((), -1.0, dtype=overlaps.dtype, device=dev)
    overlaps_real = torch.where(gt_real[:, None, :], overlaps, minus_one)
    roi_iou_max = overlaps_real.max(dim=2).values
    crowd_overlap = torch.where(crowd[:, None, :], overlaps, torch.zeros_like(overlaps))
    crowd_iou_max = crowd_overlap.max(dim=2).values
    no_crowd = crowd_iou_max < 0.001

    positive = (roi_iou_max >= 0.5) & proposal_valid
    negative = (roi_iou_max < 0.5) & no_crowd & proposal_valid

    max_pos = int(train_rois * roi_positive_ratio)
    inf = torch.full((), torch.inf, dtype=pos_uniform.dtype, device=dev)
    # random priority, positives first (a stable sort, as jnp.argsort is)
    pos_order = torch.sort(torch.where(positive, pos_uniform.to(dev), inf), dim=1,
                           stable=True).indices
    n_pos = torch.clamp(positive.sum(dim=1), max=max_pos)
    neg_order = torch.sort(torch.where(negative, neg_uniform.to(dev), inf), dim=1,
                           stable=True).indices
    # negative count = int(pos / ratio) - pos, in float32 (a tensor divisor:
    # the card divides by a scalar as a product with its reciprocal; kept on
    # the device, so a captured step uploads nothing)
    ratio = device_constant(roi_positive_ratio, torch.float32, dev)
    want_neg = (n_pos.to(torch.float32) / ratio).to(torch.int32) - n_pos
    n_neg = torch.minimum(negative.sum(dim=1), torch.clamp(want_neg, min=0))
    n_neg = torch.where(n_pos > 0, n_neg, torch.zeros_like(n_neg))

    slot = torch.arange(t, device=dev)[None, :]
    is_pos_slot = slot < n_pos[:, None]
    is_neg_slot = (slot >= n_pos[:, None]) & (slot < (n_pos + n_neg)[:, None])
    valid = is_pos_slot | is_neg_slot

    pos_take = _take(pos_order, torch.clamp(slot, max=p - 1).expand(b, t))
    neg_take = _take(neg_order, torch.clamp(slot - n_pos[:, None], 0, p - 1))
    src = torch.where(is_pos_slot, pos_take, neg_take)

    rois = torch.where(valid[..., None], _take(proposals, src),
                       torch.zeros((), dtype=proposals.dtype, device=dev))

    # positive targets
    assign = _take(overlaps_real, src).argmax(dim=2)                 # [B, T]
    roi_gt_boxes = _take(gt_boxes, assign)
    class_ids = torch.where(is_pos_slot, _take(gt_class_ids, assign),
                            torch.zeros((), dtype=gt_class_ids.dtype, device=dev))
    class_ids = class_ids.to(torch.int32)
    std = device_constant(bbox_std_dev, torch.float32, dev)
    deltas = box_refinement(rois, roi_gt_boxes) / std
    deltas = torch.where(is_pos_slot[..., None], deltas, torch.zeros_like(deltas))

    # the assigned GT's layer masks cropped to each ROI: the B * G * L masks
    # as single-channel images, one box per (slot, layer)
    gh, gw = gt_masks.shape[3], gt_masks.shape[4]
    mask_imgs = gt_masks.reshape(b * g * num_layers, gh, gw, 1).to(torch.float32)
    box_per_slot = rois.repeat_interleave(num_layers, dim=1).reshape(-1, 4)
    layer = torch.arange(num_layers, device=dev)
    image = torch.arange(b, device=dev)[:, None, None] * (g * num_layers)
    ind = (image + assign[..., None] * num_layers + layer).reshape(-1)
    crops = crop_and_resize(mask_imgs, box_per_slot, ind, (mh, mw))
    masks = torch.round(crops.reshape(b, t, num_layers, mh, mw))
    masks = torch.where(is_pos_slot[..., None, None, None], masks, torch.zeros_like(masks))

    return RoiTargets(rois=rois, class_ids=class_ids, deltas=deltas, masks=masks,
                      valid=valid, positive=is_pos_slot)
