"""Training losses: port of the JAX package's ``train/losses.py``.

Masked means over fixed-size tensors (the reference's
``modal/loss.py:10-253`` gathers index sets and means over them: the same
values). The BCE terms use the stable logit form. Each term casts its
predictions (and the mask targets) to float32 where the JAX package does
(``losses.py:46, 61, 70, 86, 102, 115``), so the losses, and every
gradient through them, are float32 precision even when the graph runs in
float64.

Total training loss = rpn_class + rpn_bbox + mrcnn_class + mrcnn_bbox +
layer + amodal (the reference's ``model.py:423-436``).
"""

from __future__ import annotations

from typing import Dict

import torch

F32 = torch.float32


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(values.dtype)
    return (values * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber, beta 1)."""
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (stable form)."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def rpn_class_loss(rpn_match: torch.Tensor, rpn_logits: torch.Tensor) -> torch.Tensor:
    """CE over anchors with match != 0; positives are class 1.
    rpn_match [A] (-1, 0, +1); rpn_logits [A, 2]."""
    contributing = rpn_match != 0
    target = (rpn_match == 1).long()
    logp = torch.log_softmax(rpn_logits.to(F32), dim=-1)
    ce = -torch.gather(logp, 1, target[:, None])[:, 0]
    return _masked_mean(ce, contributing)


def rpn_bbox_loss(rpn_target_deltas: torch.Tensor, rpn_match: torch.Tensor,
                  rpn_pred_deltas: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 over positive anchors; targets [A, 4] aligned per anchor."""
    pos = (rpn_match == 1).to(F32)
    loss = smooth_l1(rpn_pred_deltas.to(F32), rpn_target_deltas)
    denom = torch.clamp(pos.sum() * 4.0, min=1.0)
    return (loss * pos[:, None]).sum() / denom


def mrcnn_class_loss(target_class_ids: torch.Tensor, logits: torch.Tensor,
                     roi_valid: torch.Tensor) -> torch.Tensor:
    """CE over the real ROI slots (positives and sampled negatives)."""
    logp = torch.log_softmax(logits.to(F32), dim=-1)
    ce = -torch.gather(logp, 1, target_class_ids.long()[:, None])[:, 0]
    return _masked_mean(ce, roi_valid)


def mrcnn_bbox_loss(target_deltas: torch.Tensor, target_class_ids: torch.Tensor,
                    pred_deltas: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 on each positive ROI's target-class deltas; pred [T, C, 4]."""
    t = target_class_ids.shape[0]
    pos = target_class_ids > 0
    cls = torch.clamp(target_class_ids.long(), min=0)
    picked = pred_deltas[torch.arange(t, device=pred_deltas.device), cls]   # [T, 4]
    loss = smooth_l1(picked.to(F32), target_deltas.to(F32))
    denom = torch.clamp(pos.to(F32).sum() * 4.0, min=1.0)
    return (loss * pos[:, None].to(F32)).sum() / denom


def layer_loss(target_masks: torch.Tensor, target_class_ids: torch.Tensor,
               pred_logits: torch.Tensor) -> torch.Tensor:
    """BCE of each layer channel (pred channels 1:) against the GT layer
    stack over positive ROIs. target [T, L, mh, mw]; pred [T, mh, mw, L + 1]."""
    pos = target_class_ids > 0
    pred = torch.movedim(pred_logits[..., 1:], -1, 1)               # [T, L, mh, mw]
    loss = bce_with_logits(pred.to(F32), target_masks.to(F32))
    return _masked_mean(loss.mean(dim=(1, 2, 3)), pos)


def amodal_loss(target_masks: torch.Tensor, target_class_ids: torch.Tensor,
                pred_logits: torch.Tensor) -> torch.Tensor:
    """BCE of the summed layer logits against the layers' sum over
    positive ROIs (the reference's ``loss.py:113-124``)."""
    pos = target_class_ids > 0
    summed_logits = pred_logits[..., 1:].sum(dim=-1)                # [T, mh, mw]
    y_true = target_masks.to(F32).sum(dim=1)                        # [T, mh, mw]
    loss = bce_with_logits(summed_logits.to(F32), y_true)
    return _masked_mean(loss.mean(dim=(1, 2)), pos)


def total_loss(*, rpn_match, rpn_target_deltas, rpn_logits, rpn_pred_deltas,
               target_class_ids, roi_valid, mrcnn_class_logits, target_deltas,
               mrcnn_pred_deltas, target_masks, mask_logits) -> Dict[str, torch.Tensor]:
    """The six terms of one image and their sum (``total``)."""
    losses = {
        "rpn_class": rpn_class_loss(rpn_match, rpn_logits),
        "rpn_bbox": rpn_bbox_loss(rpn_target_deltas, rpn_match, rpn_pred_deltas),
        "mrcnn_class": mrcnn_class_loss(target_class_ids, mrcnn_class_logits, roi_valid),
        "mrcnn_bbox": mrcnn_bbox_loss(target_deltas, target_class_ids, mrcnn_pred_deltas),
        "layer": layer_loss(target_masks, target_class_ids, mask_logits),
        "amodal": amodal_loss(target_masks, target_class_ids, mask_logits),
    }
    losses["total"] = sum(losses.values())
    return losses
