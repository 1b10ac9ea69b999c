"""The training step in plain PyTorch, float32: the reference of the training
cell.

One step of a stage is, for each image of the batch: the training graph
(the trunk and FPN, the RPN over every anchor; without gradient the GLM
prior, the proposals and the detection-target layer that samples
``train_rois_per_image`` ROIs; the classifier and the mask head over the
sampled ROIs, the prior cropped with normalized coordinates), the six
losses; their mean over the batch is differentiated, the gradient clipped
to a global norm of ``gradient_clip_norm`` (no epsilon), then SGD with
weight decay and momentum (no dampening) steps by ``-learning_rate``. The
target layer's random priorities are given (the program's draws for the
step), so both sides sample the same ROIs from the same proposals.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import torch

from .model import F32, Reference, crop_and_resize, roi_align

HEADS = r"rpn\.|classifier\.|mask\.|fpn\.P[2-5]_conv[12]\."
STAGE_LEVELS = {"heads": (), "4+": (4, 5)}     # the pyramid levels whose trunk trains


def trained(ref: Reference, stage: str) -> List[Tuple[str, torch.nn.Parameter]]:
    """The parameters a stage trains: the heads, the FPN's convs, and the
    trunk's of the stage's levels (its file's ``trained_pattern``)."""
    levels = STAGE_LEVELS[stage]
    trunk = [rf"fpn\.(?:{ref.trunk.trained_pattern(levels)})"] if levels else []
    pattern = re.compile("^(" + "|".join([HEADS] + trunk) + ")")
    return [(n, p) for n, p in ref.named_parameters() if pattern.match(n)]


def box_iou(a, b):
    """IoU [N, M] of continuous boxes (no +1); a zero union gives 0."""
    y1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    x1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    y2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    x2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.where(union > 0, union, torch.ones_like(union))


def refinement(box, gt):
    h, w = box[:, 2] - box[:, 0], box[:, 3] - box[:, 1]
    gh, gw = gt[:, 2] - gt[:, 0], gt[:, 3] - gt[:, 1]
    sh = torch.where(h != 0, h, torch.ones_like(h))
    sw = torch.where(w != 0, w, torch.ones_like(w))
    dy = (gt[:, 0] + 0.5 * gh - box[:, 0] - 0.5 * h) / sh
    dx = (gt[:, 1] + 0.5 * gw - box[:, 1] - 0.5 * w) / sw
    dh = torch.log(torch.where((gh > 0) & (h > 0), gh / sh, torch.ones_like(h)))
    dw = torch.log(torch.where((gw > 0) & (w > 0), gw / sw, torch.ones_like(w)))
    return torch.stack([dy, dx, dh, dw], -1)


def sample_targets(cfg: Dict, rois, gt_ids, gt_boxes, gt_masks, pos_u, neg_u):
    """The detection-target layer of one image: proposals [P, 4]
    normalized; GT ids [G], boxes [G, 4] normalized, layer masks
    [G, L, H, W]; the uniform priorities [P]. Returns (rois [T, 4],
    class ids [T], deltas [T, 4], masks [T, L, mh, mw], valid [T])."""
    t = cfg["train_rois_per_image"]
    pos_u, neg_u = pos_u[:rois.shape[0]], neg_u[:rois.shape[0]]
    real = gt_ids > 0
    iou = torch.where(real[None, :], box_iou(rois, gt_boxes), torch.tensor(-1.0))
    best = iou.max(1).values
    crowd = torch.where((gt_ids < 0)[None, :], box_iou(rois, gt_boxes),
                        torch.zeros(())).max(1).values
    positive, negative = best >= 0.5, (best < 0.5) & (crowd < 0.001)
    inf = torch.tensor(float("inf"))
    pos_order = torch.sort(torch.where(positive, pos_u, inf), stable=True).indices
    neg_order = torch.sort(torch.where(negative, neg_u, inf), stable=True).indices
    n_pos = min(int(positive.sum()), int(t * cfg["roi_positive_ratio"]))
    want = int(torch.tensor(n_pos, dtype=F32) / torch.tensor(cfg["roi_positive_ratio"])) - n_pos
    n_neg = min(int(negative.sum()), max(want, 0)) if n_pos else 0
    src = torch.cat([pos_order[:n_pos], neg_order[:n_neg]])
    k = n_pos + n_neg
    out_rois = torch.zeros((t, 4))
    out_rois[:k] = rois[src]
    assign = iou[src].argmax(1)
    ids = torch.zeros(t, dtype=torch.long)
    ids[:n_pos] = gt_ids[assign[:n_pos]].long()
    std = torch.tensor(cfg["bbox_std_dev"], dtype=F32)
    deltas = torch.zeros((t, 4))
    deltas[:n_pos] = refinement(rois[src[:n_pos]], gt_boxes[assign[:n_pos]]) / std
    layers = gt_masks.shape[1]
    mh, mw = cfg["mask_shape"]
    masks = torch.zeros((t, layers, mh, mw))
    if n_pos:
        imgs = gt_masks[assign[:n_pos]].reshape(-1, *gt_masks.shape[2:], 1).to(F32)
        boxes = rois[src[:n_pos]].repeat_interleave(layers, 0)
        crops = crop_and_resize(imgs, boxes, torch.arange(n_pos * layers), mh)
        masks[:n_pos] = torch.round(crops.reshape(n_pos, layers, mh, mw))
    valid = torch.arange(t) < k
    return out_rois, ids, deltas, masks, valid


def _mean(values, mask):
    mask = mask.to(values.dtype)
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


def smooth_l1(pred, target):
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def bce(logits, targets):
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def losses(cfg, rpn_match, rpn_target, rpn_logits, rpn_deltas, ids, valid, class_logits,
           target_deltas, bbox_deltas, target_masks, mask_logits) -> Dict[str, torch.Tensor]:
    """The six loss terms of one image and their sum."""
    ce = -torch.log_softmax(rpn_logits, -1).gather(1, (rpn_match == 1).long()[:, None])[:, 0]
    pos_a = (rpn_match == 1).to(F32)
    out = {"rpn_class": _mean(ce, rpn_match != 0),
           "rpn_bbox": (smooth_l1(rpn_deltas, rpn_target) * pos_a[:, None]).sum()
           / (pos_a.sum() * 4).clamp_min(1.0)}
    ce = -torch.log_softmax(class_logits, -1).gather(1, ids[:, None])[:, 0]
    out["mrcnn_class"] = _mean(ce, valid)
    pos = ids > 0
    picked = bbox_deltas[torch.arange(ids.shape[0]), ids.clamp_min(0)]
    out["mrcnn_bbox"] = (smooth_l1(picked, target_deltas) * pos[:, None].to(F32)).sum() \
        / (pos.to(F32).sum() * 4).clamp_min(1.0)
    pred = torch.movedim(mask_logits[..., 1:], -1, 1)
    out["layer"] = _mean(bce(pred, target_masks).mean((1, 2, 3)), pos)
    out["amodal"] = _mean(bce(mask_logits[..., 1:].sum(-1), target_masks.sum(1)).mean((1, 2)),
                          pos)
    out["total"] = sum(out.values())
    return out


def image_losses(ref: Reference, sample: Dict[str, torch.Tensor], pos_u, neg_u):
    """One image's losses through the training graph; ``sample`` holds the
    loader's tensors of that image (molded float32 image, RPN targets, GT)."""
    cfg = ref.cfg
    x = sample["images"][None]
    feats = ref.fpn(x)
    rpn_logits, rpn_probs, rpn_deltas = ref.rpn_outputs(feats)
    with torch.no_grad():
        prior = ref.prior(x)
        rois, _ = ref.proposals(rpn_probs.detach(), rpn_deltas.detach(),
                                cfg["post_nms_rois_training"])
        rois_t, ids, deltas, masks, valid = sample_targets(
            cfg, rois.cpu(), sample["gt_class_ids"].cpu(), sample["gt_boxes"].cpu(),
            sample["gt_masks"].cpu(), pos_u.cpu(), neg_u.cpu())
    dev = x.device
    rois_t = rois_t.to(dev)
    levels = feats[:4]
    crops = roi_align(levels, rois_t, cfg["pool_size"], cfg["image_size"])
    class_logits, _, bbox_deltas = ref.classifier(crops)
    m = cfg["mask_pool_size"]
    fpn_crops = roi_align(levels, rois_t, m, cfg["image_size"])
    glm = crop_and_resize(prior, rois_t, torch.zeros(rois_t.shape[0], dtype=torch.long,
                                                     device=dev), m)
    mask_logits = ref.mask(fpn_crops, glm)
    return losses(cfg, sample["rpn_match"], sample["rpn_deltas"], rpn_logits, rpn_deltas,
                  ids.to(dev), valid.to(dev), class_logits, deltas.to(dev), bbox_deltas,
                  masks.to(dev), mask_logits)


def sgd_steps(ref: Reference, stage: str, batches: Sequence[Dict[str, torch.Tensor]],
              uniforms: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """Steps of the stage from the model's current weights, one per batch.
    Returns (each step's mean total loss, the first step's clipped gradient
    per trained parameter, the trained parameters after the last step, each
    step's mean loss terms)."""
    cfg = ref.cfg
    params = trained(ref, stage)
    for _, p in params:
        p.requires_grad_(True)
    momentum: Dict[str, torch.Tensor] = {}
    totals, terms, first = [], [], None
    for step, (batch, (pos_u, neg_u)) in enumerate(zip(batches, uniforms)):
        for _, p in params:
            p.grad = None
        b = batch["images"].shape[0]
        total, parts = 0.0, {}
        for i in range(b):
            sample = {k: v[i] for k, v in batch.items()}
            out = image_losses(ref, sample, pos_u[i], neg_u[i])
            (out["total"] / b).backward()
            total += float(out["total"].detach()) / b
            for k, v in out.items():
                parts[k] = parts.get(k, 0.0) + float(v.detach()) / b
        totals.append(total)
        terms.append(parts)
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in params]
            norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
            if norm >= cfg["gradient_clip_norm"]:
                grads = [g / norm * cfg["gradient_clip_norm"] for g in grads]
            if step == 0:
                first = {n: g.clone() for (n, _), g in zip(params, grads)}
            for (n, p), g in zip(params, grads):
                d = g + cfg["weight_decay"] * p
                buf = momentum.get(n)
                momentum[n] = d if buf is None else cfg["learning_momentum"] * buf + d
                p -= cfg["learning_rate"] * momentum[n]
    for _, p in params:
        p.requires_grad_(False)
        p.grad = None
    return totals, first, {n: p.detach().clone() for n, p in params}, terms
