"""Whether what the timed inference path produced is correct: the program's
answers for a sample of the window's images, held to the plain reference.

For each sampled image the reference (``reference/model.py``, float32)
molds the raw image itself and computes every proposal's class, score and
refined box. Then:

- ``count_diff``: the program's number of detections against the
  reference's (exact);
- each program detection is paired with the reference's candidate nearest
  to it, a unit of logit counting as ``PIXELS_PER_LOGIT`` pixels of box (among every
  proposal, not only the reference's top ones, so that a reordering at the
  top-k cut by rounding is no fault):
  ``box_px_p90`` is the 90th percentile over the run's detections of a
  box's distance from its partner (pixels, the largest coordinate
  difference: the widest distance cannot tell a lower precision apart,
  since a box that rounding moved far still finds some candidate near it),
  ``logit_gap`` the widest difference
  of their foreground-minus-background logits, and ``rank_gap`` the
  widest amount by which a partner's logit lies below the reference's
  own last detection (the program kept something the reference ranks
  out of the top);
- ``mask_gap``: the widest difference of a detection's mask logit (the
  probability's, as a logit: a probability cannot differ by more than 1,
  so a lower precision's wide errors would hide at its ceiling) from the
  reference's mask head at the program's box;
- ``host_mismatch``: the program's host results (the evaluation's COCO
  dicts with their RLE strings, or ``detect``'s frame boxes, scores and
  pasted masks) against what the reference's unmold and encoder make of
  the program's own network outputs (exact).

The numbers of a run are the worst over its sampled images.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import host
from .reference.model import Reference

PIXELS_PER_LOGIT = 20.0     # pairing: a unit of logit weighs as 20 pixels of box
PROB_CLIP = (1e-6, 1.0 - 1e-6)


def logit(scores) -> np.ndarray:
    s = np.asarray(scores, np.float64)
    with np.errstate(divide="ignore"):
        return np.log(s) - np.log1p(-s)


def logit_gaps(scores: np.ndarray, margins: np.ndarray) -> np.ndarray:
    """|logit(score) - margin| [n, R] for the program's float32 scores [n]
    and the reference's logit margins [R], less what the score's float32
    rounding leaves open: a score of 1 - 2^-24 stands for every logit from
    about 16.6 up, and a score of 1 for every logit from about 17.3."""
    s = np.asarray(scores, np.float32)
    half = np.spacing(s).astype(np.float64) / 2
    lo = logit(np.asarray(s, np.float64) - half)[:, None]
    hi = logit(np.minimum(np.asarray(s, np.float64) + half, 1.0))[:, None]
    m = margins[None, :]
    return np.maximum(np.maximum(lo - m, m - hi), 0.0)


def network_numbers(ref: Reference, image: np.ndarray, detections: np.ndarray,
                    masks: np.ndarray, device) -> Dict[str, float]:
    """The network's numbers of one image: the program's mold-space
    ``detections`` [D, 6] and ``masks`` [D, 2m, 2m, C] against the
    reference."""
    size = ref.cfg["image_size"]
    molded = torch.from_numpy(host.mold(image, size).copy())[None].to(device)
    cands, levels, prior = ref.candidates(molded)
    n = int(np.argmax(detections[:, 4] == 0)) if (detections[:, 4] == 0).any() \
        else detections.shape[0]
    out = {"count_diff": float(abs(n - int(cands.detections.numel()))),
           "nms_pairs": cands.nms_pairs}
    fg = torch.nonzero(cands.class_ids > 0).reshape(-1)
    cbox = cands.boxes[fg].double().cpu().numpy()
    cmargin = cands.margin[fg].double().cpu().numpy()
    ref_margins = cands.margin[cands.detections].double().cpu().numpy()
    floor = ref_margins[min(n, ref_margins.size) - 1] if ref_margins.size and n else 0.0
    boxes = detections[:n, :4].astype(np.float64)
    dist = np.abs(boxes[:, None, :] - cbox[None, :, :]).max(-1)       # [n, R] pixels
    gaps = logit_gaps(detections[:n, 5], cmargin)
    partner = (dist + PIXELS_PER_LOGIT * gaps).argmin(1) if n else np.zeros(0, int)
    gap = gaps[np.arange(n), partner]
    out["box_px_p90"] = dist[np.arange(n), partner].tolist()
    out["logit_gap"] = float(gap.max()) if n else 0.0
    out["rank_gap"] = float(np.maximum(floor - cmargin[partner], 0.0).max()) if n else 0.0
    if n:
        want = ref.masks_at(levels, prior, torch.from_numpy(boxes).float().to(device))
        got = masks[np.arange(n), :, :, detections[:n, 4].astype(int)]
        out["mask_gap"] = float(np.abs(logit(np.clip(got, *PROB_CLIP))
                                       - logit(np.clip(want.cpu().numpy(), *PROB_CLIP))).max())
    else:
        out["mask_gap"] = 0.0
    return out


def coco_mismatch(image: np.ndarray, image_id, detections, masks, got: List[Dict],
                  size: int) -> int:
    """Evaluation's result dicts of one image against the reference's
    unmold and encoder of the same network outputs: differing dicts, plus
    missing or extra ones."""
    boxes, cids, scores, crops = host.unmold(detections, masks, image.shape, size)
    want = host.coco_results(image_id, boxes, cids, scores, crops, image.shape)

    def key(r):
        seg = r["segmentation"]
        counts = seg["counts"].encode() if isinstance(seg["counts"], str) else seg["counts"]
        return (r["image_id"], r["category_id"], tuple(r["bbox"]), r["score"],
                tuple(seg["size"]), counts)

    bad = abs(len(want) - len(got))
    return bad + sum(key(a) != key(b) for a, b in zip(want, got))


def detect_mismatch(image: np.ndarray, detections, masks, got: Dict, size: int) -> int:
    """``detect``'s dict of one image against the reference's unmold of the
    same network outputs: differing fields."""
    boxes, cids, scores, crops = host.unmold(detections, masks, image.shape, size)
    frames = host.full_masks(boxes, crops, image.shape)
    pairs = ((boxes, got["rois"]), (cids, got["class_ids"]), (scores, got["scores"]),
             (frames, got["masks"]))
    return sum(not (np.shape(a) == np.shape(b) and np.array_equal(a, b)) for a, b in pairs)


COUNTS = ("count_diff", "host_mismatch", "loader_faults")


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst of each number over the readings (counts add; a ``_p90``
    number is the 90th percentile of all the readings' values)."""
    out = {}
    for name in sorted({k for r in readings for k in r} - {"nms_pairs"}):
        vals = [r[name] for r in readings if name in r]
        if name.endswith("_p90"):
            pooled = [x for v in vals for x in v]
            out[name] = float(np.percentile(pooled, 90)) if pooled else 0.0
        else:
            out[name] = float(sum(vals)) if name in COUNTS else float(max(vals))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            missing: Optional[int] = 0) -> bool:
    """Correct when every number is within its limit and no sampled answer
    is missing."""
    return not missing and all(numbers.get(k, np.inf) <= v for k, v in limits.items())
