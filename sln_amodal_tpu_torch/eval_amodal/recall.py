"""Proposal-recall evaluator (reference ``evaluate/evaluate.py:4`` +
``evaluate/bbox.py:5``): average recall of proposal boxes against GT boxes,
sliced by GT area, with the AR integral over IoU in [0.5, 0.95].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

AREA_RANGES = {
    "all": (0 ** 2, 1e5 ** 2),
    "small": (0 ** 2, 32 ** 2),
    "medium": (32 ** 2, 96 ** 2),
    "large": (96 ** 2, 1e5 ** 2),
    "96-128": (96 ** 2, 128 ** 2),
    "128-256": (128 ** 2, 256 ** 2),
    "256-512": (256 ** 2, 512 ** 2),
    "512-inf": (512 ** 2, 1e5 ** 2),
}


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """IoU matrix [N, K] over (x1, y1, x2, y2) boxes (+1 convention, like the
    reference's evaluate/bbox.py)."""
    n, k = boxes.shape[0], query.shape[0]
    out = np.zeros((n, k))
    for j in range(k):
        qa = (query[j, 2] - query[j, 0] + 1) * (query[j, 3] - query[j, 1] + 1)
        iw = np.minimum(boxes[:, 2], query[j, 2]) - np.maximum(boxes[:, 0], query[j, 0]) + 1
        ih = np.minimum(boxes[:, 3], query[j, 3]) - np.maximum(boxes[:, 1], query[j, 1]) + 1
        ok = (iw > 0) & (ih > 0)
        ba = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
        ua = ba + qa - iw * ih
        out[ok, j] = (iw * ih)[ok] / ua[ok]
    return out


def evaluate_recall(
    proposals_per_image: Sequence[np.ndarray],
    gt_per_image: Sequence[np.ndarray],
    area: str = "all",
    limit: Optional[int] = None,
    thresholds: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """AR of proposals vs GT boxes (both (x1, y1, x2, y2) per image)."""
    area_lo, area_hi = AREA_RANGES[area]
    gt_overlaps: List[np.ndarray] = []
    num_pos = 0
    for boxes, gt in zip(proposals_per_image, gt_per_image):
        if gt.size:
            areas = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
            keep = (areas >= area_lo) & (areas < area_hi)
            gt = gt[keep]
        num_pos += len(gt)
        if limit is not None and len(boxes) > limit:
            boxes = boxes[:limit]
        if len(gt) == 0 or len(boxes) == 0:
            continue
        overlaps = bbox_overlaps(boxes.astype(float), gt.astype(float))
        found = np.zeros(len(gt))
        ov = overlaps.copy()
        for _ in range(min(len(boxes), len(gt))):
            argmax = ov.argmax()
            bi, gi = np.unravel_index(argmax, ov.shape)
            if ov[bi, gi] <= 0:
                break
            found[gi] = ov[bi, gi]
            ov[bi, :] = -1
            ov[:, gi] = -1
        gt_overlaps.append(found)

    gt_overlaps = np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0)
    gt_overlaps = np.sort(gt_overlaps)
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    recalls = np.array(
        [(gt_overlaps >= t).sum() / max(num_pos, 1) for t in thresholds]
    )
    return {
        "ar": recalls.mean(),
        "recalls": recalls,
        "thresholds": thresholds,
        "gt_overlaps": gt_overlaps,
        "num_pos": num_pos,
    }
