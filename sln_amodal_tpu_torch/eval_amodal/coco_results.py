"""Detection -> COCO-format result dicts (the reference's
``build_coco_results``, ``amodal_train.py:371-400``)."""

from __future__ import annotations

from typing import List

import numpy as np

from . import rle as rle_api


def build_coco_results(image_id, rois, class_ids, scores, masks) -> List[dict]:
    """One image's detections → list of result dicts.

    rois: [N, (y1, x1, y2, x2)] px; masks: [H, W, N] binary.
    """
    if rois is None or len(rois) == 0:
        return []
    results = []
    for i in range(rois.shape[0]):
        bbox = np.around(rois[i], 1)
        results.append(
            {
                "image_id": image_id,
                "category_id": 1 if class_ids[i] > 0 else 0,
                "bbox": [
                    float(bbox[1]),
                    float(bbox[0]),
                    float(bbox[3] - bbox[1]),
                    float(bbox[2] - bbox[0]),
                ],
                "score": float(scores[i]),
                "segmentation": rle_api.encode(
                    np.asfortranarray(masks[:, :, i].astype(np.uint8))
                ),
            }
        )
    return results


def build_coco_results_crops(image_id, rois, class_ids, scores, crops,
                             image_shape) -> List[dict]:
    """``build_coco_results`` from binary box crops instead of full-frame
    masks: the RLE is encoded straight off each crop + its box offsets
    (``rle.encode_pasted``), skipping the [H, W] zero-frame paste — output
    dicts are bit-identical (pinned by tests/test_torch_eval.py)."""
    if rois is None or len(rois) == 0:
        return []
    H, W = int(image_shape[0]), int(image_shape[1])
    results = []
    for i in range(rois.shape[0]):
        bbox = np.around(rois[i], 1)
        y1, x1 = int(rois[i][0]), int(rois[i][1])
        results.append(
            {
                "image_id": image_id,
                "category_id": 1 if class_ids[i] > 0 else 0,
                "bbox": [
                    float(bbox[1]),
                    float(bbox[0]),
                    float(bbox[3] - bbox[1]),
                    float(bbox[2] - bbox[0]),
                ],
                "score": float(scores[i]),
                "segmentation": rle_api.encode_pasted(crops[i], y1, x1, H, W),
            }
        )
    return results
