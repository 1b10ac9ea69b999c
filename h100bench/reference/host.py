"""The host side of the published ``detect`` and of evaluation's result
encoding, in plain NumPy and PIL: molding (a squash resize), unmolding
(box rescale, ``scipy.misc.imresize`` of each mask crop with its
bytescale, threshold 0.5, paste) and the COCO result with its RLE string.

Given the same mold-space network outputs, these reproduce the program's
host results exactly; the judge uses them to hold the drain (unmold and
RLE) to what it must give for the outputs it was handed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from PIL import Image


def resize_u8(arr: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """PIL bilinear resize of a uint8 [H, W(, C)] array; the identity at
    the same size."""
    if arr.shape[:2] == tuple(hw):
        return arr
    return np.asarray(Image.fromarray(arr).resize((hw[1], hw[0]), Image.BILINEAR))


def mold(image: np.ndarray, size: int) -> np.ndarray:
    """A raw uint8 image squash-resized to [size, size, 3]."""
    return resize_u8(image.astype(np.uint8), (size, size))


def bytescale(data: np.ndarray) -> np.ndarray:
    lo = float(data.min()) if data.size else 0.0
    hi = float(data.max()) if data.size else 1.0
    span = hi - lo if hi != lo else 1.0
    return (np.clip((data - lo) * (255.0 / span), 0, 255) + 0.5).astype(np.uint8)


def unmold(detections: np.ndarray, masks: np.ndarray, image_shape,
           size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[np.ndarray]]:
    """Mold-space detections [D, 6] (zero rows past the last) and masks
    [D, 2m, 2m, C] of one image -> (frame boxes int32 [N, 4], class ids,
    scores, binary box crops)."""
    zero = np.where(detections[:, 4] == 0)[0]
    n = zero[0] if zero.shape[0] else detections.shape[0]
    class_ids = detections[:n, 4].astype(np.int32)
    class_ids[class_ids > 0] = 1
    scores = detections[:n, 5]
    crops_lowres = masks[np.arange(n), :, :, class_ids]
    hs, ws = image_shape[0] / size, image_shape[1] / size
    boxes = (detections[:n, :4] * np.array([hs, ws, hs, ws])).astype(np.int32)
    keep = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) > 0
    boxes, class_ids, scores = boxes[keep], class_ids[keep], scores[keep]
    crops = []
    for box, low in zip(boxes, crops_lowres[keep]):
        y1, x1, y2, x2 = (int(v) for v in box)
        up = resize_u8(bytescale(np.squeeze(low)), (y2 - y1, x2 - x1)).astype(np.float32)
        crops.append(np.where(up / 255.0 >= 0.5, 1, 0).astype(np.uint8))
    return boxes, class_ids, scores, crops


def full_masks(boxes, crops, image_shape) -> np.ndarray:
    """Box crops pasted into an [H, W, N] uint8 frame stack."""
    out = np.zeros(tuple(image_shape[:2]) + (len(crops),), np.uint8)
    for i, (box, crop) in enumerate(zip(boxes, crops)):
        y1, x1, y2, x2 = (int(v) for v in box)
        out[y1:y2, x1:x2, i] = crop
    return out


def rle_counts(frame: np.ndarray) -> np.ndarray:
    """Column-major run lengths of a binary [H, W] frame, starting with 0s."""
    flat = np.asarray(frame, np.uint8).reshape(-1, order="F")
    if flat.size == 0:
        return np.zeros(1, np.int64)
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    counts = np.diff(np.concatenate([[0], changes, [flat.size]]))
    return np.concatenate([[0], counts]) if flat[0] else counts


def rle_string(counts) -> bytes:
    """COCO's compressed counts: deltas from the count two back (from the
    fourth on), 5 bits per character with a continuation bit, offset 48."""
    out = bytearray()
    counts = [int(c) for c in counts]
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            out.append((c | 0x20 if more else c) + 48)
    return bytes(out)


def coco_results(image_id, boxes, class_ids, scores, crops, image_shape) -> List[Dict]:
    """The evaluation result dicts of one image (bbox x, y, w, h from the
    box rounded to one decimal; the mask as a COCO RLE)."""
    h, w = int(image_shape[0]), int(image_shape[1])
    out = []
    for box, cid, score, crop in zip(boxes, class_ids, scores, crops):
        bb = np.around(box, 1)
        frame = np.zeros((h, w), np.uint8)
        y1, x1 = int(box[0]), int(box[1])
        frame[y1:y1 + crop.shape[0], x1:x1 + crop.shape[1]] = crop
        out.append({"image_id": image_id, "category_id": 1 if cid > 0 else 0,
                    "bbox": [float(bb[1]), float(bb[0]), float(bb[3] - bb[1]),
                             float(bb[2] - bb[0])],
                    "score": float(score),
                    "segmentation": {"size": [h, w], "counts": rle_string(rle_counts(frame))}})
    return out
