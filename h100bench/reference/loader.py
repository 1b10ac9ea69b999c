"""What a training batch must hold, checked against the data the benchmark
wrote: the plain reference of the host loader's targets.

The loader draws a flip, a box jitter and the RPN's anchor subsample from
its own generator, so the check does not replay its draws; it holds each
sample to what any draw may give:

- the image is one of the written images, squash-resized (PIL bilinear),
  flipped or not, minus the mean pixel;
- its GT is that image's regions in order, class 1, as many as the
  sem-dist decoder finds (the published ``max_objectID`` scan stops at the
  first object that is in front nowhere: it and the objects after it are
  not decoded, a quirk of the reference the loader keeps); each layer mask the
  region's amodal mask (nearest-neighbour resized, flipped with the
  image), each box the mask's box moved by at most a fifteenth of its side
  (the jitter) and cut to whole pixels, the rest of the slots empty;
- the RPN targets follow from those boxes: positives are anchors at IoU
  0.7 or more with a box, or a box's best anchor; negatives are anchors
  under 0.3; half the 256 anchors at most are positive and together they
  make 256; each positive's deltas are its box's refinement over the
  standard deviations.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import scipy.ndimage

from . import host


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    y1 = np.maximum(a[:, None, 0], b[None, :, 0])
    x1 = np.maximum(a[:, None, 1], b[None, :, 1])
    y2 = np.minimum(a[:, None, 2], b[None, :, 2])
    x2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def decoded_count(amodal: Sequence[np.ndarray]) -> int:
    """How many depth-ordered regions the sem-dist decoder returns: objects
    0, 1, ... as long as each is in front somewhere."""
    front = np.full(amodal[0].shape, -1)
    for i, m in enumerate(amodal):
        front[m] = i
    present, n = set(np.unique(front).tolist()), 0
    while n in present:
        n += 1
    return n


class LoaderCheck:
    """Checks batches of ``cfg``'s loader against the written ``images``
    (raw uint8) and their depth-ordered amodal ``regions``."""

    def __init__(self, cfg: Dict, images: Sequence[np.ndarray], regions, anchors: np.ndarray):
        # float32 anchors against whole-pixel boxes: the areas of the IoU in
        # float32 and int, as the loader has them, so that an IoU on 0.7 or
        # 0.3 falls on the same side
        self.cfg, self.regions, self.anchors = cfg, regions, anchors.astype(np.float32)
        size = cfg["image_size"]
        self.index = {}
        for i, img in enumerate(images):
            molded = host.mold(img, size)
            self.index[molded.tobytes()] = (i, False)
            self.index[np.ascontiguousarray(molded[:, ::-1]).tobytes()] = (i, True)

    def sample_faults(self, sample: Dict[str, np.ndarray]) -> int:
        cfg = self.cfg
        size = cfg["image_size"]
        mean = np.asarray(cfg["mean_pixel"], np.float32)
        pixels = np.rint(sample["images"] + mean).astype(np.uint8)
        found = self.index.get(pixels.tobytes())
        if found is None:
            return 1
        i, flip = found
        regions = self.regions[i][:decoded_count(self.regions[i])]
        masks = np.stack(regions, -1)[:, :, None, :]                  # [H, W, 1, N]
        h, w = masks.shape[:2]
        masks = scipy.ndimage.zoom(masks, zoom=[size / h, size / w, 1, 1], order=0)
        if flip:
            masks = masks[:, ::-1]
        n = masks.shape[-1]
        want = np.transpose(masks, (3, 2, 0, 1)).astype(np.uint8)
        faults = 0
        faults += int(not np.array_equal(sample["gt_masks"][:n], want))
        faults += int(sample["gt_masks"][n:].any())
        ids = sample["gt_class_ids"]
        faults += int(not (np.all(ids[:n] == 1) and not ids[n:].any()))
        boxes = sample["gt_boxes"][:n].astype(np.float64) * size
        amodal = masks.sum(2) > 0
        for k in range(n):
            ys = np.where(amodal[:, :, k].any(1))[0]
            xs = np.where(amodal[:, :, k].any(0))[0]
            exact = np.array([ys[0], xs[0], ys[-1] + 1, xs[-1] + 1], np.float64)
            span = np.array([exact[2] - exact[0], exact[3] - exact[1]] * 2)
            faults += int(np.any(np.abs(boxes[k] - exact) > span / 15.0 + 1.0))
        faults += int(sample["gt_boxes"][n:].any())
        return faults + self.rpn_faults(sample, boxes)

    def rpn_faults(self, sample, boxes: np.ndarray) -> int:
        cfg = self.cfg
        match = sample["rpn_match"]
        boxes = boxes[(boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])]
        if boxes.shape[0] == 0:
            return int(not np.all(match == -1))
        iou = _iou(self.anchors, boxes.astype(np.int32))
        best = iou.max(1)
        allowed_pos = best >= 0.7
        allowed_pos[iou.argmax(0)] = True
        pos, neg = match == 1, match == -1
        limit = cfg["rpn_train_anchors_per_image"]
        faults = int(np.any(pos & ~allowed_pos)) + int(np.any(neg & ~(best < 0.3)))
        faults += int(pos.sum() > limit // 2) + int(pos.sum() + neg.sum() != limit)
        a = self.anchors[pos].astype(np.float64)
        g = boxes[iou[pos].argmax(1)]
        ah, aw = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
        gh, gw = g[:, 2] - g[:, 0], g[:, 3] - g[:, 1]
        deltas = np.stack([(g[:, 0] + 0.5 * gh - a[:, 0] - 0.5 * ah) / ah,
                           (g[:, 1] + 0.5 * gw - a[:, 1] - 0.5 * aw) / aw,
                           np.log(gh / ah), np.log(gw / aw)], 1)
        deltas /= np.asarray(cfg["rpn_bbox_std_dev"], np.float64)
        faults += int(not np.allclose(sample["rpn_deltas"][pos], deltas, rtol=1e-5, atol=1e-5))
        faults += int(sample["rpn_deltas"][~pos].any())
        return faults

    def batch_faults(self, batch: Dict[str, np.ndarray]) -> int:
        return sum(self.sample_faults({k: v[b] for k, v in batch.items()})
                   for b in range(batch["images"].shape[0]))
