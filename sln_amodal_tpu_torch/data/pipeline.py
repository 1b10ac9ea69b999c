"""Training data pipeline: GT assembly, RPN targets, padded batches.

The port's own copy of the JAX package's ``data/pipeline.py`` (host-side
numpy, so the same code; the port imports nothing from the JAX package).
Each process of a data-parallel run streams its own slice of the dataset
(``parallel/multihost.py::partition_ids``).

Host-side numpy equivalent of the reference generator
(``load_image_gt`` + ``build_rpn_targets``, the reference's
``modal/Functions.py:675-847``, and its Dataset adapter,
``model.py:30-119``), with two deliberate changes for a static-shape
pipeline:

- every sample is padded to ``max_gt_instances`` GT slots (class_id 0 pad)
  and RPN bbox targets are emitted *aligned per anchor* [A, 4] instead of
  the compacted [256, 4] buffer (losses mask by rpn_match, identical math);
- randomness is an explicit ``np.random.Generator``.

Quirks preserved: squash-resize to the square image size, horizontal-flip
augmentation, bbox-from-mask with the ±1/15 random jitter
(the reference's ``utils.py:51``), GT capped by random subsample at
``max_gt_instances``.
"""

from __future__ import annotations

import threading
import queue as queue_mod
from typing import Dict, Iterator, Optional

import numpy as np

from ..ops.anchors import config_anchors
from ..parallel import multihost
from ..parallel.multihost import partition_ids
from ..utils import image as image_utils


def extract_bboxes(masks: np.ndarray, rng: Optional[np.random.Generator] = None,
                   jitter: bool = True) -> np.ndarray:
    """Boxes from [H, W, N] masks with the reference's ±1/15 jitter."""
    n = masks.shape[-1]
    boxes = np.zeros((n, 4), np.int32)
    for i in range(n):
        m = masks[:, :, i]
        xs = np.where(m.any(axis=0))[0]
        ys = np.where(m.any(axis=1))[0]
        if xs.shape[0]:
            x1, x2 = xs[[0, -1]]
            y1, y2 = ys[[0, -1]]
            x2 += 1
            y2 += 1
        else:
            x1 = x2 = y1 = y2 = 0
        box = np.array([y1, x1, y2, x2], np.float64)
        if jitter and rng is not None:
            span = np.array([y2 - y1, x2 - x1, y2 - y1, x2 - x1], np.float64)
            box = box + (rng.random(4) * 2 - 1) * span / 15.0
            box[box < 0] = 0
        boxes[i] = box.astype(np.int32)
    return boxes


def load_image_gt(dataset, config, image_id: int, augment: bool = False,
                  rng: Optional[np.random.Generator] = None):
    """Returns (image [S,S,3] uint8, class_ids [N], boxes_px [N,4],
    layer_masks [N, L, S, S] uint8)."""
    rng = rng or np.random.default_rng()
    image = dataset.load_image(image_id)
    mask_layers, class_ids = dataset.load_layers(image_id, config.num_layers)

    image, _, scale, _ = image_utils.resize_image(image, config.image_size)
    if mask_layers.shape[-1]:
        mask_layers = image_utils.resize_layer_masks(mask_layers, scale)
    else:
        s = config.image_size
        mask_layers = np.zeros((s, s, config.num_layers, 0), bool)

    if augment and rng.integers(0, 2):
        image = np.fliplr(image)
        mask_layers = np.fliplr(mask_layers)

    amodal = mask_layers.sum(axis=2)  # union over layers → [S,S,N]
    boxes = extract_bboxes(amodal, rng, jitter=augment)

    # [S,S,L,N] → [N,L,S,S]
    layer_masks = (np.transpose(mask_layers, (3, 2, 0, 1)) > 0).astype(np.uint8)
    return image, class_ids, boxes, layer_masks


def build_rpn_targets(anchors: np.ndarray, gt_class_ids: np.ndarray,
                      gt_boxes: np.ndarray, config,
                      rng: Optional[np.random.Generator] = None):
    """Anchor matching and regression targets.

    Returns (rpn_match [A] int32 ∈ {-1,0,1}, rpn_deltas [A,4] aligned).
    """
    rng = rng or np.random.default_rng()
    a = anchors.shape[0]
    rpn_match = np.zeros((a,), np.int32)
    rpn_deltas = np.zeros((a, 4), np.float32)

    # Degenerate (zero-area) GT boxes — e.g. a mask collapsed by the
    # nearest-neighbour downscale or the jitter's int truncation — would
    # force-match an anchor and emit log(0) = -inf regression targets,
    # silently NaN-ing training. Treat them as absent.
    if gt_boxes.shape[0]:
        nonzero = (gt_boxes[:, 2] > gt_boxes[:, 0]) & (gt_boxes[:, 3] > gt_boxes[:, 1])
        gt_boxes = gt_boxes[nonzero]
        gt_class_ids = gt_class_ids[nonzero]
    if gt_boxes.shape[0] == 0:
        rpn_match[:] = -1
        return rpn_match, rpn_deltas

    crowd_ix = np.where(gt_class_ids < 0)[0]
    if crowd_ix.shape[0]:
        non_crowd = np.where(gt_class_ids > 0)[0]
        crowd_boxes = gt_boxes[crowd_ix]
        gt_boxes = gt_boxes[non_crowd]
        overlaps_crowd = _np_iou(anchors, crowd_boxes)
        no_crowd = overlaps_crowd.max(axis=1) < 0.001
    else:
        no_crowd = np.ones((a,), bool)

    overlaps = _np_iou(anchors, gt_boxes)
    anchor_iou_argmax = overlaps.argmax(axis=1)
    anchor_iou_max = overlaps[np.arange(a), anchor_iou_argmax]

    rpn_match[(anchor_iou_max < 0.3) & no_crowd] = -1
    rpn_match[overlaps.argmax(axis=0)] = 1         # best anchor per GT
    rpn_match[anchor_iou_max >= 0.7] = 1

    # subsample positives to half the quota, negatives to the rest
    limit = config.rpn_train_anchors_per_image
    pos_ids = np.where(rpn_match == 1)[0]
    extra = len(pos_ids) - limit // 2
    if extra > 0:
        rpn_match[rng.choice(pos_ids, extra, replace=False)] = 0
    neg_ids = np.where(rpn_match == -1)[0]
    extra = len(neg_ids) - (limit - np.sum(rpn_match == 1))
    if extra > 0:
        rpn_match[rng.choice(neg_ids, extra, replace=False)] = 0

    std = np.asarray(config.rpn_bbox_std_dev, np.float64)
    for i in np.where(rpn_match == 1)[0]:
        gt = gt_boxes[anchor_iou_argmax[i]]
        anc = anchors[i]
        gt_h, gt_w = gt[2] - gt[0], gt[3] - gt[1]
        a_h, a_w = anc[2] - anc[0], anc[3] - anc[1]
        rpn_deltas[i] = np.array(
            [
                (gt[0] + 0.5 * gt_h - (anc[0] + 0.5 * a_h)) / a_h,
                (gt[1] + 0.5 * gt_w - (anc[1] + 0.5 * a_w)) / a_w,
                np.log(gt_h / a_h),
                np.log(gt_w / a_w),
            ]
        ) / std
    return rpn_match, rpn_deltas


def _np_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    y1 = np.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    x1 = np.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    y2 = np.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    x2 = np.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    union = a1[:, None] + a2[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def make_training_sample(dataset, config, image_id: int, anchors: np.ndarray,
                         rng: Optional[np.random.Generator] = None,
                         augment: bool = True) -> Optional[Dict[str, np.ndarray]]:
    """One padded training sample dict, or None if the image has no GT."""
    rng = rng or np.random.default_rng()
    image, class_ids, boxes, layer_masks = load_image_gt(
        dataset, config, image_id, augment=augment, rng=rng
    )
    if not np.any(class_ids > 0):
        return None
    rpn_match, rpn_deltas = build_rpn_targets(anchors, class_ids, boxes, config, rng)

    g = config.max_gt_instances
    n = class_ids.shape[0]
    if n > g:
        keep = rng.choice(np.arange(n), g, replace=False)
        class_ids = class_ids[keep]
        boxes = boxes[keep]
        layer_masks = layer_masks[keep]
        n = g

    s = config.image_size
    pad_ids = np.zeros((g,), np.int32)
    pad_boxes = np.zeros((g, 4), np.float32)
    pad_masks = np.zeros((g, config.num_layers, s, s), np.uint8)
    pad_ids[:n] = class_ids
    pad_boxes[:n] = boxes.astype(np.float32) / float(s)   # normalized
    pad_masks[:n] = layer_masks

    return {
        "images": image_utils.mold_image(image, config.mean_pixel),
        "rpn_match": rpn_match,
        "rpn_deltas": rpn_deltas.astype(np.float32),
        "gt_class_ids": pad_ids,
        "gt_boxes": pad_boxes,
        "gt_masks": pad_masks,
    }


class SampleOverflowError(ValueError):
    """A sample exceeded a static capacity budget (e.g. RLE run count on
    multi-host runs) and was dropped by the containment path. Counted
    separately from corrupt-data skips so systematic data loss is visible
    rather than silently biasing training."""


class TrainLoader:
    """Shuffled, prefetching batch iterator (the reference's 4-worker
    DataLoader role, as one background thread + queue)."""

    def __init__(self, dataset, config, batch_size: Optional[int] = None,
                 seed: int = 0, augment: bool = True, prefetch: int = 4,
                 workers: int = 4, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        self.config = config
        self.batch_size = batch_size or config.batch_size
        self.rng = np.random.default_rng(seed)
        self.augment = augment
        self.anchors = config_anchors(config)
        self.prefetch = prefetch
        self.workers = max(1, workers)
        self.error_count = 0
        self.overflow_count = 0
        self._samples_seen = 0
        # each process streams only its own dataset slice (one process: all
        # of it); by default the process group's rank and size
        self.process_index = (multihost.process_index() if process_index is None
                              else process_index)
        self.process_count = (multihost.process_count() if process_count is None
                              else process_count)
        self.local_ids = partition_ids(
            dataset.image_ids, self.process_index, self.process_count)

    def _make_one_sample(self, image_id: int, rng) -> Optional[Dict[str, np.ndarray]]:
        """One image's training sample (a hook for loaders that build
        their targets elsewhere)."""
        return make_training_sample(
            self.dataset, self.config, image_id, self.anchors,
            rng=rng, augment=self.augment,
        )

    def _collate(self, batch) -> Dict[str, np.ndarray]:
        """Stack a list of sample dicts into one batch dict."""
        return {k: np.stack([b[k] for b in batch]) for k in batch[0]}

    def _sample_stream(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._sample_stream_with(self.rng)

    def _sample_stream_with(self, rng) -> Iterator[Dict[str, np.ndarray]]:
        # private copy: shuffle is in-place, and the id array is shared
        # across loaders and worker threads — shuffling the original would
        # break same-seed reproducibility (and race between workers)
        ids = np.array(self.local_ids, copy=True)
        while True:
            rng.shuffle(ids)
            for image_id in ids:
                # failure containment: a corrupt image / missing .npz is
                # skipped and counted instead of killing the epoch (the
                # reference's unused error_count, model.py:62, made real).
                self._samples_seen += 1
                try:
                    s = self._make_one_sample(int(image_id), rng)
                except SampleOverflowError as e:
                    # capacity overflow, not corruption: count it on its own
                    # so a dataset that systematically blows the static
                    # budget is loudly visible instead of silently biased
                    self.overflow_count += 1
                    rate = self.overflow_count / max(self._samples_seen, 1)
                    print(f"[TrainLoader] skipping image {image_id}: {e!r} "
                          f"(overflow_skips={self.overflow_count})")
                    if self.overflow_count >= 8 and rate > 0.01:
                        print(
                            f"[TrainLoader] WARNING: {self.overflow_count}/"
                            f"{self._samples_seen} samples "
                            f"({100 * rate:.1f}%) dropped for capacity "
                            f"overflow — training data is being "
                            f"systematically filtered; preprocess the "
                            f"dataset.")
                    continue
                except (OSError, ValueError, KeyError) as e:
                    self.error_count += 1
                    print(f"[TrainLoader] skipping image {image_id}: {e!r} "
                          f"(errors={self.error_count})")
                    continue
                if s is not None:
                    yield s

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Multi-worker prefetching iterator (the reference's num_workers=4
        DataLoader role). Each worker prepares whole batches from its own
        shuffled stream with an independent child rng; bounded puts let
        workers exit (and free their queued batches) once the consumer
        stops."""
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker(worker_rng):
            stream = self._sample_stream_with(worker_rng)
            batch = []
            while not stop.is_set():
                batch.append(next(stream))
                if len(batch) == self.batch_size:
                    stacked = self._collate(batch)
                    while not stop.is_set():
                        try:
                            q.put(stacked, timeout=0.2)
                            break
                        except queue_mod.Full:
                            continue
                    batch = []

        threads = []
        for _ in range(self.workers):
            rng = np.random.default_rng(int(self.rng.integers(2 ** 63)))
            t = threading.Thread(target=worker, args=(rng,), daemon=True)
            t.start()
            threads.append(t)
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            for t in threads:
                try:
                    t.join(timeout=2.0)
                except Exception:
                    pass  # interpreter shutdown: threading may be torn down
