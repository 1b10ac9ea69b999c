"""On-device training targets (``--device_prep``): the port of the JAX
package's ``data/device_prep.py``.

The host loader (:mod:`.pipeline`) decodes the sem-dist bit-field into dense
``[N, L, S, S]`` masks, zooms them and matches every anchor in numpy. Here the
host keeps only file IO and resizes, and the rest runs on the device as plain
torch ops on batched tensors:

- **host** (:func:`encode_sample`): the image, squash-resized with PIL as
  the reference does; the ``.npz`` uint64 sem-dist map, downsampled with the
  exact index map of ``scipy.ndimage.zoom(order=0)`` (nearest resize of the
  label map commutes with the pixelwise decode), then run-length encoded
  row-major for the upload;
- **device** (:func:`prepare_batch`): the runs back to dense planes, the
  bit-field decode as 32 bit planes (no popcount in torch: the occlusion
  depth of object g is 1 + the exclusive prefix sum of the hidden bits below
  g), boxes by argmax scans, flip and ±1/15 jitter, and the RPN anchor
  matching with the quota subsample as ``topk`` over uniform draws;
- **loader** (:class:`DevicePrepLoader`): the host loader's worker threads
  encode, and one prefetch thread uploads from pinned memory and runs the
  prep on a CUDA stream of its own; the consumer's stream waits on an event
  before the step reads the batch.

The planes travel as int32 (the uint32 bytes reinterpreted): ``(x >> g) & 1``
on int32 is bit g for every g < 32, arithmetic shift or not.

The outputs equal :func:`.pipeline.make_training_sample`'s for the same
choices. The random choices (flip, jitter, the quota subsample, the GT subset
when there are more objects than GT slots) are explicit inputs
(:class:`Draws`): the distributions are the host loader's and the JAX
module's, the draws differ. The bit-field holds 32 object slots, so the
decode is exact for any valid map; crowd annotations never occur on the
sem-dist route, so the crowd branch of ``build_rpn_targets`` is host-only.

In a data-parallel run each process streams its own slice of the dataset
and preps its own rows on its own card. The JAX module assembles the
encoded rows into one global batch for one SPMD prep program, so a sample
over the RLE budget (whose dense fallback would desynchronise the processes'
programs) is skipped there and counted. No program is shared here, but the
skip is kept, so that the sample stream equals the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..utils import image as image_utils
from . import semdist
from .pipeline import SampleOverflowError, TrainLoader

NOBJ = 32  # sem-dist object slots (bit-field width per 32-bit half)
RLE_KEYS = ("image", "run_starts", "run_lo", "run_hi", "n_objects")
DENSE_KEYS = ("image", "label_lo", "label_hi", "n_objects")


def rle_budget_for(size: int) -> int:
    """Static run budget for the RLE upload of a [size, size] label map: 32
    runs per row on average, capped at size² (every pixel a run)."""
    return min(size * size, 32 * size)


# --------------------------------------------------------------------- host


def zoom0_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source indices of ``scipy.ndimage.zoom(..., order=0)`` (grid_mode
    False): coordinate ``i * (n_in-1)/(n_out-1)``, nearest by
    ``floor(x + 0.5)``."""
    if n_out <= 1 or n_in <= 1:
        return np.zeros((n_out,), np.int64)
    x = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    return np.clip(np.floor(x + 0.5).astype(np.int64), 0, n_in - 1)


def downsample_label_map(label_map: np.ndarray, size: int) -> np.ndarray:
    """Nearest-resize a [H, W] uint64 sem-dist map to [size, size] with the
    index map of the host loader's mask zoom
    (``image_utils.resize_layer_masks``)."""
    h, w = label_map.shape
    return label_map[zoom0_indices(h, size)][:, zoom0_indices(w, size)]


def rle_encode_map(small: np.ndarray, budget: int):
    """Row-major RLE of a [S, S] uint64 label map.

    Returns ``(starts [budget] int32, lo [budget] uint32, hi [budget]
    uint32, n_runs int32)``. Padding runs start at ``S*S`` (zero length on
    the device). A map of more than ``budget`` runs keeps its first
    ``budget``, and ``n_runs`` (the true count) sends the loader to the
    dense upload."""
    flat = small.ravel()
    change = np.flatnonzero(flat[1:] != flat[:-1]).astype(np.int64) + 1
    n_runs = change.shape[0] + 1
    starts = np.full((budget,), flat.size, np.int32)
    lo = np.zeros((budget,), np.uint32)
    hi = np.zeros((budget,), np.uint32)
    k = min(n_runs, budget)
    starts[0] = 0
    starts[1:k] = change[: k - 1]
    vals = flat[starts[:k].astype(np.int64)]
    lo[:k] = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi[:k] = (vals >> np.uint64(32)).astype(np.uint32)
    return starts, lo, hi, np.int32(n_runs)


def planes_from_small(small: np.ndarray):
    """uint64 label map → (lo, hi) uint32 planes (the dense-upload format)."""
    return ((small & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (small >> np.uint64(32)).astype(np.uint32))


def encode_sample(dataset, config, image_id: int,
                  dense_planes: bool = True) -> Optional[Dict[str, np.ndarray]]:
    """The host's part of one training sample: file IO and resizes. None if
    the image has no object (``make_training_sample`` skips those too).

    Carries the RLE runs and, with ``dense_planes``, the dense uint32 planes
    as well; ``dense_planes=False`` (the loader's setting) carries the raw
    uint64 ``small_map`` instead, which only an over-budget batch turns into
    planes."""
    image = dataset.load_image(image_id)
    image, _, _, _ = image_utils.resize_image(image, config.image_size)

    info = dataset.image_info[image_id]
    label_map = semdist.load_layer_file(info["path"][:-4] + ".npz")
    # the object count of the full-resolution labels, as the host loader
    # decodes before it resizes: a label lost in the resize keeps its slot
    n_objects = semdist.max_object_id(semdist.get_image_labels(label_map))
    if n_objects == 0:
        return None
    small = downsample_label_map(label_map, config.image_size)
    starts, lo, hi, n_runs = rle_encode_map(small, rle_budget_for(config.image_size))
    enc = {
        "image": np.ascontiguousarray(image, np.uint8),
        "run_starts": starts,
        "run_lo": lo,
        "run_hi": hi,
        "n_runs": n_runs,
        "n_objects": np.int32(n_objects),
    }
    if dense_planes:
        enc["label_lo"], enc["label_hi"] = planes_from_small(small)
    else:
        enc["small_map"] = small
    return enc


def upload_arrays(encoded: Dict[str, np.ndarray], rle: bool) -> Dict[str, np.ndarray]:
    """The arrays of an encoded batch that go to the device: the RLE runs or
    the dense planes, uint32 reinterpreted as int32 (same bytes)."""
    out = {}
    for k in RLE_KEYS if rle else DENSE_KEYS:
        a = np.ascontiguousarray(encoded[k])
        out[k] = a.view(np.int32) if a.dtype == np.uint32 else a
    return out


def upload(encoded: Dict[str, np.ndarray], rle: bool, device) -> Dict[str, torch.Tensor]:
    """An encoded batch on ``device``: through pinned memory and
    ``non_blocking`` copies on the current stream when it is a card."""
    device = torch.device(device)
    out = {}
    for k, a in upload_arrays(encoded, rle).items():
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


# ------------------------------------------------------------------- device


class Draws(NamedTuple):
    """The random inputs of :func:`prepare_batch`, per sample: ``flip`` [B]
    bool, uniforms in [0, 1): ``jitter`` [B, 32, 4] (box jitter),
    ``select`` [B, 32] (GT subset when objects outnumber the GT slots),
    ``pos`` and ``neg`` [B, A] (the anchor quota subsample). Each is the
    JAX module's draw of the same name (``device_prep.py:356``, ``:258``)."""

    flip: torch.Tensor
    jitter: torch.Tensor
    select: torch.Tensor
    pos: torch.Tensor
    neg: torch.Tensor

    def to(self, device) -> "Draws":
        return Draws(*(t.to(device) for t in self))


def draw(generator: torch.Generator, batch: int, num_anchors: int) -> Draws:
    """One batch's draws from ``generator``, on its device."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=generator.device)

    return Draws(uniform(batch) < 0.5, uniform(batch, NOBJ, 4), uniform(batch, NOBJ),
                 uniform(batch, num_anchors), uniform(batch, num_anchors))


def runs_to_planes(starts, lo, hi, size: int):
    """Dense [B, size, size] planes from RLE runs [B, R] on the device.
    Padding runs (``start == size*size``) repeat 0 times, and each sample's
    runs cover exactly size² pixels, so one ``repeat_interleave`` of known
    output size (no host sync) serves the whole batch."""
    total = size * size
    b = starts.shape[0]
    ends = torch.cat([starts[:, 1:], torch.full_like(starts[:, :1], total)], 1)
    counts = (ends - starts).reshape(-1).long()

    def expand(values):
        return torch.repeat_interleave(values.reshape(-1), counts,
                                       output_size=b * total).reshape(b, size, size)
    return expand(lo), expand(hi)


def bit_planes(plane: torch.Tensor) -> torch.Tensor:
    """[B, S, S] int32 → [B, 32, S, S] uint8: bit g of each pixel."""
    g = torch.arange(NOBJ, dtype=torch.int32, device=plane.device).view(1, NOBJ, 1, 1)
    return (plane[:, None] >> g).bitwise_and_(1).to(torch.uint8)


def _valid_slots(n_objects) -> torch.Tensor:
    """[B, 32] bool: slot g holds an object."""
    g = torch.arange(NOBJ, dtype=torch.int32, device=n_objects.device)
    return g[None] < n_objects[:, None]


def _decode_masks(vis, invis, n_objects, num_layers: int):
    """[B, 32, L, S, S] uint8 occlusion-layer masks from the bit planes of
    the low (visible) and high (hidden) halves: visible pixels in channel
    0, hidden ones in channel ``min(depth, L-1)`` with depth 1 + the hidden
    bits below g — ``semdist.decode_layer_masks``."""
    depth = torch.cumsum(invis, 1, dtype=torch.uint8) - invis + 1
    channel = torch.clamp(depth, max=num_layers - 1)[:, :, None]
    layer = torch.arange(num_layers, device=vis.device).view(1, 1, num_layers, 1, 1)
    masks = ((vis[:, :, None].bool() & (layer == 0))
             | (invis[:, :, None].bool() & (channel == layer)))
    return (masks & _valid_slots(n_objects)[:, :, None, None, None]).to(torch.uint8)


def _amodal_union(vis, invis, n_objects):
    """[B, 32, S, S] uint8 amodal (visible or hidden) masks."""
    return (vis | invis) * _valid_slots(n_objects)[:, :, None, None].to(torch.uint8)


def _extract_boxes(amodal, jitter=None):
    """[B, 32, 4] float32 pixel boxes (y1, x1, y2, x2); the zero box for an
    empty mask. With ``jitter`` uniforms, the reference's ±1/15 jitter
    (``pipeline.extract_bboxes``), clipped at 0 and floored as numpy's int32
    cast truncates."""
    s = amodal.shape[-1]
    any_y = amodal.amax(dim=3)                 # [B, 32, S] rows with content
    any_x = amodal.amax(dim=2)
    has = any_y.amax(dim=2) > 0
    y1 = any_y.argmax(dim=2)
    y2 = s - any_y.flip(2).argmax(dim=2)       # last index + 1
    x1 = any_x.argmax(dim=2)
    x2 = s - any_x.flip(2).argmax(dim=2)
    box = torch.stack([y1, x1, y2, x2], 2).to(torch.float32)
    box = torch.where(has[..., None], box, 0.0)
    if jitter is not None:
        h = box[..., 2] - box[..., 0]
        w = box[..., 3] - box[..., 1]
        span = torch.stack([h, w, h, w], 2)
        # a divisor on the device: the card divides by a host scalar as a
        # multiply by its reciprocal, which may round otherwise
        fifteen = torch.tensor(15.0, device=box.device)
        box = torch.floor(torch.clamp_min(box + (jitter * 2.0 - 1.0) * span / fifteen, 0.0))
    return box


def _iou_matrix(anchors, boxes):
    """[B, A, G] IoU of anchors [A, 4] and boxes [B, G, 4], zero where the
    union is empty (``pipeline._np_iou``, float32)."""
    a = anchors[None, :, None]
    g = boxes[:, None]
    y1 = torch.maximum(a[..., 0], g[..., 0])
    x1 = torch.maximum(a[..., 1], g[..., 1])
    y2 = torch.minimum(a[..., 2], g[..., 2])
    x2 = torch.minimum(a[..., 3], g[..., 3])
    inter = torch.clamp_min(y2 - y1, 0.0) * torch.clamp_min(x2 - x1, 0.0)
    a1 = (anchors[:, 2] - anchors[:, 0]) * (anchors[:, 3] - anchors[:, 1])
    a2 = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    union = a1[None, :, None] + a2[:, None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), 0.0)


def _subsample_to_quota(match, pos_u, neg_u, limit: int):
    """Zero random excess positives (beyond ``limit // 2``), then random
    excess negatives (beyond ``limit`` less the positives):
    ``build_rpn_targets``'s ``rng.choice`` as the smallest uniforms
    (``topk`` returns them in order, which the negatives' quota mask reads)."""
    inf = torch.tensor(float("inf"), device=match.device)
    pos = match == 1
    keep_idx = torch.topk(torch.where(pos, pos_u, inf), limit // 2, dim=1, largest=False).indices
    keep = torch.zeros_like(pos).scatter_(1, keep_idx, True)
    match = torch.where(pos & ~keep, 0, match)

    quota = limit - (match == 1).sum(1, dtype=torch.int32)
    neg = match == -1
    neg_idx = torch.topk(torch.where(neg, neg_u, inf), limit, dim=1, largest=False).indices
    ranks = torch.arange(limit, device=match.device)
    keep_neg = torch.zeros_like(neg).scatter_(1, neg_idx, ranks[None] < quota[:, None])
    return torch.where(neg & ~keep_neg, 0, match)


def _rpn_targets(anchors, boxes, valid_gt, pos_u, neg_u, config):
    """(rpn_match [B, A] int32, rpn_deltas [B, A, 4] float32 per anchor):
    ``pipeline.build_rpn_targets`` without the crowd branch, with no host
    sync (a scatter with a drop slot, ``where`` on device bools)."""
    b, a = boxes.shape[0], anchors.shape[0]
    # zero-area GT (collapsed by the resize or the jitter) count as absent,
    # the host loader's NaN guard
    nonzero = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    valid = valid_gt & nonzero
    has_gt = valid.any(1)

    iou = torch.where(valid[:, None, :], _iou_matrix(anchors, boxes), -1.0)
    anchor_max = iou.amax(2)
    anchor_arg = iou.argmax(2)

    match = torch.where(anchor_max < 0.3, -1, 0).to(torch.int32)
    # the best anchor of each valid GT is positive; invalid GT scatter into
    # the drop slot A
    best = torch.where(valid, iou.argmax(1), a)
    match = torch.cat([match, match.new_zeros(b, 1)], 1).scatter_(1, best, 1)[:, :a]
    match = torch.where(anchor_max >= 0.7, 1, match)
    match = _subsample_to_quota(match, pos_u, neg_u, config.rpn_train_anchors_per_image)
    # no usable GT: every anchor negative, nothing sampled
    match = torch.where(has_gt[:, None], match, -1)

    pos = match == 1
    gt = torch.gather(boxes, 1, anchor_arg[..., None].expand(b, a, 4))
    gt_h = torch.where(pos, gt[..., 2] - gt[..., 0], 1.0)
    gt_w = torch.where(pos, gt[..., 3] - gt[..., 1], 1.0)
    a_h = anchors[:, 2] - anchors[:, 0]
    a_w = anchors[:, 3] - anchors[:, 1]
    std = torch.tensor(config.rpn_bbox_std_dev, dtype=torch.float32, device=anchors.device)
    deltas = torch.stack([
        (gt[..., 0] + 0.5 * gt_h - (anchors[:, 0] + 0.5 * a_h)) / a_h,
        (gt[..., 1] + 0.5 * gt_w - (anchors[:, 1] + 0.5 * a_w)) / a_w,
        torch.log(gt_h / a_h),
        torch.log(gt_w / a_w),
    ], 2) / std
    return match, torch.where(pos[..., None], deltas, 0.0)


def _select_gt_slots(masks, boxes, n_objects, select_u, config):
    """The 32 object slots packed into ``max_gt_instances`` GT slots. At 32
    slots or more (50 by default) objects keep their order, zero-padded, as
    the host loader lays them out; below, a random subset in random order
    when there are more objects than slots, else the identity order."""
    g_slots = config.max_gt_instances
    b = masks.shape[0]
    if g_slots >= NOBJ:
        pad = g_slots - NOBJ
        masks = torch.cat([masks, masks.new_zeros((b, pad) + tuple(masks.shape[2:]))], 1)
        boxes = torch.cat([boxes, boxes.new_zeros(b, pad, 4)], 1)
        slots = torch.arange(g_slots, dtype=torch.int32, device=masks.device)
        return masks, boxes, (slots[None] < n_objects[:, None]).to(torch.int32)
    idx = torch.arange(NOBJ, dtype=torch.float32, device=masks.device)
    in_order = (idx / NOBJ)[None]                  # exact: NOBJ is a power of 2
    prio = torch.where(_valid_slots(n_objects),
                       torch.where((n_objects > g_slots)[:, None], select_u, in_order),
                       2.0 + idx)
    sel = torch.argsort(prio, dim=1, stable=True)[:, :g_slots]
    rows = torch.arange(b, device=masks.device)[:, None]
    return masks[rows, sel], boxes[rows, sel], (sel < n_objects[:, None]).to(torch.int32)


def prepare_planes(images, label_lo, label_hi, n_objects, anchors, draws: Draws, *,
                   config, augment: bool) -> Dict[str, torch.Tensor]:
    """A batch of decoded samples → the batch dict of
    ``pipeline.make_training_sample``, on the inputs' device: images [B, S,
    S, 3] uint8, label planes [B, S, S] int32, ``n_objects`` [B] int32,
    anchors [A, 4] float32. ``draws`` are read where ``augment`` and the
    config need them."""
    if augment:
        flip = draws.flip
        images = torch.where(flip[:, None, None, None], images.flip(2), images)
        label_lo = torch.where(flip[:, None, None], label_lo.flip(2), label_lo)
        label_hi = torch.where(flip[:, None, None], label_hi.flip(2), label_hi)

    vis, invis = bit_planes(label_lo), bit_planes(label_hi)
    masks = _decode_masks(vis, invis, n_objects, config.num_layers)
    boxes = _extract_boxes(_amodal_union(vis, invis, n_objects),
                           draws.jitter if augment else None)
    del vis, invis
    rpn_match, rpn_deltas = _rpn_targets(anchors, boxes, _valid_slots(n_objects),
                                         draws.pos, draws.neg, config)
    masks_g, boxes_g, class_g = _select_gt_slots(masks, boxes, n_objects, draws.select, config)

    dev = images.device
    mean = torch.tensor(config.mean_pixel, dtype=torch.float32, device=dev)
    size = torch.tensor(float(config.image_size), device=dev)
    return {
        "images": images.to(torch.float32) - mean,
        "rpn_match": rpn_match,
        "rpn_deltas": rpn_deltas,
        "gt_class_ids": class_g,
        "gt_boxes": boxes_g / size,
        "gt_masks": masks_g,
    }


def prepare_sample(image_u8, label_lo, label_hi, n_objects, anchors, draws: Draws, *,
                   config, augment: bool) -> Dict[str, torch.Tensor]:
    """One sample (unbatched inputs and draws) → its training sample dict."""
    n = torch.as_tensor(n_objects, dtype=torch.int32, device=image_u8.device)
    out = prepare_planes(image_u8[None], label_lo[None], label_hi[None], n[None], anchors,
                         Draws(*(t[None] for t in draws)), config=config, augment=augment)
    return {k: v[0] for k, v in out.items()}


def prepare_batch(batch: Dict[str, torch.Tensor], anchors, draws: Draws, *,
                  config, augment: bool) -> Dict[str, torch.Tensor]:
    """An uploaded batch (:func:`upload`: the RLE runs or the dense planes)
    → the training batch dict, on the batch's device (the JAX module's
    ``make_prepare_batch`` program)."""
    if "run_starts" in batch:
        lo, hi = runs_to_planes(batch["run_starts"], batch["run_lo"], batch["run_hi"],
                                config.image_size)
    else:
        lo, hi = batch["label_lo"], batch["label_hi"]
    return prepare_planes(batch["image"], lo, hi, batch["n_objects"], anchors, draws,
                          config=config, augment=augment)


# ------------------------------------------------------------------- loader


class DevicePrepLoader(TrainLoader):
    """The host loader whose worker threads only read and resize; the
    decode, boxes and RPN targets run on ``device`` (:func:`prepare_batch`).
    Yields the host loader's batch dicts as tensors on ``device``.

    A batch whose samples all fit the RLE budget uploads the runs; otherwise
    the dense planes (``route_counts`` counts both). With more than one
    process, every batch uploads the runs: a sample over the budget raises
    :class:`SampleOverflowError` in the worker, which skips and counts it.
    One prefetch thread uploads and prepares the next batch while the
    caller trains on this one."""

    def __init__(self, dataset, config, *args, device="cuda", **kwargs):
        super().__init__(dataset, config, *args, **kwargs)
        self.device = resolve_device(device)
        # fail fast on a dataset without .npz maps: every sample would raise
        # in the workers, and the skip-and-count loop would spin forever
        ids = self.dataset.image_ids
        if len(ids):
            probe = self.dataset.image_info[int(ids[0])]["path"][:-4] + ".npz"
            if not os.path.exists(probe):
                raise ValueError(
                    "--device_prep needs sibling .npz sem-dist maps "
                    f"(missing: {probe}); this dataset appears to use the legacy "
                    "pickle .layer format — run `python -m "
                    "sln_amodal_tpu_torch.cli.convert_dataset encode`, or drop "
                    "--device_prep")
        self._rle_budget = rle_budget_for(self.config.image_size)
        self._anchors = torch.from_numpy(self.anchors).to(self.device, torch.float32)
        self._multi = self.process_count > 1
        # the process index folded into the draw stream, so that each
        # process's slice draws its own augmentation and anchor subsample
        seed = np.random.SeedSequence([int(self.rng.integers(2 ** 63)), self.process_index])
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        self.route_counts = {"rle": 0, "dense": 0}

    def _collate(self, batch):
        """Stack the samples; build the dense planes only for a batch that
        will need them (a sample over the RLE budget)."""
        out = {k: np.stack([b[k] for b in batch]) for k in RLE_KEYS + ("n_runs",)}
        if not self._multi and int(out["n_runs"].max()) > self._rle_budget:
            planes = [planes_from_small(b["small_map"]) for b in batch]
            out["label_lo"] = np.stack([p[0] for p in planes])
            out["label_hi"] = np.stack([p[1] for p in planes])
        return out

    def _make_one_sample(self, image_id: int, rng):
        enc = encode_sample(self.dataset, self.config, image_id, dense_planes=False)
        if enc is not None and self._multi and int(enc["n_runs"]) > self._rle_budget:
            raise SampleOverflowError(
                f"sample {image_id} needs {int(enc['n_runs'])} RLE runs > budget "
                f"{self._rle_budget}; skipped on multi-process runs")
        return enc

    def _draws(self, batch_size: int) -> Draws:
        return draw(self._generator, batch_size, self._anchors.shape[0])

    def _prepare(self, encoded) -> Dict[str, torch.Tensor]:
        """Upload one encoded batch (the dense planes where :meth:`_collate`
        built them) and enqueue its prep on the current stream."""
        rle = "label_lo" not in encoded
        self.route_counts["rle" if rle else "dense"] += 1
        batch = upload(encoded, rle, self.device)
        return prepare_batch(batch, self._anchors, self._draws(len(encoded["image"])),
                             config=self.config, augment=self.augment)

    def _dispatch_stream(self):
        for encoded in super().__iter__():
            yield self._prepare(encoded)

    def __iter__(self):
        """Prefetching iterator: a thread uploads and prepares batch N+1
        (queue depth 1: one prepared batch waits) while the caller trains on
        batch N. On a card the thread enqueues on a stream of its own and
        records an event after each batch; the consumer's stream waits on it
        and the batch's tensors are marked as used there, so the allocator
        does not hand their memory back to the side stream under the step."""
        cuda = self.device.type == "cuda"
        side = None
        if cuda:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))  # the anchors' upload
        inner = self._dispatch_stream()
        q: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()
        fail: list = []

        def put(item) -> bool:
            """Blocking put that stays responsive to stop; False if stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def dispatcher():
            try:
                with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                    for item in inner:
                        event = None
                        if cuda:
                            event = torch.cuda.Event()
                            event.record(side)
                        if not put((item, event)):
                            return
            except BaseException as e:  # raised again on the consumer's side
                fail.append(e)
            put(None)  # the end of the stream (or its failure: see fail)

        t = threading.Thread(target=dispatcher, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if fail:
                        raise fail[0]
                    return
                batch, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for v in batch.values():
                        v.record_stream(stream)
                yield batch
        finally:
            stop.set()
            t.join(timeout=2.0)
