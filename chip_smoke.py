#!/usr/bin/env python3
"""Drives the PyTorch port on one NVIDIA GPU and checks it end to end.

    python3 chip_smoke.py

Phases (each prints one JSON line):

1. device — the card's name and power limit; TF32 off for convolutions and
   matmuls, so float32 means float32. The paths that go through the CLIs
   (phases 6, 9-13 but 13's phase-4 export) run the ``Config`` default,
   bfloat16 compute with float32 parameters, as users run them; phases 5,
   7 and 8 keep their float64 / float32 configs; phase 4 runs both.
2. build — the CUDA kernels built from ``sln_amodal_tpu_torch/csrc`` with
   nvcc (one process per source, all started together).
3. kernels — each kernel, called through its wrapper and custom op
   (``ops/library.py``), held against its plain PyTorch version on the card
   with seeded inputs at the shapes of both main paths (batch 2 for
   ``detect``, batch 8 for ``evaluate``), bit for bit (NMS: keeps equal;
   RoIAlign: ``torch.equal``). ``ms`` is the median time of one wrapper
   call between CUDA events (the host's work before the launch included);
   ``device_ms`` the mean device time of the wrapper's kernels per call
   from ``torch.profiler``, which also gives each NMS pass (``pass_ms``)
   and shows the RoIAlign wrapper is one launch per call; ``host_us`` the
   wrapper's host time per call, enqueued back to back. The RoIAlign
   kernel in float32 and in bfloat16 (bfloat16 levels, float32 boxes: bit
   for bit too; its bound counts 2-byte features). The RoIAlign backward
   at the train step's shapes (batch 2, 100 ROIs per image, pools 7 and 16)
   in three layouts (boxes spread over the image, clustered on a few rows,
   and "sampled": 30 clustered and 70 all-zero rows per image, as the step
   pads them; the summary line is the sampled one's) against the plain
   backward on the card, in float32 within 1e-5 of the largest gradient, in
   bfloat16 within one bfloat16 ulp of it, and two launches bit-equal; each
   op call launches each of its two kernels (``roi_align_backward_fold``,
   ``roi_align_backward_gather``) exactly once. Per layout it prints the
   serial work the layout asks: the most (ROI, row sample) entries on one
   output row and the most ROIs covering one cell. The "sampled" layout
   again at batch 8 (phase 15's step), in float32 and bfloat16, with the
   same tolerances and bit-equal repeats, and the workspace's bytes.
4. main path — ``Detector.detect`` on 2 seeded 1024² images at the full
   width of the one supported model (ResNet-101-FPN, DeepLabV2-MSC GLM at
   513², 6000 -> 1000 proposals, 100 detections), random seeded weights,
   in float32 and in bfloat16 (the same weights): per dtype the kernels'
   launch counts over that run (the backward's: 0), ms per call and peak
   device memory; for bfloat16 the share of float32's top-100 boxes it
   also keeps at IoU >= 0.9 and the largest raw mask difference on them
   (printed, not asserted).
5. reference — the whole slice at a small size in float64 on the card
   (kernels) against the CPU (plain versions): equal boxes and classes;
   then the evaluate path (``cli.train``) at 128² with the detection-biased
   checkpoint on a few synthetic images, on the card and on the CPU: equal
   result dicts (bbox, score, RLE counts) and all 12 sweep vectors equal.
6. eval — the evaluate path of ``cli.train`` at full width, bfloat16, 8
   images per ``dispatch``, over 32 synthetic COCOA-style images at 1024²
   with the detection-biased checkpoint loaded from a ``.pth``: images/s of
   the software-pipelined loop (best of two passes), device and host ms per
   batch, the device's busy share, the 12-way sweep's seconds, detections
   per image, ``both/all`` AP and AR@100 (nonzero), peak device memory, and
   the kernels' launches (NMS once and RoIAlign twice per batch, the
   backward never).
7. reference_train — one training step at 128², float64, on the card
   (kernels) and on the CPU (plain versions) from the same weights, batch
   and target-layer draws: equal sampled ROIs, losses within 1e-6
   relative, updated parameters within 1e-6 of the update's size.
8. convergence — the recipe of ``tests/test_convergence.py`` on the card
   (64², 150 heads steps, RPN biased and frozen): AP@.5 and AR@100 must
   rise above their before-training values (printed beside the JAX test's
   floors).
9. train — ``cli.train train`` at full width, bfloat16, batch 2,
   on 16 synthetic 1024² images with ground truth on the biased RPN's first
   proposals, from ``train_start_weights``: ``--stage heads`` 40 steps
   (its total loss printed every 8 steps), then ``--stage all`` 7 steps.
   Per stage (the first step is warm-up):
   median step wall and CUDA-event device ms of the steps but the first
   and the last three, images/s, loader wait per step, busy share of the
   last three steps under ``torch.profiler``, peak
   memory, first and last losses (finite), positive
   ROIs per step (> 0), the mean of the valid (not padding) sampled ROIs
   per step, and launches per step (NMS 1, RoIAlign 2, backward 2; the
   backward's device ms in the profiled steps is its two kernels').
   ``evaluate`` then loads the saved checkpoint on 8 of the images and
   must detect.

10. device_prep — the on-device training targets (``data/device_prep.py``) on
    2 samples of the train phase's 1024² set with augment on and fixed
    draws: the card's ``prepare_batch`` equals the CPU's on the same draws,
    bit for bit on images, masks, class ids and RPN matches, boxes and RPN
    deltas within 1e-6 (the measured maximum printed); the RLE and the
    dense upload give equal batches, and so do three batches of a
    ``DevicePrepLoader`` on the card and the CPU's prep of them. Host
    ``encode_sample`` ms per sample, upload and prep ms per batch (CUDA
    events), upload bytes per batch of each route and of the host loader's
    batch, runs per sample and the RLE budget.
11. train_device_prep — ``cli.train train --stage heads`` for 7 steps as
    phase 9 runs it (same weights, data and timings), eight times in turns:
    (host loader, ``--device_prep``, ``--device_prep``, host loader) twice.
    Per run and per loader: step wall, device span, images/s, busy share, loader
    wait, the loader threads' host ms, ``cudaMalloc`` calls and CUDA
    runtime host ms per step, peak memory, positives and launches per step
    (NMS 1, RoIAlign 2, backward 2).

12. data_parallel — data parallelism and gradient accumulation at phase
    9's full width, from a batch of 2 of its data whose rows both sample
    ROIs and ``train_start_weights(rpn_gradient=True)`` (so the RPN's
    gradient reaches ResNet-101 and the FPN: its norm on ``fpn.`` is
    printed, beside the norms under phase 9's weights and with the shared
    conv alone kept), deterministic algorithms, the global norm each step
    clips printed and, in (b) and (c), held within ``DP_TOLERANCE``
    (float32 1e-4, bfloat16 16 x 2^-8) relative of (a)'s: (a)
    ``Trainer`` in a one-process NCCL group equals the plain ``train_step``
    bit for bit, with the gradient all-reduce's bytes and ms for heads and
    all; (b) two processes on the one card over gloo (``python3
    chip_smoke.py data_parallel_worker RANK PORT DIR``), one row each with
    the global draws, equal to each other bit for bit and within
    ``DP_TOLERANCE`` of the update's largest element of (a), plus one
    float32 ulp of each parameter (losses a tenth of it, relative); (c)
    ``accumulate_steps=2`` over the two rows, unchanged after micro-step 1
    and within (b)'s tolerance of (a) after micro-step 2; (d)
    ``Detector(mesh=(cuda:0, cuda:0))`` on 3 of phase 6's images equals
    ``Detector`` without a mesh, and ``evaluate --data_parallel`` on 8
    equals the run without it; (e) in (b)'s processes, ``cli.train train
    --num_processes 2 --device_prep`` with the backend forced to gloo:
    process 0 alone writes the checkpoint, the parameters end equal, each
    loader streams its half. Launches counted over (a) and (c)
    (``data_parallel``) and over (d)'s mesh runs (``data_parallel_serving``).
13. serving — the serving artifact (``serve/export.py``) at full width: (a)
    ``export_detector`` of phase 4's detector at batch 2 (seconds, bytes of
    ``model.pt2``, peak device memory); (b) loaded in ``python3 chip_smoke.py
    serving_worker DIR IO``, a process that never imports
    ``sln_amodal_tpu_torch.models``: its ``detect`` of phase 4's two images
    equals ``Detector.detect`` bit for bit (rois, class ids, scores, masks),
    a one-image request (padded to 2) equals the ``Detector``'s row of that
    image, three images raise; (c) the serving ``detect``'s device ms (CUDA
    events) and wall ms beside ``Detector.detect``'s, median of 5; (d) its
    launches per ``detect`` (NMS 1, RoIAlign 2, backward 0: ``serving``);
    (e) at 128²: ``cli.export_model --model random --batch 1 --full`` writes
    an artifact that loads, whose ``last_global_label`` and detections equal
    ``Detector(detect_only=False)``'s on the same seeded weights; a mesh
    artifact over (card, card) at batch 4 (phase 5's reduced model, one GLM
    scale) on 3 images equals the mesh ``Detector`` bit for bit and the
    plain one as in phase 12 (d); (f) ``cli.train evaluate
    --trace_dir`` on 8 of phase 6's images writes a trace that names the
    NMS and RoIAlign kernels, with the results of the run without it; (g)
    the custom ops' wrapper ms and host µs from phase 3 beside PR 7's, and
    each op's host µs beside its launch function called directly (the
    dispatcher's cost).

14. parity — ``cli.run_parity --dry_run`` at full width, bfloat16, on 8
    synthetic 1024² images at ``--eval_batch 8`` with the detection-biased
    weights: the ``.pth`` that ``cli.train train`` saves and the release
    layout (``.pth`` without ``GLM_modual.*`` + ``deeplabv2.pth``) give
    identical 12-way sweeps, AR@100 > 0, NMS 1 / RoIAlign 2 / backward 0
    launches per evaluate batch, the seconds of each pass; then
    ``cli.test_images`` pickles 2 of the images and ``cli.parity_check``
    on the same ``.pth`` reports 2/2 within tolerance, and exits 1 on a
    pickle with one box moved by 3 px.
15. train_soak — ``cli.train_soak`` at batch 8, 1024², heads, 20 steps from
    the seeded init, with the host loader and with ``--device_prep``: each
    alone (its own median step ms by CUDA events, peak memory, launches),
    then under the train phase's instrumentation: finite losses, NMS 1 /
    RoIAlign 2 / backward 2 launches per step, the step wall and loader
    wait, the positive ROIs per step, and the backward kernels' device ms
    per step (``torch.profiler``, the last three steps).

Then, on lines of their own: the kernels' JSON summary, the card's name and
power limit, and ``{"ok": true, "device": {...}}`` last. Any failure raises
and the exit code is non-zero; so is it without a card.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM bytes/s and the
# float32 rate outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
IOU_FLOPS = 15          # one +1 IoU and its compare
LERP_FLOPS = 9          # three lerps per output element


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, repeats: int) -> float:
    """Median device time of ``fn`` over ``repeats`` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, repeats: int) -> float:
    """Host microseconds per call of ``fn`` enqueued back to back (no
    synchronize between calls): the work before each launch. Keep
    ``repeats`` small, so the launch queue never fills and throttles the
    host to the device's pace."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(repeats):
        fn()
    us = (time.perf_counter() - t) / repeats * 1e6
    torch.cuda.synchronize()
    return us


def device_kernels(fn, repeats: int) -> dict:
    """{kernel name: (mean device ms, launches) per call} of ``fn`` over
    ``repeats`` calls, from ``torch.profiler``, after one warm-up call.

    The profiler may drop an event of the window (seen on the card: 9
    kernel events for 10 one-launch calls), so launches per call are the
    recorded count rounded to an integer, and the device time per call is
    the mean time per recorded event times that integer. It may also record
    no device event at all in a window (seen once in a long run), so an
    empty window is profiled again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ms, launches = {}, {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms[e.name] = ms.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
                launches[e.name] = launches.get(e.name, 0) + 1
        if ms:
            break
    if not ms:
        raise RuntimeError("torch.profiler recorded no device activity")
    per_call = {name: round(launches[name] / repeats) for name in ms}
    return {name: (ms[name] / launches[name] * per_call[name], per_call[name])
            for name in ms if per_call[name] > 0}


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cluster_boxes(rng, n, image=1024.0):
    """Score-sorted proposal-like boxes in dense clusters, so suppression
    chains cross the kernel's 64-box words."""
    centers = rng.uniform(0, image, (24, 2))[rng.randint(0, 24, n)]
    half = rng.uniform(8, 96, (n, 2))
    b = np.concatenate([centers - half, centers + half], 1) + rng.randn(n, 4) * 12
    b = np.clip(b, 0, image)
    b[:, 2:] = np.maximum(b[:, 2:], b[:, :2] + 1)
    return b.astype(np.float32)


def roi_boxes(rng, b, n):
    """Normalized boxes: random, edge-touching, elongated and inverted."""
    y1, x1 = rng.uniform(-0.05, 0.95, (2, b, n))
    h, w = rng.uniform(0.01, 0.5, (2, b, n))
    boxes = np.stack([y1, x1, y1 + h, x1 + w], -1)
    boxes[:, :7] = [[0.0, 0.0, 1.0, 1.0], [0.0, 0.3, 0.4, 1.0], [0.5, 0.8, 1.0, 1.0],
                    [0.05, 0.1, 0.75, 0.12], [0.3, 0.0, 0.32, 0.95],
                    [0.6, 0.2, 0.2, 0.6], [0.2, 0.6, 0.6, 0.2]]
    return torch.from_numpy(boxes.astype(np.float32))


def check_nms(dev, b):
    from sln_amodal_tpu_torch.ops.nms import nms_sorted_batched_plain
    from sln_amodal_tpu_torch.ops.nms_cuda import nms_sorted_batched

    rng = np.random.RandomState(0)
    n, max_out, thr = 6000, 1000, 0.7
    boxes = torch.from_numpy(np.stack([cluster_boxes(rng, n) for _ in range(b)])).to(dev)
    valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    keep, keep_valid = nms_sorted_batched(boxes, valid, max_out, thr)
    keep_p, valid_p = nms_sorted_batched_plain(boxes, valid, max_out, thr)
    torch.cuda.synchronize()
    if not (torch.equal(keep, keep_p) and torch.equal(keep_valid, valid_p)):
        raise AssertionError("NMS kernel keeps differ from the plain version")
    ms = cuda_ms(lambda: nms_sorted_batched(boxes, valid, max_out, thr), 20)
    by_kernel = device_kernels(lambda: nms_sorted_batched(boxes, valid, max_out, thr), 20)
    passes = {p: sum(t for name, (t, _) in by_kernel.items() if p in name)
              for p in ("nms_mask_kernel", "nms_scan_kernel")}
    passes["other_kernels"] = sum(t for t, _ in by_kernel.values()) - sum(passes.values())
    plain_ms = cuda_ms(lambda: nms_sorted_batched_plain(boxes, valid, max_out, thr), 3)
    # what the greedy needs: each kept box against every later box
    kept = keep[keep_valid].long()
    pairs = float((n - 1 - kept).sum())
    nbytes = b * n * (16 + 1) + b * max_out * (4 + 1)
    bound_ms, bound_by = bound(nbytes, pairs * IOU_FLOPS)
    out = dict(shape=[b, n, max_out], threshold=thr, kept=int(keep_valid.sum()),
               keeps_equal=True, max_abs_err=0.0, ms=ms, pass_ms=passes,
               device_ms=sum(t for t, _ in by_kernel.values()),
               host_us=host_us(lambda: nms_sorted_batched(boxes, valid, max_out, thr), 30),
               plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    emit({"phase": "kernel", "name": "nms", **out})
    return out


def check_roi_align(dev, b, dtype=torch.float32):
    """The RoIAlign kernel's ``dtype`` instantiation (levels of ``dtype``,
    float32 boxes) against its plain version, bit for bit."""
    from sln_amodal_tpu_torch.ops.roi_align import pyramid_roi_align_plain, sample_geometry
    from sln_amodal_tpu_torch.ops.roi_align_cuda import pyramid_roi_align

    gen = torch.Generator().manual_seed(1)
    c = 256
    feats = [torch.randn((b, s, s, c), generator=gen).to(dev, dtype) for s in (256, 128, 64, 32)]
    elem = feats[0].element_size()
    shapes = [tuple(f.shape[1:]) for f in feats]
    rng = np.random.RandomState(2)
    total = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, host_us=0.0,
                 max_abs_err=0.0)
    per_shape = []
    for pool, n in ((7, 1000), (16, 100)):
        boxes = roi_boxes(rng, b, n).to(dev)
        args = (feats, boxes, (pool, pool), (1024, 1024))
        out = pyramid_roi_align(*args)
        ref = pyramid_roi_align_plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.equal(out, ref):
            raise AssertionError(f"RoIAlign pool {pool}: differs from the plain version "
                                 f"(max |diff| {err})")
        ms = cuda_ms(lambda: pyramid_roi_align(*args), 20)
        plain_ms = cuda_ms(lambda: pyramid_roi_align_plain(*args), 5)
        # the wrapper is one device kernel per call, and nothing else
        by_kernel = device_kernels(lambda: pyramid_roi_align(*args), 10)
        if [n_ for _, n_ in by_kernel.values()] != [1.0]:
            raise AssertionError(f"RoIAlign wrapper launches {by_kernel}")
        # bytes this run's data needs: the distinct feature rows its valid
        # samples touch, each box once, the output
        (lvl, vy, vx, top, bottom, _, left, right, _) = sample_geometry(
            shapes, boxes.reshape(-1, 4), (pool, pool), (1024, 1024))
        level_base = torch.tensor([0] + list(np.cumsum([s[0] * s[1] for s in shapes])[:-1]),
                                  device=dev)
        width = torch.tensor([s[1] for s in shapes], device=dev)
        img = torch.arange(b, device=dev).repeat_interleave(n)[:, None, None]
        base = (img * 10 ** 7 + level_base[lvl][:, None, None])
        rows = []
        for yy in (top, bottom):
            for xx in (left, right):
                idx = base + yy.long()[:, :, None] * width[lvl][:, None, None] + xx.long()[:, None, :]
                rows.append(idx[vy[:, :, None] & vx[:, None, :]])
        touched = int(torch.unique(torch.cat(rows)).numel())
        out_elems = b * n * pool * pool * c
        nbytes = touched * c * elem + b * n * 16 + out_elems * elem
        bound_ms, bound_by = bound(nbytes, out_elems * LERP_FLOPS)
        shape = dict(dtype=str(dtype), pool=pool, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     device_ms=sum(t for t, _ in by_kernel.values()),
                     host_us=host_us(lambda: pyramid_roi_align(*args), 30),
                     bound_ms=bound_ms, bound_by=bound_by, touched_rows=touched)
        emit({"phase": "kernel", "name": "roi_align", "batch": b, **shape})
        per_shape.append(shape)
        for k in ("ms", "device_ms", "plain_ms", "bound_ms", "host_us"):
            total[k] += shape[k]
        total["max_abs_err"] = max(total["max_abs_err"], err)
    total["bound_by"] = "bytes" if all(s["bound_by"] == "bytes" for s in per_shape) else "operations"
    emit({"phase": "kernel", "name": "roi_align", "batch": b, "dtype": str(dtype),
          "pools": "7+16", **total})
    return total


def clustered_boxes(rng, b, n, image=1024.0):
    """Normalized boxes 24-64 px wide in the top 64 px rows of the image,
    where the smoke's train phase samples its ROIs (the ground truth sits
    on the biased RPN's first proposals): many ROIs on few level rows."""
    size = rng.uniform(24, 64, (b, n, 2))
    y1 = rng.uniform(0, 64, (b, n)) - size[..., 0] / 2
    x1 = rng.uniform(0, image - 64, (b, n))
    boxes = np.stack([y1, x1, y1 + size[..., 0], x1 + size[..., 1]], -1)
    return torch.from_numpy(np.clip(boxes, 0, image).astype(np.float32) / image)


BACKWARD_LAYOUTS = ("spread", "clustered", "sampled")
BACKWARD_KERNELS = ("roi_align_backward_fold", "roi_align_backward_gather")


def backward_cases(dev, b, dtype, layouts=BACKWARD_LAYOUTS):
    """(layout, pool, wrapper args) of the RoIAlign backward at the train
    step's shapes (1024² pyramid, C=256, 100 ROIs per image, pools 7 and
    16): boxes spread over the image; clustered on a few rows as the train
    phase's ground truth sits; and "sampled" as the step sends them, 30
    clustered ROIs per image and 70 all-zero rows, the padding of
    ``detect/targets.py``. The cotangent is random and nonzero everywhere,
    padded rows too."""
    gen = torch.Generator().manual_seed(4)
    c, n = 256, 100
    shapes = [(s, s, c) for s in (256, 128, 64, 32)]
    rng = np.random.RandomState(5)
    for layout in layouts:
        for pool in (7, 16):
            if layout == "spread":
                boxes = roi_boxes(rng, b, n)
            elif layout == "clustered":
                boxes = clustered_boxes(rng, b, n)
            else:
                boxes = torch.zeros((b, n, 4))
                boxes[:, :30] = clustered_boxes(rng, b, 30)
            grad = torch.randn((b, n, pool, pool, c), generator=gen).to(dev, dtype)
            yield layout, pool, (grad, boxes.to(dev), shapes, (pool, pool), (1024, 1024), dtype)


def backward_chains(boxes, shapes, pool) -> dict:
    """The serial work the layout asks of a backward: the most (ROI, row
    sample) entries on one output row, and the most ROIs covering one output
    cell (both over every image and level), from the plain sample_geometry."""
    from sln_amodal_tpu_torch.ops.roi_align import sample_geometry

    b, n = boxes.shape[:2]
    (lvl, vy, vx, top, bottom, _, left, right, _) = [
        t.cpu() for t in sample_geometry(shapes, boxes.reshape(-1, 4), (pool, pool),
                                         (1024, 1024))]
    entries, covers = 0, 0
    for level, (hl, wl, _) in enumerate(shapes):
        for img in range(b):
            rois = [r for r in range(img * n, (img + 1) * n) if int(lvl[r]) == level]
            per_row = torch.zeros(hl, dtype=torch.int64)
            per_cell = torch.zeros((hl, wl), dtype=torch.int64)
            for r in rois:
                ys = torch.cat([top[r][vy[r]], bottom[r][vy[r]]]).long()
                xs = torch.cat([left[r][vx[r]], right[r][vx[r]]]).long()
                lo, hi = top[r][vy[r]].long(), bottom[r][vy[r]].long()
                per_row.index_add_(0, lo, torch.ones_like(lo))
                # a sample with top == bottom is one entry of its row
                per_row.index_add_(0, hi[hi != lo], torch.ones_like(hi[hi != lo]))
                rows = torch.zeros(hl, dtype=torch.bool)
                cols = torch.zeros(wl, dtype=torch.bool)
                rows[ys] = True
                cols[xs] = True
                per_cell += (rows[:, None] & cols[None, :]).long()
            entries = max(entries, int(per_row.max()))
            covers = max(covers, int(per_cell.max()))
    return {"max_entries_per_row": entries, "max_rois_per_cell": covers}


def backward_kernel_ms(by_kernel) -> dict:
    """{kernel: (device ms, launches) per call} of the RoIAlign backward's
    kernels among ``device_kernels``' output."""
    return {k: v for k, v in by_kernel.items() if "roi_align_backward" in k}


def backward_device_ms(dev, dtype=torch.float32) -> dict:
    """Device ms per call of whichever ``sln_amodal_tpu_torch`` is imported,
    per (layout, pool) of :func:`backward_cases`, with no check. ``python3
    <this file> backward_device_ms`` run from the root of another checkout
    (another commit's, for one) times that checkout's backward on the same
    inputs as the kernel check, in bfloat16 and float32."""
    from sln_amodal_tpu_torch.ops.roi_align_cuda import pyramid_roi_align_backward

    out = {}
    for layout, pool, args in backward_cases(dev, 2, dtype):
        ours = backward_kernel_ms(device_kernels(lambda: pyramid_roi_align_backward(*args), 10))
        out[f"{layout}_{pool}"] = {"device_ms": sum(t for t, _ in ours.values()),
                                   "kernels": ours}
    emit({"phase": "backward_device_ms", "dtype": str(dtype), **out})
    return out


def check_roi_align_backward(dev, b, dtype=torch.float32, layouts=BACKWARD_LAYOUTS):
    """The RoIAlign backward kernels' ``dtype`` instantiation in every layout
    of :func:`backward_cases` against the plain backward on the card, and two
    launches bit-equal. Both sum in float32, in other orders: float32
    gradients agree within 1e-5 of the largest gradient, bfloat16 ones (each
    sum rounded once) within one bfloat16 ulp of the largest gradient. Each
    op call launches each of the two kernels (``roi_align_backward_fold``,
    then ``roi_align_backward_gather``) exactly once and nothing else of
    its own. One summary line per layout (pools 7 + 16), with the
    workspace's bytes; the returned one, the table's, is the "sampled"
    layout's, as the train step sends it."""
    from sln_amodal_tpu_torch.ops.roi_align import pyramid_roi_align_backward_plain
    from sln_amodal_tpu_torch.ops.roi_align_cuda import (backward_workspace_bytes,
                                                         pyramid_roi_align_backward)

    per_shape = []
    for layout, pool, args in backward_cases(dev, b, dtype, layouts):
        grad, boxes, shapes = args[:3]
        n = boxes.shape[1]
        out = pyramid_roi_align_backward(*args)
        again = pyramid_roi_align_backward(*args)
        ref = pyramid_roi_align_backward_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(o, a) for o, a in zip(out, again)):
            raise AssertionError(f"RoIAlign backward {layout} pool {pool}: two launches differ")
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
        tol = (1e-5 * scale if dtype == torch.float32
               else 2.0 ** (math.floor(math.log2(scale)) - 7))
        if err > tol:
            raise AssertionError(f"RoIAlign backward {dtype} {layout} pool {pool}: max |diff| "
                                 f"{err} beyond {tol} (largest gradient {scale})")
        ms = cuda_ms(lambda: pyramid_roi_align_backward(*args), 20)
        plain_ms = cuda_ms(lambda: pyramid_roi_align_backward_plain(*args), 3)
        by_kernel = device_kernels(lambda: pyramid_roi_align_backward(*args), 10)
        kernel_launches = backward_kernel_ms(by_kernel)
        per_kernel = {k: [v for name, v in kernel_launches.items() if k in name]
                      for k in BACKWARD_KERNELS}
        if (any(len(v) != 1 or v[0][1] != 1 for v in per_kernel.values())
                or len(kernel_launches) != len(BACKWARD_KERNELS)):
            raise AssertionError(f"RoIAlign backward wrapper launches {by_kernel}")
        # what the function must move: every level's gradient written whole,
        # the cotangent read once, the boxes once
        elem = grad.element_size()
        nbytes = sum(b * h * w * c * elem for h, w, c in shapes) + grad.numel() * elem + b * n * 16
        # per cotangent element: two rows, two corners, two products and an add
        bound_ms, bound_by = bound(nbytes, 12 * grad.numel())
        shape = dict(dtype=str(dtype), layout=layout, pool=pool, n=n, max_abs_err=err,
                     tolerance=tol, max_rel_err=err / scale,
                     deterministic=True, ms=ms, plain_ms=plain_ms,
                     device_ms=sum(t for t, _ in kernel_launches.values()),
                     kernel_ms={k: v[0][0] for k, v in per_kernel.items()},
                     other_device_ms=sum(t for k, (t, _) in by_kernel.items()
                                         if k not in kernel_launches),
                     host_us=host_us(lambda: pyramid_roi_align_backward(*args), 30),
                     bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                     workspace_bytes=sum(backward_workspace_bytes(b, n, shapes[0][2], pool,
                                                                  pool)),
                     **backward_chains(boxes, shapes, pool))
        emit({"phase": "kernel", "name": "roi_align_backward", "batch": b, **shape})
        per_shape.append(shape)
    summaries = {}
    for layout in layouts:
        rows = [s for s in per_shape if s["layout"] == layout]
        total = {k: sum(s[k] for s in rows)
                 for k in ("ms", "device_ms", "plain_ms", "bound_ms", "host_us")}
        total["workspace_bytes_max"] = max(s["workspace_bytes"] for s in rows)
        total.update(max_abs_err=max(s["max_abs_err"] for s in rows),
                     max_rel_err=max(s["max_rel_err"] for s in rows),
                     bound_by="bytes" if all(s["bound_by"] == "bytes" for s in rows)
                     else "operations")
        emit({"phase": "kernel", "name": "roi_align_backward", "batch": b, "dtype": str(dtype),
              "layout": layout, "pools": "7+16", **total})
        summaries[layout] = total
    return dict(summaries["sampled"], layouts=summaries)


def main_path(dev, dtype="float32"):
    """Phase 4 in one compute dtype (float32 parameters either way)."""
    from sln_amodal_tpu_torch.config import Config
    from sln_amodal_tpu_torch.ops.nms_cuda import NMS_KERNEL
    from sln_amodal_tpu_torch.ops.roi_align_cuda import (ROI_ALIGN_BACKWARD_KERNEL,
                                                         ROI_ALIGN_KERNEL)
    from sln_amodal_tpu_torch.profile_infer import make_detector

    cfg = Config(compute_dtype=dtype, param_dtype="float32")
    t0 = time.perf_counter()
    # random seeded weights shaped so the path runs over real boxes (100
    # detections per image to mask)
    det = make_detector(cfg, seed=0, device=dev)
    setup_s = time.perf_counter() - t0

    rng = np.random.RandomState(0)
    size = cfg.image_size
    images = [rng.randint(0, 256, (size, size, 3), np.uint8) for _ in range(2)]
    det.detect(images)                     # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()

    calls = 3
    kernels = {"nms": NMS_KERNEL, "roi_align": ROI_ALIGN_KERNEL,
               "roi_align_backward": ROI_ALIGN_BACKWARD_KERNEL}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    wall, device_ms, results, raw = [], [], None, None
    for _ in range(calls):
        t = time.perf_counter()
        pending = det.dispatch(images)
        torch.cuda.synchronize()
        device_ms.append((time.perf_counter() - t) * 1e3)
        results = det.collect(pending)
        wall.append((time.perf_counter() - t) * 1e3)
        raw = pending.out
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    if launches != {"nms": calls, "roi_align": 2 * calls, "roi_align_backward": 0}:
        raise AssertionError(f"kernel launches on the main path: {launches}")
    d = cfg.detection_max_instances
    m2 = 2 * cfg.mask_pool_size
    if tuple(raw.detections.shape) != (2, d, 6) or tuple(raw.masks.shape) != (2, d, m2, m2, 2):
        raise AssertionError(f"shapes {tuple(raw.detections.shape)} {tuple(raw.masks.shape)}")
    if not (torch.isfinite(raw.detections).all() and torch.isfinite(raw.masks).all()):
        raise AssertionError("non-finite outputs")
    n_det = [len(r["scores"]) for r in results]
    if min(n_det) == 0 or any(r["masks"].shape != (size, size, k) for r, k in zip(results, n_det)):
        raise AssertionError(f"detections per image {n_det}")
    out = dict(dtype=dtype, batch=2, image=size, calls=calls,
               ms_per_detect=statistics.median(wall),
               device_ms_per_detect=statistics.median(device_ms), setup_s=setup_s,
               peak_mem_bytes=int(peak), launches=launches, detections=n_det)
    emit({"phase": "main_path", **out})
    # phase 13 serves the float32 detector's weights and holds its results
    return dict(out, detector=det, images=images, results=results, raw=raw)


def pixel_iou(a, b):
    """IoU matrix of pixel boxes [N, 4] and [M, 4] (y1, x1, y2, x2)."""
    a, b = a[:, None].astype(np.float64), b[None].astype(np.float64)
    inter = (np.clip(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0, None)
             * np.clip(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0,
                       None))
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def main_paths(dev):
    """Phase 4: ``Detector.detect`` at full width in float32 and in
    bfloat16 on the same seeded images and weights; for bfloat16, the share
    of float32's top-100 boxes it also keeps at IoU >= 0.9 and the largest
    difference of the raw mask outputs on those pairs (printed, not
    asserted: bfloat16 is another rounding of the same function)."""
    paths = {}
    for dtype in ("float32", "bfloat16"):
        paths[dtype] = main_path(dev, dtype)
        if dtype != "float32":
            paths[dtype].pop("detector")
            torch.cuda.empty_cache()
    f32, bf16 = paths["float32"], paths["bfloat16"]
    kept, mask_diff = [], 0.0
    for i in range(2):
        ref = f32["raw"].detections[i].cpu().numpy()
        got = bf16["raw"].detections[i].cpu().numpy()
        iou = pixel_iou(ref[:, :4], got[:, :4])
        matched = iou.max(1) >= 0.9
        kept.append(float(matched.mean()))
        for r, g in zip(np.nonzero(matched)[0], iou.argmax(1)[matched]):
            diff = (bf16["raw"].masks[i, g] - f32["raw"].masks[i, r]).abs().max()
            mask_diff = max(mask_diff, float(diff))
    emit({"phase": "main_path", "dtype": "bfloat16_vs_float32",
          "top100_kept_at_iou_0.9": kept, "max_mask_abs_diff_on_kept": mask_diff,
          "device_ms_per_detect": {k: p["device_ms_per_detect"] for k, p in paths.items()},
          "ms_per_detect": {k: p["ms_per_detect"] for k, p in paths.items()},
          "peak_mem_bytes": {k: p["peak_mem_bytes"] for k, p in paths.items()}})
    return paths


def reference_check(dev):
    """Small input, float64: the card's path (kernels) against the CPU's
    (plain versions) on the same seeded weights."""
    from sln_amodal_tpu_torch.config import Config
    from sln_amodal_tpu_torch.convert import init_params
    from sln_amodal_tpu_torch.infer import Detector

    cfg = Config(image_size=128, backbone="resnet50", glm_input_size=65,
                 pre_nms_limit=400, post_nms_rois_inference=64,
                 detection_max_instances=8, compute_dtype="float64", param_dtype="float64")
    sd = init_params(cfg, seed=0, device="cpu")
    for key, s in (("rpn.conv_class.weight", 1e-3), ("rpn.conv_bbox.weight", 1e-4),
                   ("classifier.linear_class.weight", 1e-2),
                   ("classifier.linear_bbox.weight", 1e-3)):
        sd[key] = sd[key] * s
    sd["classifier.linear_class.bias"][1] = 2.0
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, (128, 128, 3), np.uint8) for _ in range(2)]
    outs = []
    for device in (dev, "cpu"):
        d = Detector(cfg, sd, device=device)
        outs.append(d._fetch(d.dispatch(images)))
    (det_g, masks_g), (det_c, masks_c) = outs
    n = int((det_c[..., 4] > 0).sum())
    if n == 0 or not np.array_equal(det_g[..., :5], det_c[..., :5]):
        raise AssertionError("card and CPU detections differ")
    score_err = float(np.abs(det_g[..., 5] - det_c[..., 5]).max())
    mask_err = float(np.abs(masks_g - masks_c).max())
    if score_err > 1e-6 or mask_err > 1e-5:
        raise AssertionError(f"scores {score_err} / masks {mask_err} beyond float32 rounding")
    emit({"phase": "reference", "detections": n, "boxes_equal": True,
          "score_max_abs_err": score_err, "mask_max_abs_err": mask_err})


def biased_checkpoint(cfg, log_dir) -> str:
    """The detection-biased state_dict of ``cfg``'s model
    (``utils/synthetic.py::detection_biased_init``), saved as a reference
    ``.pth``."""
    from sln_amodal_tpu_torch.train import checkpoint as ckpt
    from sln_amodal_tpu_torch.utils.synthetic import detection_biased_init

    return ckpt.save(detection_biased_init(cfg), log_dir, "biased", 1)


def evaluate_args(root, model, batch, device):
    from sln_amodal_tpu_torch.cli import train as cli

    return cli.build_parser().parse_args([
        "evaluate", "--dataset", root, "--model", model, "--data_type", "COCOA",
        "--eval_batch", str(batch), "--device", str(device)])


def reference_eval(dev, tmp):
    """The evaluate path of ``cli.train`` at 128², float64, on the card
    (kernels) and on the CPU (plain versions): the result dicts and the 12
    sweep vectors must be equal."""
    from sln_amodal_tpu_torch.cli import train as cli
    from sln_amodal_tpu_torch.config import Config
    from sln_amodal_tpu_torch.utils.synthetic import biased_pair, make_synthetic_dataset

    cfg = Config(image_size=128, backbone="resnet50", glm_input_size=65,
                 pre_nms_limit=400, post_nms_rois_inference=64,
                 detection_max_instances=32, compute_dtype="float64", param_dtype="float64")
    root = make_synthetic_dataset(os.path.join(tmp, "small"), n_images=4, size=cfg.image_size,
                                  subset="val", seed=1, regions=biased_pair(cfg),
                                  alternate_stuff=True)
    model = biased_checkpoint(cfg, os.path.join(tmp, "small_logs"))
    runs = []
    for device in (dev, "cpu"):
        args = evaluate_args(root, model, 2, device)
        dataset, coco, ids = cli.load_eval_dataset(args)
        detector = cli.make_detector(args, cfg)
        results = cli.predict(detector, dataset, ids, args.eval_batch, progress=False)
        runs.append((results, cli.score(coco, dataset, ids, results, "COCOA", verbose=False)))
    (res_g, stats_g), (res_c, stats_c) = runs
    if not res_c or len(res_g) != len(res_c) or any(g != c for g, c in zip(res_g, res_c)):
        raise AssertionError("card and CPU evaluate result dicts differ")
    if not all(np.array_equal(stats_g[k], stats_c[k]) for k in stats_c):
        raise AssertionError("card and CPU 12-way sweeps differ")
    emit({"phase": "reference_eval", "images": len(ids), "results": len(res_c),
          "results_equal": True, "sweeps_equal": True,
          "both_all_ap": float(stats_c["both/all"][0]),
          "both_all_ar100": float(stats_c["both/all"][5])})


@contextlib.contextmanager
def timed_loop(cli, detector):
    """Records, per batch of the pipelined loop, the host ms of its three
    steps (image load, ``dispatch``, drain = ``collect_crops`` + RLE) and the
    CUDA events around its ``dispatch`` (their span on the device runs from
    the end of the previous batch's work to the end of this batch's)."""
    rec = {"load": [], "dispatch": [], "drain": [], "events": []}
    load, drain, dispatch = cli.load_batch, cli.coco_results, detector.dispatch

    def timed(fn, key):
        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            rec[key].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    def dispatch_with_events(images):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = dispatch(images)
        end.record()
        rec["events"].append((start, end))
        return out

    cli.load_batch, cli.coco_results = timed(load, "load"), timed(drain, "drain")
    detector.dispatch = timed(dispatch_with_events, "dispatch")
    try:
        yield rec
    finally:
        cli.load_batch, cli.coco_results = load, drain
        del detector.dispatch


def eval_path(dev, tmp):
    """Phase 6: ``cli.train``'s evaluate path on the card at full width."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sln_amodal_tpu_torch.cli import train as cli
    from sln_amodal_tpu_torch.eval_amodal import rle
    from sln_amodal_tpu_torch.ops.nms_cuda import NMS_KERNEL
    from sln_amodal_tpu_torch.ops.roi_align_cuda import (ROI_ALIGN_BACKWARD_KERNEL,
                                                         ROI_ALIGN_KERNEL)
    from sln_amodal_tpu_torch.utils.synthetic import biased_pair, make_synthetic_dataset

    n_images, batch = 32, 8
    t0 = time.perf_counter()
    root = os.path.join(tmp, "eval")
    config = cli.eval_config(evaluate_args(root, "", batch, dev))
    make_synthetic_dataset(root, n_images=n_images, size=config.image_size, subset="val",
                           seed=2, regions=biased_pair(config), alternate_stuff=True)
    args = evaluate_args(root, biased_checkpoint(config, os.path.join(tmp, "eval_logs")),
                         batch, dev)
    dataset, coco, ids = cli.load_eval_dataset(args)
    detector = cli.make_detector(args, config)
    setup_s = time.perf_counter() - t0
    cli.predict(detector, dataset, ids[:batch], batch, progress=False)   # warm-up
    torch.cuda.synchronize()

    batches = 2 * len(range(0, len(ids), batch))
    kernels = {"nms": NMS_KERNEL, "roi_align": ROI_ALIGN_KERNEL,
               "roi_align_backward": ROI_ALIGN_BACKWARD_KERNEL}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    walls, passes = [], []
    with timed_loop(cli, detector) as rec:
        for _ in range(2):
            t = time.perf_counter()
            passes.append(cli.predict(detector, dataset, ids, batch, progress=False))
            walls.append(time.perf_counter() - t)
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != {"nms": batches, "roi_align": 2 * batches, "roi_align_backward": 0}:
        raise AssertionError(f"kernel launches over {batches} evaluate batches: {launches}")
    results = passes[-1]
    if passes[0] != results:
        raise AssertionError("two passes over the same images gave other results")

    # device busy share: kernel and copy time over one more pass's wall time,
    # under torch.profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        cli.predict(detector, dataset, ids, batch, progress=False)
        profiled_wall = time.perf_counter() - t
    # and the host's time inside CUDA runtime calls (a launch blocks while
    # the launch queue is full; a pageable upload waits for the stream)
    busy_ms, runtime_ms = 0.0, {}
    for e in prof.events():
        ms = (e.time_range.end - e.time_range.start) / 1e3
        if e.device_type == DeviceType.CUDA:
            busy_ms += ms
        elif e.name.startswith("cuda"):
            runtime_ms[e.name] = runtime_ms.get(e.name, 0.0) + ms

    t = time.perf_counter()
    stats = cli.score(coco, dataset, ids, results, "COCOA", verbose=False)
    sweep_s = time.perf_counter() - t

    per_image = [sum(r["image_id"] == dataset.image_info[i]["id"] for r in results) for i in ids]
    least_area = min(rle.area(r["segmentation"]) for r in results)
    if min(per_image) == 0 or least_area == 0:
        raise AssertionError(f"detections per image {per_image}, least mask area {least_area}")
    if not all(np.isfinite(v).all() for v in stats.values()) or stats["both/all"][5] <= 0:
        raise AssertionError(f"both/all stats {stats['both/all']}: AR@100 must be > 0")
    spans = [s.elapsed_time(e) for s, e in rec["events"]]
    out = dict(images=n_images, batch=batch, image=config.image_size,
               dtype=config.compute_dtype, setup_s=setup_s,
               images_per_s=n_images / min(walls), pass_s=walls,
               device_span_ms_per_batch=statistics.mean(spans),
               device_span_share=sum(spans) / 1e3 / sum(walls),
               device_busy_ms_per_batch=busy_ms / (batches // 2),
               busy_share=busy_ms / 1e3 / profiled_wall, profiled_pass_s=profiled_wall,
               host_ms_per_batch={k: statistics.mean(rec[k]) for k in ("load", "dispatch", "drain")},
               host_cuda_runtime_ms_per_batch={k: v / (batches // 2) for k, v in
                                               sorted(runtime_ms.items(), key=lambda kv: -kv[1])
                                               if v / (batches // 2) >= 0.5},
               sweep_s=sweep_s, detections_per_image=statistics.mean(per_image),
               both_all_ap=float(stats["both/all"][0]),
               both_all_ar100=float(stats["both/all"][5]),
               peak_mem_bytes=int(peak), batches=batches, launches=launches)
    emit({"phase": "eval", **out})
    return dict(out, root=root, model=args.model)


def one_step(model, batch, stage, lr, seed):
    """One training step, keeping the graph's outputs: (outputs, losses)."""
    from sln_amodal_tpu_torch.train.optim import StagedSGD
    from sln_amodal_tpu_torch.train.trainer import batched_losses

    opt = StagedSGD(model, stage, lr)
    out = model.train_step_outputs(batch["images"], batch["gt_class_ids"], batch["gt_boxes"],
                                   batch["gt_masks"],
                                   generator=torch.Generator().manual_seed(seed))
    losses = batched_losses(out, batch)
    opt.zero_grad()
    losses["total"].backward()
    opt.step()
    return out, {k: float(v.detach()) for k, v in losses.items()}


def reference_train(dev, tmp):
    """One training step ("all" stage) at 128², float64, on the card
    (kernels) and on the CPU (plain versions), from the same RPN-biased
    weights, batch and target-layer draws: equal sampled ROIs and class ids,
    losses within 1e-6 relative, updated parameters within 1e-6 of the
    update's size."""
    from sln_amodal_tpu_torch.config import Config
    from sln_amodal_tpu_torch.convert import init_params
    from sln_amodal_tpu_torch.data.dataset import AmodalDataset
    from sln_amodal_tpu_torch.data.pipeline import TrainLoader
    from sln_amodal_tpu_torch.models.sln import SLNAmodal
    from sln_amodal_tpu_torch.train.trainer import to_device
    from sln_amodal_tpu_torch.utils.synthetic import (biased_pair, make_synthetic_dataset,
                                                      rpn_biased_variables)

    cfg = Config(image_size=128, backbone="resnet50", glm_input_size=65, pre_nms_limit=400,
                 post_nms_rois_training=64, post_nms_rois_inference=64,
                 detection_max_instances=32, train_rois_per_image=16, max_gt_instances=8,
                 batch_size=2, compute_dtype="float64", param_dtype="float64")
    root = make_synthetic_dataset(os.path.join(tmp, "train_small"), n_images=4,
                                  size=cfg.image_size, seed=3, regions=biased_pair(cfg))
    ds = AmodalDataset()
    ds.load_amodal(root, "train")
    ds.prepare()
    loader = iter(TrainLoader(ds, cfg, seed=0, workers=1))
    batch_np = next(loader)
    sd = rpn_biased_variables(init_params(cfg, seed=0, device="cpu"))
    runs = []
    for device in (dev, "cpu"):
        model = SLNAmodal(cfg, device=device)
        model.load_state_dict(sd)
        out, losses = one_step(model, to_device(batch_np, device), "all", 1e-3, seed=11)
        runs.append((out, losses, {k: v.detach().cpu() for k, v in model.named_parameters()}))
    (out_g, loss_g, par_g), (out_c, loss_c, par_c) = runs
    t_g, t_c = out_g.targets, out_c.targets
    if not (torch.equal(t_g.rois.cpu(), t_c.rois) and torch.equal(t_g.class_ids.cpu(), t_c.class_ids)
            and torch.equal(t_g.valid.cpu(), t_c.valid)):
        raise AssertionError("card and CPU sampled other ROIs")
    positives = int(t_c.positive.sum())
    loss_err = max(abs(loss_g[k] - loss_c[k]) / max(abs(loss_c[k]), 1e-30) for k in loss_c)
    update = max(float((par_c[k] - sd[k].to(par_c[k].dtype)).abs().max()) for k in par_c)
    param_err = max(float((par_g[k] - par_c[k]).abs().max()) for k in par_c)
    if positives == 0 or loss_err > 1e-6 or param_err > 1e-6 * update:
        raise AssertionError(f"train step: positives {positives}, losses rel {loss_err}, "
                             f"params {param_err} of update {update}")
    emit({"phase": "reference_train", "rois_equal": True, "positives": positives,
          "losses_cpu": loss_c, "loss_max_rel_err": loss_err, "update_max_abs": update,
          "param_max_abs_err": param_err, "param_err_of_update": param_err / update})


@contextlib.contextmanager
def deterministic():
    """cuDNN's and ATen's deterministic algorithms, restored on exit. Ops
    without one warn instead of raising."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
        if saved[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[4]


def convergence(dev, tmp, steps=150):
    """The recipe of tests/test_convergence.py on the card: 64², ``steps``
    (150) steps of the ROI heads at batch 2 with the RPN biased and frozen; AP@.5 and
    AR@100 (both/all) of the 4 validation images must rise above their
    before-training values. One loader thread and deterministic algorithms
    make the run repeatable: with four threads (their batches interleave as
    they finish) and cuDNN's fastest algorithms each run took another path,
    and on an H100 one run in seven fell below the before-training values."""
    from sln_amodal_tpu_torch.cli import train as cli
    from sln_amodal_tpu_torch.config import Config
    from sln_amodal_tpu_torch.convert import init_params
    from sln_amodal_tpu_torch.data.pipeline import TrainLoader
    from sln_amodal_tpu_torch.infer import Detector
    from sln_amodal_tpu_torch.train.trainer import Trainer
    from sln_amodal_tpu_torch.utils.synthetic import (make_synthetic_dataset,
                                                      rpn_biased_variables)

    root = os.path.join(tmp, "conv")
    make_synthetic_dataset(root, n_images=8, size=64, seed=0)
    make_synthetic_dataset(root, n_images=4, size=64, subset="val", seed=7,
                           alternate_stuff=True)
    cfg = Config(image_size=64, glm_input_size=33, batch_size=2, pre_nms_limit=512,
                 post_nms_rois_inference=256, post_nms_rois_training=64,
                 train_rois_per_image=16, detection_max_instances=100, max_gt_instances=8,
                 rpn_train_anchors_per_image=64, compute_dtype="float32",
                 param_dtype="float32", name="cocoa")
    icfg = cfg.replace(batch_size=1, detection_min_confidence=0.0)
    args = evaluate_args(root, "", 1, dev)
    dataset, coco, ids = cli.load_eval_dataset(args)

    def headline(state_dict):
        det = Detector(icfg, state_dict, device=dev)
        results = cli.predict(det, dataset, ids, 1, progress=False)
        stats = cli.score(coco, dataset, ids, results, "COCOA", verbose=False)
        return (0.0, 0.0) if stats is None else (float(stats["both/all"][1]),
                                                 float(stats["both/all"][5]))

    sd = rpn_biased_variables(init_params(cfg, seed=0, device="cpu"))
    with deterministic():
        before = headline(sd)
        trainer = Trainer(cfg, sd, device=dev)
        t = time.perf_counter()
        losses = trainer.train_stage(
            TrainLoader(cli.load_train_dataset(args, "train"), cfg, seed=0, workers=1),
            lambda name: name.startswith(("classifier.", "mask.")), cfg.learning_rate,
            epochs=1, steps_per_epoch=steps)
        train_s = time.perf_counter() - t
        after = headline(trainer.model.state_dict())
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"convergence losses {losses}")
    if not (after[0] > before[0] and after[1] > before[1]):
        raise AssertionError(f"training did not lift AP@.5 / AR@100: {before} -> {after}")
    emit({"phase": "convergence", "steps": steps, "train_s": train_s,
          "ap50_before": before[0], "ar100_before": before[1],
          "ap50_after": after[0], "ar100_after": after[1],
          "jax_test_floors": {"ap50": 0.04, "ar100": 0.15}, "final_losses": losses})


@contextlib.contextmanager
def timed_train(trainer_mod, cli, kernels, profile_last):
    """Records, per train step of ``cli.train``'s loop: host wall ms (the
    step ends in a synchronize), the CUDA events' device span, the losses,
    the positive and the valid (not padding) sampled ROIs, each kernel's
    launches, the caching allocator's
    ``cudaMalloc`` calls, and the loader's wait; per sample, the host ms of
    the loader's worker threads (``_make_one_sample``), and per batch of a
    ``DevicePrepLoader``, the host ms of its prefetch thread (``_prepare``:
    the pinned upload and the prep's launches). The last ``profile_last``
    steps of each stage run under ``torch.profiler`` (kernel time over step
    wall: the busy share; host ms in CUDA runtime calls) and are left out
    of the timings."""
    from torch.profiler import ProfilerActivity, profile

    rec = {"steps": [], "loader_wait_ms": [], "positives": [], "valid_rois": [], "stages": [],
           "loaders": [], "sample_ms": [], "prepare_ms": []}
    step_fn, losses_fn = trainer_mod.train_step, trainer_mod.batched_losses
    loader_classes = (cli.TrainLoader, cli.DevicePrepLoader)
    state = {"n": 0, "total": 0, "prof": None}

    def batched_losses(out, batch):
        rec["positives"].append(out.targets.positive.sum())
        rec["valid_rois"].append(out.targets.valid.sum())
        return losses_fn(out, batch)

    def train_step(model, optimizer, batch, generator=None, uniforms=None):
        i = state["n"]
        if i == state["total"] - profile_last:
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].start()
        before = [k.launches for k in kernels]
        mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        losses = step_fn(model, optimizer, batch, generator, uniforms)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        rec["steps"].append(dict(wall_ms=wall, device_ms=start.elapsed_time(end),
                                 device_mallocs=torch.cuda.memory_stats().get(
                                     "num_device_alloc", 0) - mallocs,
                                 losses={k: float(v) for k, v in losses.items()},
                                 positives=int(rec["positives"][-1]),
                                 valid_rois=int(rec["valid_rois"][-1]),
                                 launches=[k.launches - b for k, b in zip(kernels, before)],
                                 profiled=state["prof"] is not None))
        state["n"] += 1
        return losses

    def timed_method(obj, name, key):
        fn = getattr(obj, name)

        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            rec[key].append((time.perf_counter() - t) * 1e3)
            return out
        setattr(obj, name, call)

    def timed_loader(loader_cls):
        class TimedLoader(loader_cls):
            def __iter__(self):
                rec["loaders"].append(self)
                timed_method(self, "_make_one_sample", "sample_ms")
                if hasattr(self, "_prepare"):
                    timed_method(self, "_prepare", "prepare_ms")
                it = super().__iter__()
                while True:
                    t = time.perf_counter()
                    batch = next(it)
                    rec["loader_wait_ms"].append((time.perf_counter() - t) * 1e3)
                    yield batch
        return TimedLoader

    def stage(total_steps):
        state.update(n=0, total=total_steps, prof=None)

    def stop_profile():
        """(device ms of the profiled steps' kernels, {kernel: ms} of the
        port's three kernels among them, {CUDA runtime call: host ms})."""
        prof = state["prof"]
        if prof is None:
            return 0.0, {}, {}
        prof.stop()
        from torch.autograd import DeviceType
        spans = [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "Memcpy" not in e.name
                 and "Memset" not in e.name]
        # the backward's kernels by their common prefix (its fold and gather)
        ours = {k: sum(ms for name, ms in spans if k in name)
                for k in ("nms_mask_kernel", "nms_scan_kernel", "roi_align_kernel",
                          "roi_align_backward_")}
        runtime = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA and e.name.startswith("cuda"):
                runtime[e.name] = runtime.get(e.name, 0.0) + (e.time_range.end
                                                              - e.time_range.start) / 1e3
        return sum(ms for _, ms in spans), ours, runtime

    trainer_mod.train_step, trainer_mod.batched_losses = train_step, batched_losses
    cli.TrainLoader, cli.DevicePrepLoader = (timed_loader(c) for c in loader_classes)
    try:
        yield rec, stage, stop_profile
    finally:
        trainer_mod.train_step, trainer_mod.batched_losses = step_fn, losses_fn
        cli.TrainLoader, cli.DevicePrepLoader = loader_classes


def train_start_weights(cfg, dev, rpn_gradient: bool = False) -> dict:
    """The train phase's starting state_dict: the seeded init under the
    RPN-biased recipe, and three changes that make its checks hold on
    noise images and a random trunk (``rpn_gradient=True`` replaces the
    first: the shared RPN conv keeps its seeded values and the box conv,
    zero in the recipe, takes its seeded weights times 1e-3, so that the
    RPN's box loss sends a gradient into the trunk while the proposals
    stay the anchors in order, all scores equal):

    - the shared RPN conv zero: its features are 0 (and its ReLU passes no
      gradient), so training moves only the RPN's per-anchor-shape biases
      and the proposals stay the anchors in order, where the ground truth
      sits (with a random trunk, one SGD step of the RPN reorders the
      anchors and the positives vanish);
    - the FPN's smooth convs scaled so P2..P5 have unit RMS on a seeded
      noise image: under identity frozen batch norm the random ResNet-101
      grows its activations some 500-fold, and at that scale one clipped
      SGD step moves a classifier logit by tens, so the classifier swings
      between all foreground and all background from step to step;
    - a zero class kernel with a +8 foreground bias (as
      :func:`detection_biased_variables`): noise images give the classifier
      nothing to tell positive ROIs from negative ones by, so it can only
      learn the sampler's 1:2 prior, which detects nothing; at unit scale
      14 steps move a logit by a few units, and the trained checkpoint
      still detects."""
    from sln_amodal_tpu_torch.convert import init_params
    from sln_amodal_tpu_torch.models.sln import SLNAmodal
    from sln_amodal_tpu_torch.utils.synthetic import rpn_biased_variables

    seeded = init_params(cfg, seed=0, device="cpu")
    sd = rpn_biased_variables(seeded)
    if rpn_gradient:
        sd["rpn.conv_bbox.weight"] = seeded["rpn.conv_bbox.weight"] * 1e-3
    else:
        sd["rpn.conv_shared.weight"].zero_()
        sd["rpn.conv_shared.bias"].zero_()
    sd["classifier.linear_class.weight"].zero_()
    sd["classifier.linear_class.bias"].copy_(torch.tensor([0.0, 8.0]))
    model = SLNAmodal(cfg, device=dev)
    model.load_state_dict(sd)
    size = cfg.image_size
    image = torch.randn(1, size, size, 3, generator=torch.Generator().manual_seed(0)) * 74.0
    with torch.no_grad():
        rms = max(float(p.float().pow(2).mean().sqrt())
                  for p in model.fpn(image.to(dev, model.compute_dtype))[:4])
    for level in range(2, 6):
        for kind in ("weight", "bias"):
            sd[f"fpn.P{level}_conv2.1.{kind}"] /= rms
    return sd


KERNEL_NAMES = ("nms", "roi_align", "roi_align_backward")


def train_kernels():
    from sln_amodal_tpu_torch.ops.nms_cuda import NMS_KERNEL
    from sln_amodal_tpu_torch.ops.roi_align_cuda import (ROI_ALIGN_BACKWARD_KERNEL,
                                                         ROI_ALIGN_KERNEL)

    return NMS_KERNEL, ROI_ALIGN_KERNEL, ROI_ALIGN_BACKWARD_KERNEL


def run_train_stages(dev, runs, common):
    """``cli.train train`` once per (label, stage, steps, extra arguments)
    of ``runs``, under :func:`timed_train` with the kernels' counts set to
    0 first. Checks each run (finite losses, positive ROIs and launches NMS
    1, RoIAlign 2, backward 2 every step) and returns ({label: its
    numbers}, {kernel: launches over the runs}, the loaders the runs
    iterated)."""
    from sln_amodal_tpu_torch.cli import train as cli
    from sln_amodal_tpu_torch.train import trainer as trainer_mod

    kernels = train_kernels()
    stages = {}
    for k in kernels:
        k.launches = 0
    with timed_train(trainer_mod, cli, kernels, profile_last=3) as (rec, stage, stop_profile):
        for label, name, steps, extra in runs:
            stage(steps)
            first = len(rec["steps"])
            marks = {k: len(rec[k]) for k in ("loader_wait_ms", "sample_ms", "prepare_ms")}
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            out = cli.main(["train", "--stage", name, "--epochs", "1", "--steps_per_epoch",
                            str(steps), *extra, *common])
            stage_s = time.perf_counter() - t
            busy_ms, kernel_ms, runtime_ms = stop_profile()
            new = {k: rec[k][n:] for k, n in marks.items()}
            steps_rec = rec["steps"][first:]
            timed = [s for s in steps_rec[1:] if not s["profiled"]]
            profiled = [s for s in steps_rec if s["profiled"]]
            losses = [s["losses"]["total"] for s in steps_rec]
            if len(steps_rec) != steps or not all(np.isfinite(v) for s in steps_rec
                                                  for v in s["losses"].values()):
                raise AssertionError(f"stage {name}: steps {steps_rec}")
            if min(s["positives"] for s in steps_rec) == 0:
                raise AssertionError(f"stage {name}: a step sampled no positive ROI: "
                                     f"{[s['positives'] for s in steps_rec]}")
            if any(s["launches"] != [1, 2, 2] for s in steps_rec):
                raise AssertionError(f"stage {name}: launches per step "
                                     f"{[s['launches'] for s in steps_rec]}")
            wall = statistics.median(s["wall_ms"] for s in timed)
            stages[label] = dict(
                steps=steps, checkpoint=os.path.basename(out.checkpoints[-1]),
                step_wall_ms_median=wall,
                step_device_ms_median=statistics.median(s["device_ms"] for s in timed),
                step_wall_ms=[s["wall_ms"] for s in steps_rec],
                images_per_s=2 * 1e3 / wall, stage_wall_s=stage_s,
                loader_wait_ms_per_step=statistics.mean(new["loader_wait_ms"]),
                loader_wait_ms=new["loader_wait_ms"],
                worker_ms_per_sample=statistics.mean(new["sample_ms"]),
                prefetch_ms_per_batch=(statistics.mean(new["prepare_ms"])
                                       if new["prepare_ms"] else None),
                device_mallocs_per_step=[s["device_mallocs"] for s in steps_rec],
                timed_steps=len(timed), profiled_steps=len(profiled),
                busy_share_profiled_steps=busy_ms / sum(s["wall_ms"] for s in profiled),
                kernel_device_ms_per_profiled_step={k: v / len(profiled)
                                                    for k, v in kernel_ms.items()},
                cuda_runtime_host_ms_per_profiled_step={
                    k: v / len(profiled) for k, v in sorted(runtime_ms.items(),
                                                            key=lambda kv: -kv[1])
                    if v / len(profiled) >= 0.5},
                peak_mem_bytes=int(torch.cuda.max_memory_allocated(dev)),
                first_losses=steps_rec[0]["losses"], last_losses=steps_rec[-1]["losses"],
                total_loss_by_step=losses,
                positives_per_step=[s["positives"] for s in steps_rec],
                # the sampled ROIs that are not padding, of 100 per image
                valid_rois_per_step_mean=statistics.mean(s["valid_rois"] for s in steps_rec),
                launches_per_step=dict(zip(KERNEL_NAMES, steps_rec[-1]["launches"])),
                launches=dict(zip(KERNEL_NAMES, np.sum([s["launches"] for s in steps_rec],
                                                       0).tolist())))
    launches = {n: k.launches for n, k in zip(KERNEL_NAMES, kernels)}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the train path never launched: {launches}")
    return stages, launches, rec["loaders"]


# phase 9's heads steps: long enough to see whether the heads loss falls
HEADS_STEPS = 40


def train_path(dev, tmp):
    """``cli.train train`` at full width (ResNet-101-FPN, DeepLabV2-MSC at
    513², 1024², the CLI's bfloat16 compute, batch 2) on 16 synthetic images
    whose ground truth sits on the biased RPN's first proposals, from the
    weights of :func:`train_start_weights`: ``--stage heads`` for
    ``HEADS_STEPS`` steps, then ``--stage all`` for 7 (the backward through
    all of ResNet-101); then ``evaluate`` loads the saved checkpoint on 8 of
    the images and must detect. In each stage the first step is warm-up,
    the last three run under one ``torch.profiler`` window for the busy
    share and the rest are timed."""
    from sln_amodal_tpu_torch.cli import train as cli
    from sln_amodal_tpu_torch.train import checkpoint as ckpt
    from sln_amodal_tpu_torch.utils.synthetic import biased_pair, make_synthetic_dataset

    root, logs = os.path.join(tmp, "train"), os.path.join(tmp, "train_logs")
    t0 = time.perf_counter()
    cfg = cli.train_config(cli.build_parser().parse_args(
        ["train", "--dataset", root, "--batch_size", "2"]))
    pair = biased_pair(cfg)
    make_synthetic_dataset(root, n_images=16, size=cfg.image_size, seed=4, regions=pair)
    make_synthetic_dataset(root, n_images=8, size=cfg.image_size, subset="val", seed=4,
                           regions=pair, alternate_stuff=True)      # the first 8 images
    model = ckpt.save(train_start_weights(cfg, dev), os.path.join(tmp, "rpn_biased"),
                      "rpn_biased", 1)
    setup_s = time.perf_counter() - t0

    common = ["--dataset", root, "--batch_size", "2", "--logs", logs, "--seed", "0",
              "--device", str(dev)]
    stages, launches, _ = run_train_stages(
        dev, (("heads", "heads", HEADS_STEPS, ["--model", model]),
              ("all", "all", 7, ["--model", "last"])), common)
    for name, stats in stages.items():
        emit({"phase": "train", "stage": name,
              "total_loss_every_8_steps": stats["total_loss_by_step"][::8], **stats})

    # evaluate loads the last checkpoint on 8 of the training images
    ev = cli.main(["evaluate", "--dataset", root, "--model", "last", "--logs", logs,
                   "--eval_batch", "8", "--device", str(dev), "--data_type", "COCOA"])
    if not ev.results:
        raise AssertionError("evaluate of the trained checkpoint gave no detection")
    out = dict(setup_s=setup_s, stages=stages, launches=launches, root=root, model=model,
               config=cfg, evaluate_detections=len(ev.results),
               evaluate_both_all_ap=None if ev.stats is None else float(ev.stats["both/all"][0]))
    emit({"phase": "train_evaluate", "detections": len(ev.results),
          "both_all_ap": out["evaluate_both_all_ap"]})
    return out


def device_prep_check(dev, tr):
    """Phase 10: ``prepare_batch`` on 2 samples of the train phase's set,
    augment on, fixed draws: the card against the CPU (bit for bit but
    boxes and deltas, within 1e-6), the RLE upload against the dense one
    on the card (equal), and three batches of a ``DevicePrepLoader`` on the
    card against the CPU's prep of the same encoded batches and draws.
    Launches none of the three kernels."""
    from sln_amodal_tpu_torch.cli import train as cli
    from sln_amodal_tpu_torch.data import device_prep as dp
    from sln_amodal_tpu_torch.data.pipeline import make_training_sample
    from sln_amodal_tpu_torch.ops.anchors import config_anchors

    cfg = tr["config"]
    dataset = cli.load_train_dataset(cli.build_parser().parse_args(
        ["train", "--dataset", tr["root"]]), "train")
    t = time.perf_counter()
    for i in (0, 1):
        dp.encode_sample(dataset, cfg, i, dense_planes=False)      # the loader's setting
    encode_ms = (time.perf_counter() - t) * 1e3 / 2
    samples = [dp.encode_sample(dataset, cfg, i) for i in (0, 1)]
    encoded = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    anchors = torch.from_numpy(config_anchors(cfg)).float()
    draws = dp.draw(torch.Generator().manual_seed(0), 2, anchors.shape[0])

    kernels = train_kernels()
    before = [k.launches for k in kernels]

    def prep(device, rle):
        batch = dp.upload(encoded, rle, device)
        return dp.prepare_batch(batch, anchors.to(device), draws.to(device), config=cfg,
                                augment=True)

    card = {rle: {k: v.cpu() for k, v in prep(dev, rle).items()} for rle in (True, False)}
    cpu = prep("cpu", True)
    if [k.launches for k in kernels] != before:
        raise AssertionError("the prep launched a kernel of the train step")
    if not all(torch.equal(card[True][k], card[False][k]) for k in cpu):
        raise AssertionError("the RLE and the dense upload gave other batches")
    for k in ("images", "gt_masks", "gt_class_ids", "rpn_match"):
        if not torch.equal(card[True][k], cpu[k]):
            raise AssertionError(f"device_prep {k}: the card differs from the CPU")
    err = {k: float((card[True][k] - cpu[k]).abs().max()) for k in ("gt_boxes", "rpn_deltas")}
    if not ((cpu["rpn_match"] == 1).any(1).all() and cpu["gt_masks"].flatten(1).any(1).all()):
        raise AssertionError("device_prep: a sample has no positive anchor or no mask")

    # the loader on the card (pinned upload, side stream, the consumer's
    # wait): each batch equals the CPU's prep of its encoded batch and draws
    loader = dp.DevicePrepLoader(dataset, cfg, seed=0, workers=1, device=dev)
    seen, drawn = [], []
    prepare, draw_batch = loader._prepare, loader._draws
    loader._prepare = lambda enc: seen.append(enc) or prepare(enc)
    loader._draws = lambda b: drawn.append(draw_batch(b)) or drawn[-1]
    it = iter(loader)
    for i in range(3):
        got = next(it)
        ref = dp.prepare_batch(dp.upload(seen[i], True, "cpu"), anchors, drawn[i].to("cpu"),
                               config=cfg, augment=True)
        if not all(torch.equal(got[k].cpu(), ref[k]) for k in
                   ("images", "gt_masks", "gt_class_ids", "rpn_match")):
            raise AssertionError(f"DevicePrepLoader batch {i} differs from the CPU's prep")
        err = {k: max(err[k], float((got[k].cpu() - ref[k]).abs().max())) for k in err}
    it.close()
    if max(err.values()) > 1e-6:
        raise AssertionError(f"device_prep boxes / deltas beyond 1e-6 of the CPU's: {err}")

    uploaded = {rle: dp.upload(encoded, rle, dev) for rle in (True, False)}
    anchors_dev, draws_dev = anchors.to(dev), draws.to(dev)
    out = dict(
        batch=2, image=cfg.image_size, augment=True, max_abs_err=err,
        bit_equal=["images", "gt_masks", "gt_class_ids", "rpn_match"],
        rle_equals_dense=True, loader_batches_equal_cpu=3, encode_ms_per_sample=encode_ms,
        upload_bytes_per_batch=dict(
            {route: sum(a.nbytes for a in dp.upload_arrays(encoded, rle).values())
             for route, rle in (("rle", True), ("dense", False))},
            host_loader=sum(v.nbytes for i in (0, 1) for v in make_training_sample(
                dataset, cfg, i, config_anchors(cfg), rng=np.random.default_rng(i)).values())),
        upload_ms_per_batch={route: cuda_ms(lambda: dp.upload(encoded, rle, dev), 10)
                             for route, rle in (("rle", True), ("dense", False))},
        prep_ms_per_batch={route: cuda_ms(lambda: dp.prepare_batch(
            uploaded[rle], anchors_dev, draws_dev, config=cfg, augment=True), 10)
            for route, rle in (("rle", True), ("dense", False))},
        n_runs_per_sample=[int(n) for n in encoded["n_runs"]],
        rle_budget=dp.rle_budget_for(cfg.image_size),
        positives_per_sample=[int(n) for n in (cpu["rpn_match"] == 1).sum(1)])
    emit({"phase": "device_prep", **out})
    return out


def train_device_prep(dev, tmp, tr, prep):
    """Phase 11: phase 9's heads stage with ``--device_prep`` (the same
    weights, data, steps and timings, the targets built on the card), in
    turns with the host loader: host, device prep, device prep, host, twice.
    Emits each run and both loaders' numbers over their four runs (step
    medians over the timed steps, means of the rest)."""
    common = ["--dataset", tr["root"], "--batch_size", "2", "--seed", "0", "--device", str(dev),
              "--logs", os.path.join(tmp, "train_device_prep_logs"), "--model", tr["model"]]
    order = ("host", "device_prep", "device_prep", "host") * 2
    runs = [(f"{kind}_{i}", "heads", 7, ["--device_prep"] if kind == "device_prep" else [])
            for i, kind in enumerate(order)]
    stages, _, loaders = run_train_stages(dev, runs, common)
    for (label, *_), loader in zip(runs, loaders):
        emit({"phase": "train_device_prep", "run": label, "stage": "heads",
              "route_counts": getattr(loader, "route_counts", None), **stages[label]})

    def summary(kind):
        runs_of = [v for k, v in stages.items() if k.startswith(kind)]
        walls = [w for r in runs_of for w in r["step_wall_ms"][1:4]]
        prefetch = [r["prefetch_ms_per_batch"] for r in runs_of
                    if r["prefetch_ms_per_batch"] is not None]
        return dict(
            runs=len(runs_of), step_wall_ms_median=statistics.median(walls),
            images_per_s=2 * 1e3 / statistics.median(walls),
            loader_wait_ms_per_step=statistics.mean(r["loader_wait_ms_per_step"]
                                                    for r in runs_of),
            loader_wait_ms_after_first_step=statistics.mean(
                w for r in runs_of for w in r["loader_wait_ms"][1:]),
            busy_share_profiled_steps=statistics.mean(r["busy_share_profiled_steps"]
                                                      for r in runs_of),
            worker_ms_per_sample=statistics.mean(r["worker_ms_per_sample"] for r in runs_of),
            prefetch_ms_per_batch=statistics.mean(prefetch) if prefetch else None,
            peak_mem_bytes=max(r["peak_mem_bytes"] for r in runs_of),
            launches={k: sum(r["launches"][k] for r in runs_of) for k in KERNEL_NAMES})
    out = dict(order=list(order), device_prep=summary("device_prep"),
               host_loader=summary("host"), upload_bytes_per_batch=prep["upload_bytes_per_batch"])
    out["launches"] = out["device_prep"]["launches"]
    emit({"phase": "train_device_prep_summary", **out})
    return out


class OneBatch:
    """A loader that yields ``batches`` in turn, forever."""

    def __init__(self, *batches):
        self.batches = batches

    def __iter__(self):
        while True:
            yield from self.batches


@contextlib.contextmanager
def timed_all_reduce():
    """Records the bytes and the CUDA-event device ms of every
    ``multihost.all_reduce_mean_`` call (the gradients' bucket, the logged
    losses)."""
    from sln_amodal_tpu_torch.parallel import multihost

    calls = []
    reduce = multihost.all_reduce_mean_

    def timed(tensors):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        nbytes = reduce(tensors)
        end.record()
        end.synchronize()
        calls.append((nbytes, start.elapsed_time(end)))
        return nbytes

    multihost.all_reduce_mean_ = timed
    try:
        yield calls
    finally:
        multihost.all_reduce_mean_ = reduce


@contextlib.contextmanager
def clipped_norms():
    """Records the global norm that every ``StagedSGD.step`` clips (None for
    a micro-step that does not update)."""
    from sln_amodal_tpu_torch.train.optim import StagedSGD

    norms, step = [], StagedSGD.step

    def recorded(self):
        norm = step(self)
        norms.append(norm)
        return norm

    StagedSGD.step = recorded
    try:
        yield norms
    finally:
        StagedSGD.step = step


def gradient_bucket(calls) -> dict:
    """The gradients' all-reduce among ``calls`` (the largest bucket)."""
    nbytes, ms = max(calls)
    return {"bytes": nbytes, "ms": ms}


def trainable(model) -> dict:
    """A host copy of ``model``'s trained parameters."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.named_parameters()
            if v.requires_grad}


def rpn_grad_to_fpn(cfg, sd, batch, uniforms, dev) -> float:
    """The global norm of the RPN losses' gradient on the ``fpn.``
    parameters (ResNet-101 and the FPN), one forward from ``sd``."""
    from sln_amodal_tpu_torch.models.sln import SLNAmodal
    from sln_amodal_tpu_torch.train.trainer import loss_on

    model = SLNAmodal(cfg, device=dev)
    model.load_state_dict(sd)
    params = [p for n, p in model.named_parameters() if n.startswith("fpn.")]
    for p in params:
        p.requires_grad_(True)
    losses = loss_on(model, batch, uniforms=uniforms)
    grads = torch.autograd.grad(losses["rpn_class"] + losses["rpn_bbox"], params,
                                allow_unused=True)
    return float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads if g is not None])))


def dp_trainer_step(cfg, sd, dev, stage, loader, seed, steps=1, accumulate_steps=1,
                    on_epoch_end=None):
    """``Trainer.train_stage`` from ``sd``: ``steps`` epochs of one step on
    ``loader``; returns (trainer, last losses, the kernels' launches per
    step, wall ms per step ending in a synchronize)."""
    from sln_amodal_tpu_torch.train.trainer import Trainer

    kernels = train_kernels()
    trainer = Trainer(cfg, sd, device=dev)
    launches, walls = [], []
    before = [[k.launches for k in kernels]]
    t = [time.perf_counter()]

    def end(epoch):
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t[0]) * 1e3)
        launches.append([k.launches - b for k, b in zip(kernels, before[0])])
        if on_epoch_end is not None:
            on_epoch_end(epoch, trainer)
        before[0] = [k.launches for k in kernels]
        t[0] = time.perf_counter()

    losses = trainer.train_stage(loader, stage, cfg.learning_rate, epochs=steps,
                                 steps_per_epoch=1, seed=seed, on_epoch_end=end,
                                 accumulate_steps=accumulate_steps)
    if any(n != [1, 2, 2] for n in launches):
        raise AssertionError(f"data_parallel {stage}: launches per step {launches}")
    return trainer, losses, launches, walls


def data_parallel_worker(rank: int, port: str, path: str) -> int:
    """Phase 12 (b) and (e), one of two processes on the one card. (b): a
    gloo group of 2, one ``all`` step on row ``rank`` of the saved batch
    with the global draws; writes its losses and trained parameters. (e):
    ``cli.train train --coordinator --num_processes 2 --process_id rank
    --device_prep``, two heads steps of one image, with the backend the CLI
    picks for a card (NCCL) forced to gloo, as NCCL refuses two processes
    on one card; writes its checkpoints, step, trained parameters and its
    loader's slice of the dataset."""
    from sln_amodal_tpu_torch.cli import train as cli
    from sln_amodal_tpu_torch.parallel import multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = torch.load(os.path.join(path, "in.pt"), weights_only=False)
    dev = torch.device(data["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    multihost.init_group(f"localhost:{port}", 2, rank, "gloo")
    try:
        row = {k: v[rank:rank + 1] for k, v in data["batch"].items()}
        with deterministic(), timed_all_reduce() as calls, clipped_norms() as norms:
            trainer, losses, launches, walls = dp_trainer_step(
                data["config"], data["state_dict"], dev, "all", OneBatch(row), data["seed"])
        torch.save({"losses": losses, "params": trainable(trainer.model),
                    "norm": float(norms[0])}, os.path.join(path, f"out{rank}.pt"))
        emit({"phase": "data_parallel_rank", "part": "b", "rank": rank, "world": 2,
              "backend": "gloo", "launches_per_step": dict(zip(KERNEL_NAMES, launches[0])),
              "step_wall_ms": walls[0], "all_reduce": gradient_bucket(calls),
              "all_reduce_calls": len(calls), "clipped_norm": float(norms[0])})
    finally:
        multihost.shutdown()
    del trainer
    torch.cuda.empty_cache()

    kernels, loaders = train_kernels(), []
    loader_cls, backend = cli.DevicePrepLoader, multihost.default_backend

    class Recorded(loader_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            loaders.append(self)

    cli.DevicePrepLoader, multihost.default_backend = Recorded, lambda device: "gloo"
    before = [k.launches for k in kernels]
    t = time.perf_counter()
    try:
        out = cli.main(["train", "--dataset", data["root"], "--model", data["model"],
                        "--logs", os.path.join(path, "logs"), "--stage", "heads", "--epochs",
                        "1", "--steps_per_epoch", "2", "--batch_size", "1", "--device_prep",
                        "--seed", "0", "--device", str(dev), "--coordinator",
                        f"localhost:{data['cli_port']}", "--num_processes", "2",
                        "--process_id", str(rank)])
    finally:
        cli.DevicePrepLoader, multihost.default_backend = loader_cls, backend
    seconds = time.perf_counter() - t
    launches = [k.launches - b for k, b in zip(kernels, before)]
    if multihost.is_distributed() or launches != [2, 4, 4]:
        raise AssertionError(f"data_parallel (e) rank {rank}: launches {launches}, group left "
                             f"{multihost.is_distributed()}")
    ids = [int(i) for i in loaders[0].local_ids]
    if ids != multihost.partition_ids(loaders[0].dataset.image_ids, rank, 2).tolist():
        raise AssertionError(f"data_parallel (e) rank {rank}: the loader's slice {ids}")
    torch.save({"checkpoints": out.checkpoints, "step": out.trainer.step, "ids": ids,
                "params": trainable(out.trainer.model)}, os.path.join(path, f"cli{rank}.pt"))
    emit({"phase": "data_parallel_rank", "part": "e", "rank": rank, "world": 2,
          "backend": "gloo", "device": str(out.trainer.device), "seconds": seconds,
          "launches": dict(zip(KERNEL_NAMES, launches)), "image_ids": ids})
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


HEAD_LOSSES = ("mrcnn_class", "mrcnn_bbox", "layer", "amodal")


def batch_with_rois(cfg, sd, dataset, draws, dev, tries=8):
    """The first batch of 2 of the train phase's loader (seed 0) in which
    each row alone, with its row of ``draws``, samples ROIs and positives
    from ``sd``: every head loss of both rows above 0 (a row without them
    adds nothing to the heads' gradients). Returns (the batch, its index,
    the rows' head losses)."""
    from sln_amodal_tpu_torch.data.pipeline import TrainLoader
    from sln_amodal_tpu_torch.models.sln import SLNAmodal
    from sln_amodal_tpu_torch.train.trainer import loss_on, to_device

    model = SLNAmodal(cfg, device=dev)
    model.load_state_dict(sd)
    loader = iter(TrainLoader(dataset, cfg, seed=0, workers=1))
    seen = []
    for index in range(tries):
        batch = to_device(next(loader), dev)
        with torch.no_grad():
            rows = [loss_on(model, {k: v[r:r + 1] for k, v in batch.items()},
                            uniforms=(draws[0][r:r + 1], draws[1][r:r + 1])) for r in (0, 1)]
        seen.append([{k: float(row[k]) for k in HEAD_LOSSES} for row in rows])
        if all(v > 0 for row in seen[-1] for v in row.values()):
            return batch, index, seen[-1]
    raise AssertionError(f"data_parallel: no batch of {tries} samples ROIs in both rows: {seen}")


# phase 12's tolerance of (b) and (c) against (a), relative to (a)'s largest
# update element (losses: a tenth of it, relative)
DP_TOLERANCE = {"float32": 1e-4, "bfloat16": 16 * 2.0 ** -8}


def detections_agree(ref, got) -> dict:
    """How far two ``detect`` results of the same images agree: equal
    rois, class ids and masks per image, the largest score difference and
    the share of mask pixels that agree."""
    same = {k: [bool(np.array_equal(r[k], g[k])) for r, g in zip(ref, got)]
            for k in ("rois", "class_ids", "masks")}
    shapes_equal = all(r["masks"].shape == g["masks"].shape for r, g in zip(ref, got))
    return dict(equal=same, score_max_abs_diff=max(
        [float(np.abs(r["scores"] - g["scores"]).max()) for r, g in zip(ref, got)
         if r["scores"].shape == g["scores"].shape and len(r["scores"])] + [0.0]),
        mask_pixel_agreement=(min(float((r["masks"] == g["masks"]).mean())
                                  for r, g in zip(ref, got)) if shapes_equal else None))


def data_parallel(dev, tmp, tr, ev):
    """Phase 12: data parallelism and accumulation at full width (the train
    phase's config and data, one batch of 2 whose rows both sample ROIs,
    ``train_start_weights`` with an RPN that sends a gradient into the
    trunk), under deterministic algorithms:

    (a) ``Trainer`` in a one-process NCCL group equals the plain
        ``train_step`` on the same batch and draws bit for bit (all stage);
        the gradients' all-reduce bytes and ms for heads and all;
    (b) two processes on this card over gloo, one row each with the global
        draws: equal to each other bit for bit, and within 1e-4 of the
        update's largest element plus one float32 ulp of each parameter
        (losses 1e-5 relative) of (a)'s step;
    (c) ``accumulate_steps=2`` over the two rows: bit-unchanged after
        micro-step 1, within (b)'s tolerance of (a) after micro-step 2;
    (d) ``Detector(mesh=(dev, dev))`` on 3 of the eval phase's images
        equals ``Detector`` without a mesh, and ``evaluate --data_parallel``
        on 8 of them gives the run without the flag's results and sweeps;
    (e) in (b)'s two processes, ``cli.train train --num_processes 2
        --device_prep`` (two heads steps of one image each): process 0
        alone writes the checkpoint, both end with equal parameters, each
        loader streams its own half of the images.

    Also the norm of the RPN losses' gradient on ``fpn.`` under these
    weights, phase 9's, and phase 9's with the shared conv kept, and the
    global norm each step clips. Kernel launches are counted over (a) and
    (c) (``data_parallel``) and over (d)'s mesh ``detect`` and
    ``evaluate --data_parallel`` (``data_parallel_serving``); (b) and (e)
    count theirs in their processes."""
    from sln_amodal_tpu_torch.cli import train as cli
    from sln_amodal_tpu_torch.models.sln import SLNAmodal
    from sln_amodal_tpu_torch.parallel import multihost
    from sln_amodal_tpu_torch.train import checkpoint as ckpt
    from sln_amodal_tpu_torch.train import trainer as trainer_mod
    from sln_amodal_tpu_torch.train.optim import StagedSGD
    from sln_amodal_tpu_torch.train.trainer import epoch_generator, step_uniforms, train_step

    cfg, seed = tr["config"], 0
    dataset = cli.load_train_dataset(cli.build_parser().parse_args(
        ["train", "--dataset", tr["root"]]), "train")
    draws = step_uniforms(epoch_generator(seed, 0), 2, cfg.post_nms_rois_training)
    sd = train_start_weights(cfg, dev, rpn_gradient=True)
    batch, batch_index, row_losses = batch_with_rois(cfg, sd, dataset, draws, dev)
    # the norm under phase 9's weights (shared conv zero) and with the shared
    # conv kept but the recipe's zero box conv, beside this phase's
    box_zero = dict(sd, **{"rpn.conv_bbox.weight": torch.zeros_like(sd["rpn.conv_bbox.weight"])})
    shared_zero = dict(box_zero, **{k: torch.zeros_like(sd[k]) for k in
                                    ("rpn.conv_shared.weight", "rpn.conv_shared.bias")})
    rpn_norm = {label: rpn_grad_to_fpn(cfg, weights, batch, draws, dev) for label, weights in
                (("phase_9_weights", shared_zero), ("shared_conv_kept", box_zero),
                 ("shared_conv_kept_box_conv_seeded", sd))}
    if not rpn_norm["shared_conv_kept_box_conv_seeded"] > 0:
        raise AssertionError(f"no RPN gradient reaches the trunk: {rpn_norm}")
    torch.cuda.empty_cache()

    kernels = train_kernels()
    out = {"rpn_grad_to_fpn_norm": rpn_norm, "batch_index": batch_index,
           "row_head_losses": row_losses, "clip_norm": cfg.gradient_clip_norm}
    with deterministic():
        # (a) the plain step, then the Trainer in a one-process NCCL group
        model = SLNAmodal(cfg, device=dev)
        model.load_state_dict(sd)
        opt = StagedSGD(model, "all", cfg.learning_rate, momentum=cfg.learning_momentum,
                        weight_decay=cfg.weight_decay, clip_norm=cfg.gradient_clip_norm)
        before = [k.launches for k in kernels]
        with clipped_norms() as norms:
            plain_losses = {k: float(v) for k, v in
                            train_step(model, opt, batch, uniforms=draws).items()}
        plain, plain_norm = trainable(model), float(norms[0])
        # a second step, warm, for its wall time
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_step(model, opt, batch, uniforms=draws)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        if [k.launches - b for k, b in zip(kernels, before)] != [2, 4, 4]:
            raise AssertionError("data_parallel: the plain steps' launches")
        del model, opt
        torch.cuda.empty_cache()
        start = {k: sd[k] for k in plain}
        update = max(float((plain[k] - start[k]).abs().max()) for k in plain)

        # the data-parallel path's launches: (a)'s Trainer and (c)
        for k in kernels:
            k.launches = 0
        multihost.init_group(f"localhost:{free_port()}", 1, 0, "nccl")
        try:
            reduce = {}
            for stage in ("all", "heads"):
                with timed_all_reduce() as calls, clipped_norms() as norms:
                    trainer, losses, _, walls = dp_trainer_step(cfg, sd, dev, stage,
                                                                OneBatch(batch), seed)
                reduce[stage] = dict(gradient_bucket(calls), tensors=len(trainer.optimizer.params),
                                     step_wall_ms=walls[0], clipped_norm=float(norms[0]))
                if stage == "all":
                    nccl = trainable(trainer.model)
                    if losses != plain_losses or not all(torch.equal(nccl[k], plain[k])
                                                         for k in plain):
                        raise AssertionError("data_parallel (a): the NCCL world-1 step "
                                             "differs from the plain step")
                del trainer
                torch.cuda.empty_cache()
        finally:
            multihost.shutdown()
        out["a"] = dict(world=1, backend="nccl", bit_equal=True, plain_step_wall_ms=plain_ms,
                        losses=plain_losses, clipped_norm=plain_norm,
                        clip_binds=plain_norm > cfg.gradient_clip_norm, update_max_abs=update,
                        all_reduce=reduce)
        emit({"phase": "data_parallel", "part": "a", **out["a"]})

        # (c) micro-batches of one row with the rows' draws of (a), two per
        # update: checked after micro-steps 1 and 2, timed warm on 3 and 4
        halves = [{k: v[i:i + 1] for k, v in batch.items()} for i in (0, 1)]
        rows = OneBatch(*[(draws[0][i:i + 1], draws[1][i:i + 1]) for i in (0, 1)])
        seen, step_losses = {}, []

        def check(epoch, trainer):
            if epoch == 1:
                seen.update(equal=all(torch.equal(v.detach().cpu(), sd[k])
                                      for k, v in trainer.model.named_parameters()),
                            accumulated=len(trainer.optimizer.accumulated))
            if epoch == 2:
                seen["params"] = trainable(trainer.model)

        def recorded_step(*args, **kwargs):
            losses = train_step(*args, **kwargs)
            step_losses.append({k: float(v) for k, v in losses.items()})
            return losses

        row_draws = iter(rows)
        trainer_mod.step_uniforms = lambda generator, b, rois: next(row_draws)
        trainer_mod.train_step = recorded_step
        try:
            with clipped_norms() as norms:
                trainer, _, _, walls = dp_trainer_step(
                    cfg, sd, dev, "all", OneBatch(*halves), seed, steps=4, accumulate_steps=2,
                    on_epoch_end=check)
        finally:
            trainer_mod.step_uniforms, trainer_mod.train_step = step_uniforms, train_step
        del trainer
        torch.cuda.empty_cache()
    launches = {n: k.launches for n, k in zip(KERNEL_NAMES, kernels)}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the data-parallel path never launched: {launches}")

    rel = DP_TOLERANCE[cfg.compute_dtype]

    def norm_of_mean(norm, label):
        """The norm clipped must be (a)'s within ``rel`` relative: a sum of
        the rows' gradients in place of their mean would double it, and
        the clip, which binds here, would hide that from the parameters."""
        if not abs(norm - plain_norm) <= rel * plain_norm:
            raise AssertionError(f"data_parallel {label}: clipped norm {norm}, (a)'s {plain_norm}")

    def held(params, label):
        """Max |diff| from (a)'s parameters, and the check: within ``rel``
        of (a)'s largest update element plus one float32 ulp of the
        parameter (p + u rounds to a float32: one update off by 1e-12 can
        land one ulp away, and at lr 1e-3 the ulp of a parameter near 1 is
        above 1e-4 of the update)."""
        err, beyond = 0.0, 0
        for k in plain:
            diff = (params[k] - plain[k]).abs()
            mag = plain[k].abs()
            ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
            beyond += int((diff > rel * update + ulp).sum())
            err = max(err, float(diff.max()))
        if beyond:
            raise AssertionError(f"data_parallel {label}: {beyond} parameters beyond {rel} of "
                                 f"(a)'s update {update} plus one ulp (max |diff| {err}, "
                                 f"{err / update} of the update)")
        return err

    if not seen["equal"] or seen["accumulated"] != len(plain):
        raise AssertionError(f"data_parallel (c): after micro-step 1 {seen}")
    if not all(step[k] > 0 for step in step_losses[:2] for k in HEAD_LOSSES):
        raise AssertionError(f"data_parallel (c): a row sampled no ROI: {step_losses[:2]}")
    clipped = [None if n is None else float(n) for n in norms]
    norm_of_mean(clipped[1], "(c)")
    acc_err = held(seen["params"], "(c)")
    out["c"] = dict(accumulate_steps=2, unchanged_after_micro_step_1=True,
                    accumulator_tensors=seen["accumulated"], param_max_abs_err=acc_err,
                    param_err_of_update=acc_err / update, micro_step_wall_ms=walls,
                    accumulated_step_wall_ms=sum(walls[2:]), plain_step_wall_ms=plain_ms,
                    clipped_norms=clipped,
                    micro_step_losses=step_losses)
    emit({"phase": "data_parallel", "part": "c", **out["c"]})

    # (b) and (e): two gloo processes on this card
    path = os.path.join(tmp, "data_parallel")
    os.makedirs(path, exist_ok=True)
    model_path = ckpt.save(sd, os.path.join(path, "start"), "dp_start", 1)
    torch.save({"config": cfg, "seed": seed, "state_dict": sd, "device": str(dev),
                "batch": {k: v.cpu() for k, v in batch.items()}, "root": tr["root"],
                "model": model_path, "cli_port": free_port()}, os.path.join(path, "in.pt"))
    torch.cuda.empty_cache()
    port = str(free_port())
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "data_parallel_worker",
                               str(rank), port, path], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"data_parallel (b): process {rank} failed:\n{log[-4000:]}")
        print("\n".join(ln for ln in log.splitlines() if '"data_parallel_rank"' in ln))
    seconds = time.perf_counter() - t
    ranks = [torch.load(os.path.join(path, f"out{r}.pt"), weights_only=False) for r in (0, 1)]
    if ranks[0]["losses"] != ranks[1]["losses"] or not all(
            torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in plain):
        raise AssertionError("data_parallel (b): the two processes' steps differ")
    loss_err = max(abs(ranks[0]["losses"][k] - plain_losses[k]) / abs(plain_losses[k])
                   for k in plain_losses if plain_losses[k] != 0)
    if loss_err > rel / 10:
        raise AssertionError(f"data_parallel (b): losses {loss_err} relative from (a)'s")
    gloo_err = held(ranks[0]["params"], "(b)")
    norm_of_mean(ranks[0]["norm"], "(b)")
    out["b"] = dict(world=2, backend="gloo", ranks_bit_equal=True, param_max_abs_err=gloo_err,
                    param_err_of_update=gloo_err / update, loss_max_rel_err=loss_err,
                    clipped_norm=ranks[0]["norm"], seconds=seconds)
    emit({"phase": "data_parallel", "part": "b", **out["b"]})

    runs = [torch.load(os.path.join(path, f"cli{r}.pt"), weights_only=False) for r in (0, 1)]
    written = runs[0]["checkpoints"]
    if (len(written) != 1 or runs[1]["checkpoints"] != written
            or not all(os.path.exists(w + suffix) for w in written for suffix in ("", ".state"))
            or sum("checkpoint:" in log for log in logs) != 1
            or runs[0]["step"] != 2 or runs[1]["step"] != 2):
        raise AssertionError(f"data_parallel (e): checkpoints {written}, "
                             f"{runs[1]['checkpoints']}, steps {runs[0]['step']}, {runs[1]['step']}")
    if not all(torch.equal(v, runs[1]["params"][k]) for k, v in runs[0]["params"].items()):
        raise AssertionError("data_parallel (e): the two processes' parameters differ")
    ids = runs[0]["ids"] + runs[1]["ids"]
    if sorted(ids) != sorted(int(i) for i in dataset.image_ids):
        raise AssertionError(f"data_parallel (e): the processes' slices {ids}")
    out["e"] = dict(world=2, backend="gloo", command="cli.train train --num_processes 2 "
                    "--device_prep --stage heads --steps_per_epoch 2 --batch_size 1",
                    checkpoint_writers=1, params_bit_equal=True,
                    images_per_process=[len(r["ids"]) for r in runs])
    emit({"phase": "data_parallel", "part": "e", **out["e"]})

    # (d) serving over a mesh of two replicas on this card
    from sln_amodal_tpu_torch.infer import Detector

    args = evaluate_args(ev["root"], ev["model"], 8, dev)
    eval_ds, _, ids = cli.load_eval_dataset(args)
    single = cli.make_detector(args, cli.eval_config(args))
    images = [eval_ds.load_image(i) for i in ids[:3]]
    ref = single.detect(images)
    evaluate = ["evaluate", "--dataset", ev["root"], "--model", ev["model"], "--limit", "8",
                "--eval_batch", "8", "--device", str(dev)]
    runs = [cli.main(evaluate)]
    # the serving path's launches: the mesh detect and evaluate --data_parallel
    for k in kernels:
        k.launches = 0
    mesh = Detector(single.config, single.model.state_dict(), mesh=(dev, dev))
    got = mesh.detect(images)
    del single, mesh
    runs.append(cli.main(evaluate + ["--data_parallel"]))
    serving = {n: k.launches for n, k in zip(KERNEL_NAMES, kernels)}
    if min(serving["nms"], serving["roi_align"]) == 0 or serving["roi_align_backward"]:
        raise AssertionError(f"data_parallel (d): the serving path's launches {serving}")
    score_err, agree = 0.0, detections_agree(ref, got)
    emit({"phase": "data_parallel", "part": "d_agreement", **agree})
    for r, g in zip(ref, got):
        if not all(np.array_equal(r[k], g[k]) for k in ("rois", "class_ids", "masks")):
            raise AssertionError(f"data_parallel (d): the mesh Detector's detections differ: "
                                 f"{agree}")
        score_err = max([score_err] + list(np.abs(r["scores"] - g["scores"])))
    if len(got) != 3 or score_err > 1e-5 or not min(len(r["scores"]) for r in ref):
        raise AssertionError(f"data_parallel (d): {len(got)} results, scores {score_err}")
    if runs[0].results != runs[1].results or not all(
            np.array_equal(runs[0].stats[k], runs[1].stats[k]) for k in runs[0].stats):
        raise AssertionError("data_parallel (d): evaluate --data_parallel differs: "
                             f"{sum(a != b for a, b in zip(runs[0].results, runs[1].results))} "
                             f"of {len(runs[0].results)} results")
    out["d"] = dict(mesh=2, images=3, score_max_abs_err=float(score_err),
                    detections=[len(r["scores"]) for r in got],
                    evaluate_results=len(runs[1].results), evaluate_sweeps_equal=True)
    emit({"phase": "data_parallel", "part": "d", **out["d"]})
    out["launches"], out["serving_launches"] = launches, serving
    emit({"phase": "data_parallel", "launches": launches, "serving_launches": serving,
          "rpn_grad_to_fpn_norm": rpn_norm, "batch_index": batch_index,
          "row_head_losses": row_losses})
    return out


def detect_times(detector, images, repeats=5) -> dict:
    """Medians over ``repeats`` calls, after one warm-up call: CUDA-event
    ms of ``dispatch`` on the device (its span from the first launch to the
    last kernel's end), wall ms of ``detect`` (dispatch, then ``collect``'s
    fetch and host unmold), and the host ms of each of the two."""
    detector.detect(images)
    torch.cuda.synchronize()
    rec = {"device_ms": [], "wall_ms": [], "dispatch_host_ms": [], "collect_host_ms": []}
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        pending = detector.dispatch(images)
        end.record()
        t_collect = time.perf_counter()
        detector.collect(pending)
        done = time.perf_counter()
        end.synchronize()
        for key, value in (("device_ms", start.elapsed_time(end)),
                           ("wall_ms", (done - t) * 1e3),
                           ("dispatch_host_ms", (t_collect - t) * 1e3),
                           ("collect_host_ms", (done - t_collect) * 1e3)):
            rec[key].append(value)
    return {k: statistics.median(v) for k, v in rec.items()}


def same_results(got, want) -> bool:
    """``detect`` results equal bit for bit: rois, class ids, scores, masks."""
    return len(got) == len(want) and all(
        np.array_equal(g[k], w[k]) for g, w in zip(got, want)
        for k in ("rois", "class_ids", "scores", "masks"))


def serving_worker(artifact: str, io_dir: str) -> int:
    """Phase 13 (b)-(d), in a process of its own that never imports the
    model code: ``ServingDetector.load`` of the full-width artifact, its
    ``detect`` against phase 4's ``Detector.detect`` (bit for bit), a
    one-image request (padded to 2) against the ``Detector``'s row of a
    batch of that image twice, a three-image request refused, the launches
    of one serving ``detect`` and its device and wall ms."""
    import pickle

    from sln_amodal_tpu_torch.serve import ServingDetector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(io_dir, "reference.pkl"), "rb") as f:
        ref = pickle.load(f)
    t = time.perf_counter()
    served = ServingDetector.load(artifact)
    load_s = time.perf_counter() - t
    images = ref["images"]
    served.detect(images)                   # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    kernels = train_kernels()
    for k in kernels:
        k.launches = 0
    got = served.detect(images)
    launches = {n: k.launches for n, k in zip(KERNEL_NAMES, kernels)}
    if launches != {"nms": 1, "roi_align": 2, "roi_align_backward": 0}:
        raise AssertionError(f"serving: launches per detect {launches}")
    if not same_results(got, ref["results"]):
        raise AssertionError("serving: the artifact's detect differs from Detector.detect")
    if not same_results(served.detect(images[:1]), ref["one"]):
        raise AssertionError("serving: a one-image request differs")
    try:
        served.detect(images + images[:1])
    except ValueError as e:
        if "artifact batch" not in str(e):
            raise
    else:
        raise AssertionError("serving: a three-image request was not refused")
    times = detect_times(served, images)
    leaked = sorted(n for n in sys.modules if n.startswith("sln_amodal_tpu_torch.models"))
    if leaked:
        raise AssertionError(f"serving: the loading process imported {leaked}")
    out = dict(load_s=load_s, launches=launches, results_bit_equal=True,
               one_image_bit_equal=True, three_images_refused=True, **times,
               models_imported=False,
               detections=[len(r["scores"]) for r in got])
    with open(os.path.join(io_dir, "worker.json"), "w") as f:
        json.dump(out, f)
    emit({"phase": "serving_worker", **out})
    return 0


def dispatcher_hop_us(dev):
    """Host µs per call through each custom op and straight to its launch
    function (no dispatcher), in turns, at the evaluate path's shapes
    (batch 8: NMS 6000 -> 1000, RoIAlign pool 7 over 1000 boxes) and the
    train step's (batch 2: the backward at pool 7 over 100 boxes)."""
    from sln_amodal_tpu_torch.ops.nms_cuda import launch_nms, nms_sorted_batched
    from sln_amodal_tpu_torch.ops.roi_align_cuda import (launch_roi_align,
                                                         launch_roi_align_backward,
                                                         pyramid_roi_align,
                                                         pyramid_roi_align_backward)

    rng = np.random.RandomState(0)
    boxes = torch.from_numpy(np.stack([cluster_boxes(rng, 6000) for _ in range(8)])).to(dev)
    valid = torch.ones((8, 6000), dtype=torch.bool, device=dev)
    feats = [torch.randn((8, s, s, 256), device=dev) for s in (256, 128, 64, 32)]
    rois = roi_boxes(rng, 8, 1000).to(dev)
    grad = torch.randn((2, 100, 7, 7, 256), device=dev)
    rois2 = clustered_boxes(rng, 2, 100).to(dev)
    shapes = [(s, s, 256) for s in (256, 128, 64, 32)]
    sizes = [s for s, _, _ in shapes]
    calls = {
        "nms": (lambda: nms_sorted_batched(boxes, valid, 1000, 0.7),
                lambda: launch_nms(boxes, valid, 1000, 0.7, False, -1)),
        "roi_align": (lambda: pyramid_roi_align(feats, rois, (7, 7), (1024, 1024)),
                      lambda: launch_roi_align(feats, rois, [7, 7], [1024, 1024], 0.0)),
        "roi_align_backward": (
            lambda: pyramid_roi_align_backward(grad, rois2, shapes, (7, 7), (1024, 1024),
                                               torch.float32),
            lambda: launch_roi_align_backward(grad, rois2, sizes, sizes, [7, 7],
                                              [1024, 1024], torch.float32)),
    }
    out = {}
    for name, (op, direct) in calls.items():
        runs = {"op": [], "direct": []}
        for _ in range(2):
            for key, fn in (("op", op), ("direct", direct), ("direct", direct), ("op", op)):
                runs[key].append(host_us(fn, 30))
        out[name] = {k: statistics.median(v) for k, v in runs.items()}
        out[name]["hop_us"] = out[name]["op"] - out[name]["direct"]
    del feats, boxes, grad
    torch.cuda.empty_cache()
    return out


def trace_kernel_names(trace_dir) -> list:
    """The device kernels' names in the ``torch.profiler`` trace(s) under
    ``trace_dir``."""
    names = set()
    for root, _, files in os.walk(trace_dir):
        for name in files:
            if name.endswith(".json"):
                with open(os.path.join(root, name)) as f:
                    events = json.load(f).get("traceEvents", [])
                names.update(e.get("name", "") for e in events if e.get("cat") == "kernel")
    return sorted(names)


def serving(dev, tmp, path, ev, kernel_checks):
    """Phase 13: the serving artifact at full width and its tooling.

    (a) ``export_detector`` of phase 4's detector at batch 2, detect-only:
    seconds, bytes of ``model.pt2``, peak device memory; (b)-(d) loaded and
    run in ``python3 chip_smoke.py serving_worker DIR IO`` (a process that
    never imports the model code): bit-equal to phase 4's ``Detector.detect``,
    padding, refusal, NMS 1 / RoIAlign 2 / backward 0 launches per detect,
    device and wall ms beside ``Detector.detect``'s; (e) at 128²:
    ``cli.export_model --full`` (its ``last_global_label`` and detections
    against ``Detector(detect_only=False)``'s) and a mesh artifact over
    (card, card); (f) ``cli.train evaluate --trace_dir`` over 8 of
    phase 6's images: the trace names the kernels, the results equal a run
    without it; (g) the ops' host µs and wrapper ms from phase 3 beside PR
    7's, and each op's host µs against its launch function called
    directly."""
    import pickle
    import shutil

    from sln_amodal_tpu_torch.cli import export_model
    from sln_amodal_tpu_torch.cli import train as cli
    from sln_amodal_tpu_torch.config import Config, inference_config
    from sln_amodal_tpu_torch.convert import init_params
    from sln_amodal_tpu_torch.infer import Detector
    from sln_amodal_tpu_torch.profile_infer import make_detector
    from sln_amodal_tpu_torch.serve import ServingDetector, export_detector

    t_phase = time.perf_counter()
    det, images = path["detector"], path["images"]
    out = {}

    # (a) export at full width
    art = os.path.join(tmp, "serving")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    export_detector(det.config, det.model.state_dict(), art, batch=2, detect_only=True,
                    device=dev)
    out["a"] = dict(batch=2, image=det.config.image_size, export_s=time.perf_counter() - t,
                    model_pt2_bytes=os.path.getsize(os.path.join(art, "model.pt2")),
                    peak_mem_bytes=int(torch.cuda.max_memory_allocated(dev)),
                    peak_over_resident_bytes=int(torch.cuda.max_memory_allocated(dev) - before))
    emit({"phase": "serving", "part": "a", **out["a"]})

    # (b)-(d) in a process of its own, against phase 4's Detector
    io_dir = os.path.join(tmp, "serving_io")
    os.makedirs(io_dir, exist_ok=True)
    with open(os.path.join(io_dir, "reference.pkl"), "wb") as f:
        pickle.dump({"images": images, "results": path["results"],
                     "one": det.detect([images[0], images[0]])[:1]}, f)
    detector_ms = detect_times(det, images)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "serving_worker", art,
                           io_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serving: the worker failed:\n{proc.stdout[-4000:]}")
    print("\n".join(ln for ln in proc.stdout.splitlines() if '"serving_worker"' in ln))
    with open(os.path.join(io_dir, "worker.json")) as f:
        worker = json.load(f)
    out["b"] = dict(worker, worker_s=time.perf_counter() - t,
                    **{f"detector_{k}": v for k, v in detector_ms.items()})
    emit({"phase": "serving", "part": "b", **out["b"]})
    shutil.rmtree(art)
    shutil.rmtree(io_dir)

    # (e) 128² on the card: the CLI's full-contract artifact, a mesh artifact
    t = time.perf_counter()
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, (128, 128, 3), np.uint8) for _ in range(3)]
    cli_dir = os.path.join(tmp, "serving_cli")
    export_model.main(["--model", "random", "--image_size", "128", "--batch", "1", "--full",
                       "--out", cli_dir, "--device", str(dev)])
    served = ServingDetector.load(cli_dir)
    full_cfg = inference_config(image_size=128)    # the CLI's dtypes: bfloat16 compute
    direct = Detector(full_cfg, init_params(full_cfg, seed=0, device=dev), detect_only=False,
                      device=dev)
    got, want = served.detect(imgs[:1]), direct.detect(imgs[:1])
    if ((served.batch, served.config, served.detect_only) != (1, full_cfg, False)
            or served.last_global_label is None
            or not np.array_equal(served.last_global_label, direct.last_global_label)
            or not same_results(got, want)):
        raise AssertionError("serving (e): the CLI's full-contract artifact differs from "
                             "Detector(detect_only=False)'s")
    label_shape = list(direct.last_global_label.shape)
    shutil.rmtree(cli_dir)
    del served, direct
    # the mesh artifact on phase 5's reduced model with one GLM scale (its
    # export and load time grow with the graph's nodes), weighted to detect
    # by phase 6's recipe (a zero classifier kernel under the +8 bias)
    small = Config(image_size=128, backbone="resnet50", glm_input_size=65, glm_scales=(),
                   pre_nms_limit=400, post_nms_rois_inference=64, detection_max_instances=32,
                   compute_dtype="float32", param_dtype="float32")
    sd = make_detector(small, seed=0, device=dev).model.state_dict()
    sd["classifier.linear_class.weight"].zero_()
    mesh_dir = os.path.join(tmp, "serving_mesh")
    export_detector(small, sd, mesh_dir, batch=4, mesh=(dev, dev))
    served = ServingDetector.load(mesh_dir, mesh=(dev, dev))
    got = served.detect(imgs)
    mesh_want = Detector(small, sd, mesh=(dev, dev)).detect(imgs)
    want = Detector(small, sd, device=dev).detect(imgs)
    score_err = max([0.0] + [float(np.abs(g["scores"] - w["scores"]).max(initial=0.0))
                             for g, w in zip(got, want)])
    if (not same_results(got, mesh_want) or score_err > 1e-5 or min(
            len(r["scores"]) for r in got) == 0 or not all(
            np.array_equal(g[k], w[k]) for g, w in zip(got, want)
            for k in ("rois", "class_ids", "masks"))):
        raise AssertionError(f"serving (e): the mesh artifact differs (scores {score_err})")
    out["e"] = dict(image=128, cli_full_contract_loads=True, global_label_equal=True,
                    global_label_shape=label_shape, mesh_bit_equal_to_mesh_detector=True,
                    mesh_score_max_abs_err=score_err,
                    mesh_detections=[len(r["scores"]) for r in got],
                    seconds=time.perf_counter() - t)
    emit({"phase": "serving", "part": "e", **out["e"]})
    shutil.rmtree(mesh_dir)
    del served

    # (f) evaluate --trace_dir
    trace_dir = os.path.join(tmp, "trace")
    common = ["evaluate", "--dataset", ev["root"], "--model", ev["model"], "--limit", "8",
              "--eval_batch", "8", "--device", str(dev)]
    plain = cli.main(common)
    traced = cli.main(common + ["--trace_dir", trace_dir])
    names = trace_kernel_names(trace_dir)
    found = {k: [n for n in names if k in n] for k in ("nms_mask_kernel", "nms_scan_kernel",
                                                       "roi_align_kernel")}
    if not all(found.values()):
        raise AssertionError(f"serving (f): the trace lacks a kernel: {found}")
    if traced.results != plain.results or not all(
            np.array_equal(traced.stats[k], plain.stats[k]) for k in plain.stats):
        raise AssertionError("serving (f): evaluate --trace_dir differs from evaluate")
    trace_bytes = sum(os.path.getsize(os.path.join(r, n))
                      for r, _, files in os.walk(trace_dir) for n in files)
    out["f"] = dict(images=8, results=len(plain.results), results_equal=True,
                    kernels_in_trace={k: v[0] for k, v in found.items()},
                    device_kernel_names=len(names), trace_bytes=trace_bytes,
                    predict_s=plain.seconds, predict_traced_s=traced.seconds)
    emit({"phase": "serving", "part": "f", **out["f"]})
    shutil.rmtree(trace_dir)

    # (g) host work per call after the registration
    pr7 = {"nms": 0.3163, "roi_align": 0.6333, "roi_align_backward": 1.1724}
    out["g"] = dict(
        wrapper={name: {"ms": k["ms"], "host_us": k["host_us"], "pr7_run5_ms": pr7[name]}
                 for name, k in kernel_checks.items()},
        op_vs_direct_host_us=dispatcher_hop_us(dev))
    emit({"phase": "serving", "part": "g", **out["g"]})
    out["launches"] = out["b"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "serving", "seconds": out["seconds"]})
    return out


def parity_path(dev, tmp):
    """Phase 14: ``cli.run_parity --dry_run`` at full width (the ``Config``
    default, bfloat16) on 8 synthetic 1024² images at ``--eval_batch 8``:
    the ``.pth`` that ``cli.train train`` saves and the release layout (the
    ``.pth`` without ``GLM_modual.*`` keys, the standalone
    ``deeplabv2.pth``) give identical sweeps with AR@100 > 0, and each
    evaluate batch launches NMS once, RoIAlign twice, the backward never.
    Then ``cli.test_images`` writes the reference pickles of 2 of the images
    and ``cli.parity_check`` on the same ``.pth`` finds 2/2 within tolerance
    (exit 0), and exits 1 on a copy with one box moved by 3 px."""
    import pickle
    import shutil

    from sln_amodal_tpu_torch.cli import parity_check, run_parity, test_images

    kernels = train_kernels()
    for k in kernels:
        k.launches = 0
    t = time.perf_counter()
    dry = run_parity.main(["--dry_run", os.path.join(tmp, "parity"), "--limit", "8",
                           "--eval_batch", "8", "--device", str(dev)])
    dry_s = time.perf_counter() - t
    launches = {n: k.launches for n, k in zip(KERNEL_NAMES, train_kernels())}
    if launches != {"nms": 2, "roi_align": 4, "roi_align_backward": 0}:
        raise AssertionError(f"dry run launches over 2 evaluate batches: {launches}")
    if dry.native != dry.release or dry.native["both/all"][5] <= 0:
        raise AssertionError(f"dry run sweeps {dry.native['both/all']} / "
                             f"{dry.release['both/all']}")

    images, ref, perturbed = (os.path.join(tmp, d) for d in
                              ("parity_images", "parity_ref", "parity_perturbed"))
    os.makedirs(images)
    for name in ("img_0001.jpg", "img_0002.jpg"):
        shutil.copy(os.path.join(dry.dataset, "val2014", name), images)
    t = time.perf_counter()
    written = test_images.main(["--images", images, "--model", dry.native_path, "--out", ref,
                                "--device", str(dev)])
    test_images_s = time.perf_counter() - t
    argv = ["--images", images, "--model", dry.native_path, "--device", str(dev)]
    t = time.perf_counter()
    status = parity_check.main(argv + ["--reference_results", ref])
    parity_check_s = time.perf_counter() - t
    shutil.copytree(ref, perturbed)
    moved = os.path.join(perturbed, os.path.basename(written[0]))
    with open(moved, "rb") as f:
        result = pickle.load(f)
    result["rois"][0] += 3
    with open(moved, "wb") as f:
        pickle.dump(result, f)
    perturbed_status = parity_check.main(argv + ["--reference_results", perturbed])
    detections = []
    for path in written:
        with open(path, "rb") as f:
            detections.append(len(pickle.load(f)["scores"]))
    if (status, perturbed_status) != (0, 1):
        raise AssertionError(f"parity_check exit {status} (want 0), on the moved box "
                             f"{perturbed_status} (want 1)")
    out = dict(images=8, eval_batch=8, dtype="bfloat16", dry_run_s=dry_s,
               sweep_s=dry.seconds, sweeps_identical=True,
               both_all=dry.native["both/all"], launches=launches,
               launches_per_batch={k: v // 2 for k, v in launches.items()},
               detections_per_image=detections,
               test_images_s=test_images_s, parity_check_s=parity_check_s,
               parity_check_exit=status, moved_box_exit=perturbed_status)
    emit({"phase": "parity", **out})
    return out


SOAK_STEPS = 20
SOAK_LOADERS = (("host", []), ("device_prep", ["--device_prep"]))


def soak_path(dev, tmp):
    """Phase 15: ``cli.train_soak`` at batch 8, 1024², heads, ``SOAK_STEPS``
    steps from the seeded init, with the host ``TrainLoader`` and with
    ``--device_prep``. First each loader's soak alone, as a user runs it:
    its own median step ms (CUDA events, no synchronize), its wall, peak
    device memory, and the kernels' launches over both runs, counted from
    0. Then each again under :func:`timed_train` (each step ends in a
    synchronize; the last three run under ``torch.profiler`` and are left
    out of the medians): finite losses (the first and last printed),
    launches per step (NMS 1, RoIAlign 2, backward 2), the step's wall and
    device ms, the loader wait, the positive and valid sampled ROIs per step
    (from the seeded init few or none are positive) and the backward
    kernels' device ms per profiled step."""
    from sln_amodal_tpu_torch.cli import train_soak
    from sln_amodal_tpu_torch.train import trainer as trainer_mod

    kernels = train_kernels()
    root = os.path.join(tmp, "soak")
    argv = ["--batch", "8", "--steps", str(SOAK_STEPS), "--size", "1024", "--root", root,
            "--device", str(dev)]
    runs = {}
    for k in kernels:
        k.launches = 0
    for label, extra in SOAK_LOADERS:
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        soak = train_soak.main(argv + extra)
        runs[label] = dict(batch=8, image=1024, steps=SOAK_STEPS,
                           soak_run_s=time.perf_counter() - t, soak_wall_s=soak.wall_s,
                           soak_median_step_ms=soak.median_step_ms,
                           soak_step_ms=soak.step_ms, soak_last_losses=soak.last_losses,
                           peak_mem_bytes=int(torch.cuda.max_memory_allocated(dev)))
    launches = {n: k.launches for n, k in zip(KERNEL_NAMES, kernels)}
    if launches != {"nms": 2 * SOAK_STEPS, "roi_align": 4 * SOAK_STEPS,
                    "roi_align_backward": 4 * SOAK_STEPS}:
        raise AssertionError(f"soak launches over {2 * SOAK_STEPS} steps: {launches}")

    with timed_train(trainer_mod, train_soak, kernels, profile_last=3) as (rec, stage,
                                                                          stop_profile):
        for label, extra in SOAK_LOADERS:
            stage(SOAK_STEPS)
            first = len(rec["steps"])
            waits = len(rec["loader_wait_ms"])
            t = time.perf_counter()
            train_soak.main(argv + extra)
            run_s = time.perf_counter() - t
            _, kernel_ms, _ = stop_profile()
            steps_rec = rec["steps"][first:]
            profiled = [s for s in steps_rec if s["profiled"]]
            timed = [s for s in steps_rec[1:] if not s["profiled"]]
            if (len(steps_rec) != SOAK_STEPS
                    or not all(np.isfinite(v) for s in steps_rec for v in s["losses"].values())):
                raise AssertionError(f"soak {label}: steps {steps_rec}")
            if any(s["launches"] != [1, 2, 2] for s in steps_rec):
                raise AssertionError(f"soak {label}: launches per step "
                                     f"{[s['launches'] for s in steps_rec]}")
            wait = rec["loader_wait_ms"][waits:]
            positives = [s["positives"] for s in steps_rec]
            runs[label].update(
                timed_run_s=run_s,
                step_wall_ms_median=statistics.median(s["wall_ms"] for s in timed),
                step_device_ms_median=statistics.median(s["device_ms"] for s in timed),
                images_per_s=8 * 1e3 / statistics.median(s["wall_ms"] for s in timed),
                loader_wait_ms_per_step=statistics.mean(wait),
                loader_wait_ms_after_first_step=statistics.mean(wait[1:]),
                loader_wait_ms_max=max(wait),
                backward_device_ms_per_step=kernel_ms["roi_align_backward_"] / len(profiled),
                kernel_device_ms_per_profiled_step={k: v / len(profiled)
                                                    for k, v in kernel_ms.items()},
                first_losses=steps_rec[0]["losses"], last_losses=steps_rec[-1]["losses"],
                positives_per_step=positives,
                steps_with_positives=sum(p > 0 for p in positives),
                valid_rois_per_step=[s["valid_rois"] for s in steps_rec],
                launches_per_step=dict(zip(KERNEL_NAMES, steps_rec[-1]["launches"])))
            emit({"phase": "train_soak", "loader": label, **runs[label]})
    return dict(runs=runs, launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sln_amodal_tpu_torch.cuda_build import build_all
    from sln_amodal_tpu_torch.ops.nms_cuda import NMS_KERNEL
    from sln_amodal_tpu_torch.ops.roi_align_cuda import (ROI_ALIGN_BACKWARD_KERNEL,
                                                         ROI_ALIGN_KERNEL)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    build_s, logs = build_all([NMS_KERNEL, ROI_ALIGN_KERNEL, ROI_ALIGN_BACKWARD_KERNEL])
    emit({"phase": "build", "seconds": build_s,
          "ptxas": {name: [ln for ln in log.splitlines() if "Used" in ln]
                    for name, log in logs.items()}})

    # both main paths' shapes: batch 2 (detect) and batch 8 (evaluate), the
    # RoIAlign kernels in float32 and bfloat16
    for b in (2, 8):
        nms, roi = check_nms(dev, b), check_roi_align(dev, b)
        roi_bf16 = check_roi_align(dev, b, torch.bfloat16)
    backward = check_roi_align_backward(dev, 2)
    backward_bf16 = check_roi_align_backward(dev, 2, torch.bfloat16)
    # the batch-8 train step's shapes (phase 15), as the step pads them
    backward_b8 = {str(dtype): check_roi_align_backward(dev, 8, dtype, layouts=("sampled",))
                   for dtype in (torch.float32, torch.bfloat16)}
    paths = main_paths(dev)
    path = paths["float32"]
    with tempfile.TemporaryDirectory() as tmp:
        reference_check(dev)
        reference_eval(dev, tmp)
        ev = eval_path(dev, tmp)
        reference_train(dev, tmp)
        convergence(dev, tmp)
        tr = train_path(dev, tmp)
        prep = device_prep_check(dev, tr)
        trp = train_device_prep(dev, tmp, tr, prep)
        dp = data_parallel(dev, tmp, tr, ev)
        srv = serving(dev, tmp, path, ev, {"nms": nms, "roi_align": roi,
                                           "roi_align_backward": backward})
        par = parity_path(dev, tmp)
        soak = soak_path(dev, tmp)

    # one line per kernel: times at the evaluate path's shapes (batch 8) for
    # the forward kernels, at the train step's (batch 2) for the backward,
    # in the dtype the CLIs run (bfloat16; NMS takes float32 boxes), the
    # float32 instantiation's beside them; launches from the evaluate and
    # train runs (bfloat16), every path's launches beside them (phase 4 in
    # float32 and bfloat16; phases 6 and 9-13 bfloat16, phase 13's export
    # float32)
    def timing(k):
        return {key: k[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "device_ms", "host_us")}

    kernels = []
    for name, source, replaces, key, k, k32, batch, main_run in (
            ("nms_sorted_batched", "nms.cu", "nms_pallas.py:60", "nms", nms, None, 8, ev),
            ("pyramid_roi_align", "roi_align.cu", "roi_patch_pallas.py:59", "roi_align",
             roi_bf16, roi, 8, ev),
            ("pyramid_roi_align_backward", "roi_align_backward.cu", "roi_align.py:650",
             "roi_align_backward", backward_bf16, backward, 2, tr)):
        kernels.append({
            "name": name, "route": "cuda", "source": f"sln_amodal_tpu_torch/csrc/{source}",
            "replaces": f"sln_amodal_tpu/ops/{replaces}", "launches": main_run["launches"][key],
            "launches_by_path": {"detect_float32": path["launches"][key],
                                 "detect_bfloat16": paths["bfloat16"]["launches"][key],
                                 "evaluate": ev["launches"][key],
                                 "train": tr["launches"][key],
                                 "train_device_prep": trp["launches"][key],
                                 "data_parallel": dp["launches"][key],
                                 "data_parallel_serving": dp["serving_launches"][key],
                                 "serving": srv["launches"][key],
                                 "parity": par["launches"][key],
                                 "train_soak": soak["launches"][key]},
            "dtype": "float32 boxes" if k32 is None else "bfloat16",
            # the backward's times are the "sampled" layout's, the others' beside
            **({"layout": "sampled",
                "device_ms_by_layout": {name: v["device_ms"] for name, v in k["layouts"].items()}}
               if "layouts" in k else {}),
            "batch": batch, **timing(k), "library_ms": None,
            "float32": None if k32 is None else timing(k32),
            **({"batch8_sampled": {d: timing(v) for d, v in backward_b8.items()}}
               if key == "roi_align_backward" else {})})
    emit({"kernels": kernels})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["data_parallel_worker"]:
        sys.exit(data_parallel_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["serving_worker"]:
        sys.exit(serving_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["backward_device_ms"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        sys.path.insert(0, os.getcwd())  # the package of the working directory's checkout
        for dtype in (torch.bfloat16, torch.float32):
            backward_device_ms(torch.device("cuda", 0), dtype)
        sys.exit(0)
    sys.exit(main())
