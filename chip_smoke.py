#!/usr/bin/env python3
"""Drives the PyTorch port on one NVIDIA GPU and checks it end to end.

    python3 chip_smoke.py

Phases (each prints one JSON line):

1. device — the card's name and power limit; TF32 off for convolutions and
   matmuls, so float32 means float32.
2. build — the CUDA kernels built from ``sln_amodal_tpu_torch/csrc`` with
   nvcc (one process per source, all started together).
3. kernels — each kernel held against its plain PyTorch version on the card
   at the main path's shapes with seeded inputs, bit for bit (NMS: keeps
   equal; RoIAlign: ``torch.equal``). ``ms`` is the median time of one
   wrapper call between CUDA events (the host's work before the launch
   included); ``device_ms`` the mean device time of the wrapper's kernels
   per call from ``torch.profiler``, which also gives each NMS pass
   (``pass_ms``) and shows the RoIAlign wrapper is one launch per call;
   ``host_us`` the wrapper's host time per call, enqueued back to back.
4. main path — ``Detector.detect`` on 2 seeded 1024² images at the full
   width of the one supported model (ResNet-101-FPN, DeepLabV2-MSC GLM at
   513², 6000 -> 1000 proposals, 100 detections), float32, random seeded
   weights; the kernels' launch counts over that run, ms per call and peak
   device memory.
5. reference — the whole slice at a small size in float64 on the card
   (kernels) against the CPU (plain versions): equal boxes and classes.

Then, on lines of their own: the kernels' JSON summary, the card's name and
power limit, and ``{"ok": true, "device": {...}}`` last. Any failure raises
and the exit code is non-zero; so is it without a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
    ``repeats`` calls, from ``torch.profiler``, after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    ms, launches = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms[e.name] = ms.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
            launches[e.name] = launches.get(e.name, 0) + 1
    if not ms:
        raise RuntimeError("torch.profiler recorded no device activity")
    return {name: (ms[name] / repeats, launches[name] / repeats) for name in ms}


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


def check_nms(dev):
    from sln_amodal_tpu_torch.ops.nms import nms_sorted_batched_plain
    from sln_amodal_tpu_torch.ops.nms_cuda import nms_sorted_batched

    rng = np.random.RandomState(0)
    b, n, max_out, thr = 2, 6000, 1000, 0.7
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


def check_roi_align(dev):
    from sln_amodal_tpu_torch.ops.roi_align import pyramid_roi_align_plain, sample_geometry
    from sln_amodal_tpu_torch.ops.roi_align_cuda import pyramid_roi_align

    gen = torch.Generator().manual_seed(1)
    b, c = 2, 256
    feats = [torch.randn((b, s, s, c), generator=gen).to(dev) for s in (256, 128, 64, 32)]
    shapes = [tuple(f.shape[1:]) for f in feats]
    rng = np.random.RandomState(2)
    total = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0)
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
        nbytes = touched * c * 4 + b * n * 16 + out_elems * 4
        bound_ms, bound_by = bound(nbytes, out_elems * LERP_FLOPS)
        shape = dict(pool=pool, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     device_ms=sum(t for t, _ in by_kernel.values()),
                     host_us=host_us(lambda: pyramid_roi_align(*args), 30),
                     bound_ms=bound_ms, bound_by=bound_by, touched_rows=touched)
        emit({"phase": "kernel", "name": "roi_align", **shape})
        per_shape.append(shape)
        for k in ("ms", "device_ms", "plain_ms", "bound_ms"):
            total[k] += shape[k]
        total["max_abs_err"] = max(total["max_abs_err"], err)
    total["bound_by"] = "bytes" if all(s["bound_by"] == "bytes" for s in per_shape) else "operations"
    return total


def main_path(dev):
    from sln_amodal_tpu_torch.config import Config
    from sln_amodal_tpu_torch.ops.nms_cuda import NMS_KERNEL
    from sln_amodal_tpu_torch.ops.roi_align_cuda import ROI_ALIGN_KERNEL
    from sln_amodal_tpu_torch.profile_infer import make_detector

    cfg = Config(compute_dtype="float32", param_dtype="float32")
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
    NMS_KERNEL.launches = 0
    ROI_ALIGN_KERNEL.launches = 0
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
    launches = {"nms": NMS_KERNEL.launches, "roi_align": ROI_ALIGN_KERNEL.launches}
    peak = torch.cuda.max_memory_allocated(dev)

    if launches != {"nms": calls, "roi_align": 2 * calls}:
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
    out = dict(batch=2, image=size, calls=calls, ms_per_detect=statistics.median(wall),
               device_ms_per_detect=statistics.median(device_ms), setup_s=setup_s,
               peak_mem_bytes=int(peak), launches=launches, detections=n_det)
    emit({"phase": "main_path", **out})
    return out


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sln_amodal_tpu_torch.cuda_build import build_all
    from sln_amodal_tpu_torch.ops.nms_cuda import NMS_KERNEL
    from sln_amodal_tpu_torch.ops.roi_align_cuda import ROI_ALIGN_KERNEL

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

    build_s, logs = build_all([NMS_KERNEL, ROI_ALIGN_KERNEL])
    emit({"phase": "build", "seconds": build_s,
          "ptxas": {name: [ln for ln in log.splitlines() if "Used" in ln]
                    for name, log in logs.items()}})

    nms = check_nms(dev)
    roi = check_roi_align(dev)
    path = main_path(dev)
    reference_check(dev)

    kernels = [
        {"name": "nms_sorted_batched", "route": "cuda",
         "source": "sln_amodal_tpu_torch/csrc/nms.cu",
         "replaces": "sln_amodal_tpu/ops/nms_pallas.py:60",
         "launches": path["launches"]["nms"], "max_abs_err": nms["max_abs_err"],
         "ms": nms["ms"], "plain_ms": nms["plain_ms"], "bound_ms": nms["bound_ms"],
         "bound_by": nms["bound_by"], "library_ms": None, "device_ms": nms["device_ms"]},
        {"name": "pyramid_roi_align", "route": "cuda",
         "source": "sln_amodal_tpu_torch/csrc/roi_align.cu",
         "replaces": "sln_amodal_tpu/ops/roi_patch_pallas.py:59",
         "launches": path["launches"]["roi_align"], "max_abs_err": roi["max_abs_err"],
         "ms": roi["ms"], "plain_ms": roi["plain_ms"], "bound_ms": roi["bound_ms"],
         "bound_by": roi["bound_by"], "library_ms": None, "device_ms": roi["device_ms"]},
    ]
    emit({"kernels": kernels})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
