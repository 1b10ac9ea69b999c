"""Where the device time of ``Detector.detect`` goes, on one NVIDIA GPU.

    python -m sln_amodal_tpu_torch.profile_infer [--batch 2] [--repeats 5]

The model runs at full width (``Config()`` defaults: bfloat16 compute,
float32 parameters; TF32 off for what runs in float32) on
seeded uint8 images, with random seeded weights shaped as ``chip_smoke.py``
shapes them, so the mask head runs over 100 real detections per image.
Prints JSON lines:

- ``stages``: the median ms of each stage of ``SLNAmodal._infer_impl`` run
  eagerly (the same calls in the same order, with CUDA events between
  them), of the whole ``dispatch`` (to ``synchronize``) on the captured
  graph (``detect_dispatch_to_sync``) and on the eager model
  (``eager_dispatch_to_sync``), and of the host unmold in ``collect``;
- ``kernels``: per path (``graphed``: the replay of the captured graph that
  ``Detector.dispatch`` runs on a card; ``eager``: ``infer_detect_only``
  called directly), device time by kernel over one dispatch from
  ``torch.profiler``, the largest first, the device's busy share of that
  call's span and the host's launch calls (``host_launches``: the runtime
  calls that enqueue device work).

Needs a card; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

from .config import Config
from .convert import init_params
from .detect.detection import refine_detections
from .infer import Detector, PendingDetect
from .utils.image import pil_molded

# the runtime calls that enqueue work on the device, as torch.profiler
# names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")


def make_detector(cfg: Config, seed: int, device) -> Detector:
    """Random seeded weights shaped so the path runs over real boxes: RPN
    scores spread over (0, 1), zero box deltas, a high foreground bias."""
    sd = init_params(cfg, seed=seed, device=device)
    sd["rpn.conv_class.weight"] *= 1e-3
    for key in ("rpn.conv_bbox.weight", "rpn.conv_bbox.bias",
                "classifier.linear_bbox.weight", "classifier.linear_bbox.bias"):
        sd[key].zero_()
    sd["classifier.linear_class.bias"][1] = 8.0
    return Detector(cfg, sd, device=device)


def eager_dispatch(det: Detector, images) -> PendingDetect:
    """The eager graph, ``SLNAmodal.infer_detect_only`` called directly, on
    the frames ``det.dispatch`` gives its program, here resized by PIL on
    the host (uploaded as uint8, then the mean subtracted on the card): a
    ``PendingDetect`` that ``det.collect`` takes. The reference of the
    captured graph and of the device resize before it."""
    size = det.config.image_size
    molded = pil_molded(images, size)
    windows = np.array([(0, 0, size, size)] * len(images))
    x = torch.from_numpy(molded).to(det.device).to(torch.float32) - det.programs[0].fn.mean
    out = det.model.infer_detect_only(
        x, torch.as_tensor(windows, dtype=torch.float32, device=det.device))
    return PendingDetect(images=images, windows=windows, out=[out])


def stage_times(det: Detector, x: torch.Tensor, windows: torch.Tensor) -> dict:
    """One pass of ``_infer_impl``'s detect-only stages, each between two
    CUDA events; returns {stage: ms}."""
    m, cfg = det.model, det.config
    events = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    events[0][1].record()
    with torch.no_grad():
        feats = m.fpn(x.to(m.compute_dtype))
        mark("backbone_fpn")
        _, rpn_probs, rpn_deltas = m._rpn_all_levels(feats)
        mark("rpn_head")
        glm_prior, _ = m._glm_prior(x, need_label=False)
        mark("glm_deeplab_msc")
        rois, roi_valid = m._proposals(rpn_probs, rpn_deltas, cfg.post_nms_rois_inference)
        mark("proposals_nms")
        levels = [p.contiguous() for p in feats[:4]]
        _, probs, deltas = m._classifier_on(levels, rois)
        mark("roi_align7_classifier")
        detections, _ = refine_detections(
            rois, roi_valid, probs, deltas, windows, image_size=cfg.image_size,
            bbox_std_dev=cfg.rpn_bbox_std_dev, max_instances=cfg.detection_max_instances,
            min_confidence=cfg.detection_min_confidence, use_nms=cfg.use_nms,
            nms_threshold=cfg.detection_nms_threshold)
        mark("refine_detections")
        boxes_px = torch.clamp(detections[..., :4], 0.0, float(cfg.image_size))
        boxes_norm = boxes_px / float(cfg.image_size)
        glm_boxes = boxes_px if cfg.glm_prior_pixel_coords_at_inference else boxes_norm
        m._mask_on(levels, boxes_norm, glm_prior, glm_boxes)
        mark("roi_align16_glm_crop_mask_head")
    torch.cuda.synchronize()
    return {name: events[i][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(events[1:])}


def kernel_times(fn, match=()) -> dict:
    """Device time by kernel name over one call of ``fn``, the busy share
    (the union of kernel intervals over the span from the first kernel's
    start to the last one's end) and the host's launch calls
    (``HOST_LAUNCH_CALLS``, by name); ``match``: name fragments whose
    kernels' ms and launches are summed under ``matched``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        raise RuntimeError("torch.profiler recorded no device activity")
    calls = defaultdict(int)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA and e.name in HOST_LAUNCH_CALLS:
            calls[e.name] += 1
    by_name = defaultdict(float)
    for s, e, name in spans:
        by_name[name] += (e - s) / 1e3
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e, _ in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e, _ in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    matched = {m: {"ms": sum((e - s) / 1e3 for s, e, n in spans if m in n),
                   "launches": sum(m in n for _, _, n in spans)} for m in match}
    return {"kernel_ms_total": sum(by_name.values()), "span_ms": span / 1e3,
            "busy_share": busy / span, "n_kernel_launches": len(spans),
            "host_launches": sum(calls.values()), "host_launch_calls": dict(calls),
            "top": [{"name": n[:120], "ms": t} for n, t in top[:20]], "matched": matched}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_infer: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = Config()
    det = make_detector(cfg, args.seed, dev)
    rng = np.random.RandomState(args.seed)
    images = [rng.randint(0, 256, (cfg.image_size, cfg.image_size, 3), np.uint8)
              for _ in range(args.batch)]
    det.detect(images)                     # warm-up and capture

    x = torch.from_numpy(pil_molded(images, cfg.image_size)).to(dev).to(torch.float32) \
        - det.programs[0].fn.mean
    w = torch.tensor([(0, 0, cfg.image_size, cfg.image_size)] * len(images),
                     dtype=torch.float32, device=dev)

    def eager():
        return eager_dispatch(det, images)

    stages = defaultdict(list)
    for _ in range(args.repeats):
        for name, ms in stage_times(det, x, w).items():
            stages[name].append(ms)
        for key, dispatch in (("detect", lambda: det.dispatch(images)), ("eager", eager)):
            t = time.perf_counter()
            pending = dispatch()
            torch.cuda.synchronize()
            t_dispatch = time.perf_counter()
            det.collect(pending)
            stages[f"{key}_dispatch_to_sync"].append((t_dispatch - t) * 1e3)
            if key == "detect":
                stages["host_collect_unmold"].append((time.perf_counter() - t_dispatch) * 1e3)
    print(json.dumps({"stages": {k: statistics.median(v) for k, v in stages.items()},
                      "batch": args.batch, "repeats": args.repeats,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    print(json.dumps({"kernels": {"graphed": kernel_times(lambda: det.dispatch(images)),
                                  "eager": kernel_times(eager)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
