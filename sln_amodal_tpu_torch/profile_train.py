"""Where the device time of one training step goes, on one NVIDIA GPU.

    python -m sln_amodal_tpu_torch.profile_train [--batch 2] [--repeats 5]

The model runs at full width (``Config()`` defaults: bfloat16 compute,
float32 parameters; TF32 off for what runs in float32). The weights are the RPN-biased checkpoint of ``chip_smoke.py``'s train phase
(``utils/synthetic.py::rpn_biased_variables`` with a zero shared RPN conv,
so the proposals are the anchors in order) and the batch has two ground
truth boxes per image on the first proposals, so positive ROIs reach the
heads. Prints one JSON line per stage ("heads", "all"):

- ``stages``: the eager step part by part: the median ms of each part (the
  calls of ``SLNAmodal.train_step_outputs``, the losses, the backward and
  the optimizer, with CUDA events between them), of the batch's upload,
  and of the whole ``trainer.train_step`` (to ``synchronize``);
- ``graphed`` and ``eager``: the step as ``Trainer`` runs it on the card,
  its captured graph (``train/compiled_step.py``: the loader's batch copied
  into the graph's static buffers, a replay, the losses copied out), and
  the eager ``train_step`` on the uploaded batch, timed in turns: the
  median ms of a step to ``synchronize``, and over one step under
  ``torch.profiler`` the device kernel ms, the kernels launched, the host's
  launch calls (by name), the device's busy share of the step's span and
  the time by kernel, the largest first (the RoIAlign backward's two
  kernels among them, under their common prefix ``roi_align_backward_``);
  ``capture_s``: the graphed step's first two calls (the eager first call
  and the capture, with its replay); ``peak_mem_bytes``: the peak over both.

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
from .data.pipeline import build_rpn_targets
from .detect.proposal import proposal_layer_batched
from .detect.targets import detection_target_layer
from .models.sln import SLNAmodal, TrainingOutputs
from .ops.anchors import config_anchors
from .profile_infer import kernel_times
from .compiled import CudaGraphs
from .train.compiled_step import CapturedStep
from .train.optim import StagedSGD
from .train.trainer import batch_tensors, batched_losses, step_uniforms, to_device, train_step
from .utils.synthetic import rpn_biased_variables


def make_batch(cfg: Config, batch: int, seed: int) -> dict:
    """Molded noise images, each with two ground-truth boxes among the
    RPN-biased model's first proposals (computed on the CPU), their
    rectangle masks and the pipeline's RPN targets."""
    anchors = config_anchors(cfg)
    n = anchors.shape[0]
    props, valid = proposal_layer_batched(
        torch.full((1, n, 2), 0.5), torch.zeros((1, n, 4)), torch.from_numpy(anchors),
        proposal_count=cfg.post_nms_rois_training, nms_threshold=cfg.rpn_nms_threshold,
        image_size=cfg.image_size, rpn_bbox_std_dev=cfg.rpn_bbox_std_dev,
        pre_nms_limit=cfg.pre_nms_limit)
    boxes = torch.round(props[0][valid[0]] * cfg.image_size).numpy().astype(np.int32)
    boxes = boxes[(boxes[:, 2] - boxes[:, 0] > 4) & (boxes[:, 3] - boxes[:, 1] > 4)]
    rng = np.random.RandomState(seed)
    s, g = cfg.image_size, cfg.max_gt_instances
    out = defaultdict(list)
    for i in range(batch):
        gt = boxes[[i, i + 3]]
        ids = np.array([1, 1], np.int32)
        match, deltas = build_rpn_targets(anchors, ids, gt, cfg, np.random.default_rng(seed + i))
        masks = np.zeros((g, cfg.num_layers, s, s), np.uint8)
        for k, (y1, x1, y2, x2) in enumerate(gt):
            masks[k, :, y1:y2, x1:x2] = 1
        pad_boxes = np.zeros((g, 4), np.float32)
        pad_boxes[:2] = gt / float(s)
        out["images"].append(rng.randint(0, 256, (s, s, 3)).astype(np.float32)
                             - np.asarray(cfg.mean_pixel, np.float32))
        out["rpn_match"].append(match)
        out["rpn_deltas"].append(deltas.astype(np.float32))
        out["gt_class_ids"].append(np.pad(ids, (0, g - 2)))
        out["gt_boxes"].append(pad_boxes)
        out["gt_masks"].append(masks)
    return {k: np.stack(v) for k, v in out.items()}


def stage_times(model: SLNAmodal, optimizer, batch: dict, generator) -> dict:
    """One training step, its parts between CUDA events: {part: ms}."""
    m, cfg = model, model.config
    events = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    events[0][1].record()
    feats = m.fpn(batch["images"].to(m.compute_dtype))
    mark("backbone_fpn")
    rpn_logits, rpn_probs, rpn_deltas = m._rpn_all_levels(feats)
    mark("rpn_head")
    with torch.no_grad():
        glm_prior, _ = m._glm_prior(batch["images"], need_label=False)
        mark("glm_deeplab_msc")
        rois, roi_valid = m._proposals(rpn_probs, rpn_deltas, cfg.post_nms_rois_training)
        mark("proposals_nms")
        targets = detection_target_layer(
            rois, roi_valid, batch["gt_class_ids"], batch["gt_boxes"], batch["gt_masks"],
            train_rois=cfg.train_rois_per_image, roi_positive_ratio=cfg.roi_positive_ratio,
            mask_shape=cfg.mask_shape, bbox_std_dev=cfg.bbox_std_dev, generator=generator)
        mark("detection_targets")
    levels = [p.contiguous() for p in feats[:4]]
    class_logits, _, bbox_deltas = m._classifier_on(levels, targets.rois)
    mark("roi_align7_classifier")
    mask_logits = m._mask_on(levels, targets.rois, glm_prior, targets.rois)
    mark("roi_align16_glm_crop_mask_head")
    losses = batched_losses(TrainingOutputs(rpn_logits, rpn_deltas, targets, class_logits,
                                            bbox_deltas, mask_logits), batch)
    mark("losses")
    optimizer.zero_grad()
    losses["total"].backward()
    mark("backward")
    optimizer.step()
    mark("optimizer_clip_sgd")
    torch.cuda.synchronize()
    return {name: events[i][1].elapsed_time(ev) for i, (name, ev) in enumerate(events[1:])}


KERNELS = ("roi_align_backward_", "roi_align_kernel", "nms_mask_kernel", "nms_scan_kernel")


def graphed_and_eager(model: SLNAmodal, optimizer, batch_np: dict, uniforms,
                      repeats: int) -> dict:
    """The step on its captured graph and eager, as the module docstring
    says: {"graphed": ..., "eager": ..., "capture_s": ...}."""
    dev = next(model.parameters()).device
    captured = CapturedStep(lambda batch, u: train_step(model, optimizer, batch, uniforms=u),
                            optimizer, CudaGraphs(), dev)
    runs = {"graphed": lambda: captured(batch_tensors(batch_np), uniforms),
            "eager": lambda: train_step(model, optimizer, to_device(batch_np, dev),
                                        uniforms=uniforms)}
    t = time.perf_counter()
    runs["graphed"]()                  # its eager first call
    runs["graphed"]()                  # the capture and its replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    walls = defaultdict(list)
    for i in range(repeats):
        for kind in (("graphed", "eager") if i % 2 == 0 else ("eager", "graphed")):
            t = time.perf_counter()
            runs[kind]()
            torch.cuda.synchronize()
            walls[kind].append((time.perf_counter() - t) * 1e3)
    out = {kind: dict(step_to_sync_ms=statistics.median(walls[kind]),
                      **kernel_times(fn, match=KERNELS)) for kind, fn in runs.items()}
    out["capture_s"] = capture_s
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = Config(batch_size=args.batch)
    sd = rpn_biased_variables(init_params(cfg, seed=args.seed, device="cpu"))
    sd["rpn.conv_shared.weight"].zero_()
    sd["rpn.conv_shared.bias"].zero_()
    batch_np = make_batch(cfg, args.batch, args.seed)
    for stage in ("heads", "all"):
        model = SLNAmodal(cfg, device=dev)
        model.load_state_dict(sd)
        optimizer = StagedSGD(model, stage, cfg.learning_rate)
        generator = torch.Generator().manual_seed(args.seed)
        train_step(model, optimizer, to_device(batch_np, dev), generator)   # warm-up
        torch.cuda.synchronize()
        stages = defaultdict(list)
        for _ in range(args.repeats):
            t = time.perf_counter()
            batch = to_device(batch_np, dev)
            torch.cuda.synchronize()
            stages["upload_batch"].append((time.perf_counter() - t) * 1e3)
            for name, ms in stage_times(model, optimizer, batch, generator).items():
                stages[name].append(ms)
            t = time.perf_counter()
            train_step(model, optimizer, batch, generator)
            torch.cuda.synchronize()
            stages["train_step_to_sync"].append((time.perf_counter() - t) * 1e3)
        torch.cuda.reset_peak_memory_stats(dev)
        uniforms = step_uniforms(generator, args.batch, cfg.post_nms_rois_training)
        sides = graphed_and_eager(model, optimizer, batch_np, uniforms, args.repeats)
        print(json.dumps({"stage": stage, "batch": args.batch, "repeats": args.repeats,
                          "stages": {k: statistics.median(v) for k, v in stages.items()},
                          "peak_mem_bytes": int(torch.cuda.max_memory_allocated(dev)),
                          **sides, "device": torch.cuda.get_device_name(0)}), flush=True)
        del model, optimizer
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
