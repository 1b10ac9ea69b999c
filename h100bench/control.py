"""Readings that the correctness limits are set from, in one process:

- the program's numbers over many seeds (``--program``): the cell's own
  run (the driver, the window at the cell's load, the judge) with a short
  window, one seed after another;
- the control's numbers over a few seeds (``--control``): the reference
  computed in float8 put in the program's place, on the same images and
  weights, judged by the float32 reference as the program is.

    python3 h100bench/control.py --workload <name> --program 12 --control 3 \\
        --seconds 4 --first-seed <n>

Prints one JSON line per seed and side, and a summary: for each number the
largest program reading and the smallest control reading. The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from h100bench import data, harness, judge, weights  # noqa: E402
from h100bench.reference import host, lowp  # noqa: E402
from h100bench.reference.model import Reference  # noqa: E402


def control_outputs(ref: Reference, image: np.ndarray, device):
    """The reference's own answer for one image in the control precision:
    mold-space detections [D, 6] and masks [D, 2m, 2m, C], as the program
    returns them."""
    cfg = ref.cfg
    d, m = cfg["detection_max_instances"], 2 * cfg["mask_pool_size"]
    molded = torch.from_numpy(host.mold(image, cfg["image_size"]).copy())[None].to(device)
    cands, levels, prior = ref.candidates(molded)
    idx = cands.detections
    dets = np.zeros((d, 6), np.float32)
    masks = np.zeros((d, m, m, cfg["num_classes"]), np.float32)
    n = int(idx.numel())
    dets[:n, :4] = cands.boxes[idx].cpu().numpy()
    dets[:n, 4] = cands.class_ids[idx].cpu().numpy()
    dets[:n, 5] = cands.scores[idx].cpu().numpy()
    if n:
        masks[:n, :, :, 1] = ref.masks_at(levels, prior, cands.boxes[idx]).cpu().numpy()
    return dets, masks


def control_numbers(name: str, seed: int, device, cfg_changes=None,
                    traffic_changes=None, precision: str = "fp8") -> dict:
    """The control's worst numbers for one seed: the cell's images and
    weights, its sample count, the reference in ``precision`` in the
    program's place."""
    cell = harness.workload(name)
    cfg = dict(harness.config_file(cell["config"]), **(cfg_changes or {}))
    traffic = dict(harness.traffic_file(cell["traffic"]), **(traffic_changes or {}))
    images = data.image_pool(seed, traffic["pool"], traffic["sizes"])
    calib = torch.from_numpy(host.mold(images[0], cfg["image_size"]).copy())[None]
    sd = weights.inference_weights(cfg, seed, calib.to(device), device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(cfg)
    ref.load_state_dict(sd)
    ref = ref.to(device)
    rng = np.random.default_rng([seed, 2])
    readings = []
    for i in rng.choice(len(images), traffic["samples"], replace=False):
        with lowp.precision(precision):
            dets, masks = control_outputs(ref, images[i], device)
        nums = judge.network_numbers(ref, images[i], dets, masks, device)
        nums["host_mismatch"] = 0.0
        readings.append(nums)
    return judge.worst(readings)


def train_control_numbers(name: str, seed: int, device, cfg_changes=None,
                          traffic_changes=None, precision: str = "fp8",
                          half: bool = False, bench=None) -> dict:
    """The training control for one seed: the cell's data, weights and
    loader, three of its batches with uniform draws from the seed, and the
    reference's three steps in ``precision`` (or with ``half`` of each
    batch left out) in the program's place, held to the float32
    reference's steps as the program is. ``bench`` lists the cell where
    BENCHMARK.json does not."""
    from sln_amodal_tpu_torch.data.dataset import AmodalDataset
    from sln_amodal_tpu_torch.data.pipeline import TrainLoader

    from h100bench.drivers import train

    cell = harness.workload(name, bench)
    cfg = dict(harness.config_file(cell["config"]), **(cfg_changes or {}))
    traffic = dict(harness.traffic_file(cell["traffic"]), **(traffic_changes or {}))
    config = harness.port_config(cfg).replace(batch_size=traffic["batch"])
    scratch = tempfile.mkdtemp(prefix="h100bench-")
    try:
        images = data.image_pool(seed, traffic["pool"], traffic["sizes"])
        data.write_train_set(scratch, images, seed, traffic["regions"])
        dataset = AmodalDataset()
        dataset.load_amodal(scratch, "train", data_type="COCO")
        dataset.prepare()
        calib = torch.from_numpy(host.mold(data.read_image(dataset.image_info[0]["path"]),
                                           cfg["image_size"]).copy())[None]
        sd = weights.training_weights(cfg, seed, calib.to(device), device)
        state = {k: v.cpu() for k, v in sd.items()}
        it = iter(TrainLoader(dataset, config, seed=seed))
        gen = torch.Generator().manual_seed(seed % 2 ** 63)
        p = cfg["post_nms_rois_training"]
        kept = [(next(it), tuple(torch.rand((2, traffic["batch"], p), generator=gen)), None)
                for _ in range(train.FOLLOWED)]
        it.close()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = train.reference_steps(cfg, state, kept, traffic["stage"], device)
    with lowp.precision(precision):
        got = train.reference_steps(cfg, state, kept, traffic["stage"], device, half=half)
    return dict(train.compare(state, got, want), loader_faults=0.0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--program", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    p.add_argument("--faults", type=int, default=0,
                   help="training: seeds of the planted half-batch fault")
    args = p.parse_args(argv)
    kind = harness.traffic_file(harness.workload(args.workload)["traffic"])["kind"]
    controlled = train_control_numbers if kind == "train" else control_numbers
    harness.set_cache_dirs()
    dev = torch.device("cuda")
    limits = harness.limits_file(args.workload)
    program, control, faults = [], [], []
    for k in range(args.program):
        seed = args.first_seed + k
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, t)
        nums = {n: c["value"] for n, c in r["checks"].items()}
        program.append(nums)
        print(json.dumps({"side": "program", "seed": seed, "correct": r["correct"],
                          "numbers": nums, "samples": r["samples"],
                          "metrics": r["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    for k in range(args.control):
        seed = args.first_seed + 1000 + k
        nums = controlled(args.workload, seed, dev)
        control.append(nums)
        print(json.dumps({"side": "control", "seed": seed,
                          "correct": judge.verdict(nums, limits), "numbers": nums}), flush=True)
        torch.cuda.empty_cache()
    for k in range(args.faults):
        seed = args.first_seed + 2000 + k
        nums = train_control_numbers(args.workload, seed, dev, precision="fp32", half=True)
        faults.append(nums)
        print(json.dumps({"side": "half_batch", "seed": seed,
                          "correct": judge.verdict(nums, limits), "numbers": nums}), flush=True)
        torch.cuda.empty_cache()
    summary = {}
    for n in sorted({k for x in program + control for k in x}):
        lo = [x[n] for x in program if x.get(n) is not None]
        hi = [x[n] for x in control if x.get(n) is not None]
        fl = [x[n] for x in faults if x.get(n) is not None]
        summary[n] = {"program_max": max(lo) if lo else None,
                      "control_min": min(hi) if hi else None,
                      "half_batch_min": min(fl) if fl else None}
    print(json.dumps({"summary": summary, "card": harness.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
