"""One-command real-weights AP parity check of the port (BASELINE.md
targets 1-2), the counterpart of the JAX package's ``scripts/run_parity.py``.

The north-star gate — the released ``COCOA.pth``/``D2SA.pth`` score within
0.5 AP points of the reference on the real dataset — needs weights and
data that are not in the repository; this command is that check as soon as
they are:

    python -m sln_amodal_tpu_torch.cli.run_parity \\
        --model /path/COCOA.pth --glm_weights /path/deeplabv2.pth \\
        --dataset /path/to/cocoa --data_type COCOA \\
        --ref_stats /path/reference_sweep.json [--gate 0.5]

Pipeline: load the reference ``.pth`` (``train/checkpoint.py::load_weights``,
with the standalone ``deeplabv2.pth`` under ``GLM_modual.``) → the full
inference and 12-way evaluation sweep of ``cli.train evaluate``
(``cli/train.py::run_evaluate``) → every sweep slice compared with the
reference's numbers and a verdict against the gate.

``--ref_stats`` is a JSON mapping sweep slices to stat arrays, e.g.
``{"both/all": [0.312, ...], "things/all": [...]}``; partial maps are fine
(only the slices given are compared).

``--dry_run DIR`` needs no weights or data: it writes a synthetic ``val``
set of ``--limit`` images (3 by default) in DIR, the detection-biased
weights in the two forms the real run loads (the ``.pth`` that ``cli.train
train`` saves, GLM inside; and the release layout, that ``.pth`` without
the ``GLM_modual.*`` keys beside a standalone ``deeplabv2.pth``), and runs
the sweep on each; the two must agree to delta 0.

Runs on the card (``--device cuda``, the default; it raises without one)
in the ``Config`` default dtypes, bfloat16 compute with float32 parameters;
``--device cpu`` runs the plain path.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from ..config import Config, inference_config
from ..device import resolve_device
from ..train import checkpoint as ckpt
from ..utils.synthetic import biased_pair, detection_biased_init, make_synthetic_dataset
from . import train as cli

Sweep = Dict[str, List[float]]
STAT_NAMES = ("AP", "AP50", "AP75", "AR@1", "AR@10", "AR@100")


def eval_args(model: str, glm: str, dataset: str, data_type: str, limit: int,
              image_size: int, eval_batch: int, device: str) -> argparse.Namespace:
    """``cli.train evaluate``'s arguments for one sweep."""
    return cli.build_parser().parse_args([
        "evaluate", "--model", model, "--glm_weights", glm or "", "--dataset", dataset,
        "--data_type", data_type, "--limit", str(limit), "--image_size", str(image_size),
        "--eval_batch", str(eval_batch), "--device", device])


def run_sweep(model: str, glm: str, dataset: str, data_type: str, limit: int = 0,
              image_size: int = 1024, eval_batch: int = 8, device: str = "cuda",
              config: Optional[Config] = None) -> Sweep:
    """``cli.train evaluate``'s 12-way sweep as {slice: [AP, AP50, AP75,
    AR@1, AR@10, AR@100]}; ``config`` replaces the CLI's full-width one."""
    ev = cli.run_evaluate(eval_args(model, glm, dataset, data_type, limit, image_size,
                                    eval_batch, device), config=config)
    if ev.stats is None:
        raise SystemExit("evaluation produced no detections — wrong weights?")
    return {k: [float(x) for x in v] for k, v in ev.stats.items()}


def compare(ours: Sweep, ref: Sweep, gate: float) -> bool:
    """Print per-slice AP deltas; True iff every compared stat is within
    ``gate`` points (both sides in fractions)."""
    ok = True
    print(f"\n{'slice':<24} {'ours':>8} {'ref':>8} {'delta':>8}  gate ±{gate}")
    for key, ref_stats in sorted(ref.items()):
        if key not in ours:
            print(f"{key:<24} {'—':>8} (no such sweep slice here) MISSING")
            ok = False
            continue
        for i in range(min(len(ref_stats), len(ours[key]))):
            delta = (ours[key][i] - ref_stats[i]) * 100.0  # AP points
            verdict = "ok" if abs(delta) <= gate else "FAIL"
            if verdict == "FAIL":
                ok = False
            print(f"{key + ':' + STAT_NAMES[i]:<24} {ours[key][i] * 100:8.2f} "
                  f"{ref_stats[i] * 100:8.2f} {delta:+8.2f}  {verdict}")
    return ok


class DryRun(NamedTuple):
    native: Sweep                     # the .pth with its GLM inside
    release: Sweep                    # the release layout: .pth + deeplabv2.pth
    seconds: List[float]              # wall time of each sweep (native, release)
    dataset: str
    native_path: str
    release_path: str
    glm_path: str


def write_release_layout(state_dict, out_dir: str):
    """The reference's release files: the model ``.pth`` without the
    ``GLM_modual.*`` keys and the standalone ``deeplabv2.pth`` (those keys
    without the prefix, which ``load_weights`` adds back). Returns both
    paths."""
    os.makedirs(out_dir, exist_ok=True)
    prefix = ckpt.GLM_PREFIX
    model_path = os.path.join(out_dir, "COCOA.pth")
    glm_path = os.path.join(out_dir, "deeplabv2.pth")
    torch.save({k: v for k, v in state_dict.items() if not k.startswith(prefix)}, model_path)
    torch.save({k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)},
               glm_path)
    if any(k.startswith(prefix) for k in ckpt.read_state_dict(model_path)):
        raise AssertionError(f"{model_path} holds {prefix}* keys")
    return model_path, glm_path


def dry_run(workdir: str, config: Optional[Config] = None, n_images: int = 3,
            eval_batch: int = 2, device: str = "cuda") -> DryRun:
    """No-weights rehearsal: the detection-biased weights of ``config``
    (default: the full-width ``inference_config()``), saved as ``cli.train
    train`` saves them and in the release layout, must give the same sweep
    on a synthetic set whose regions sit on the weights' detections, and a
    nonzero one (``both/all`` AR@100 > 0)."""
    config = config or inference_config(name="cocoa")
    os.makedirs(workdir, exist_ok=True)
    ds_root = make_synthetic_dataset(os.path.join(workdir, "ds"), n_images=n_images,
                                     size=config.image_size, subset="val",
                                     regions=biased_pair(config))
    state_dict = detection_biased_init(config)
    native = ckpt.save(state_dict, workdir, "parity", 1)
    release, glm = write_release_layout(state_dict, os.path.join(workdir, "release"))

    sweeps, seconds = [], []
    for model, glm_path in ((native, ""), (release, glm)):
        t = time.perf_counter()
        sweeps.append(run_sweep(model, glm_path, ds_root, "COCOA", image_size=config.image_size,
                                eval_batch=eval_batch, device=device, config=config))
        seconds.append(time.perf_counter() - t)
    if not compare(sweeps[1], sweeps[0], gate=0.0):
        raise SystemExit("dry run FAILED: the release layout changed the sweep")
    if sweeps[0]["both/all"][5] <= 0:
        raise SystemExit("dry run FAILED: both/all AR@100 is 0 (the masks did not survive "
                         "the unmold, or the regions miss the detections)")
    print("\ndry run OK: the .pth and the release layout (.pth + deeplabv2.pth) give "
          "identical sweeps")
    return DryRun(sweeps[0], sweeps[1], seconds, ds_root, native, release, glm)


def main(argv=None):
    """Runs the check; returns the :class:`DryRun` of ``--dry_run``, else
    our sweep. Exits 1 when a compared stat misses the gate."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", help="reference COCOA.pth / D2SA.pth")
    ap.add_argument("--glm_weights", default="", help="deeplabv2.pth")
    ap.add_argument("--dataset", help="dataset root (val subset)")
    ap.add_argument("--data_type", default="COCOA", choices=["COCOA", "D2SA"])
    ap.add_argument("--ref_stats", default=None,
                    help="JSON {sweep_slice: [AP, AP50, ...]} from the reference run")
    ap.add_argument("--gate", type=float, default=0.5,
                    help="max |AP delta| in points (BASELINE.md: 0.5)")
    ap.add_argument("--limit", type=int, default=0,
                    help="images to evaluate (0 = all); with --dry_run, the synthetic "
                         "images written (default 3)")
    ap.add_argument("--image_size", type=int, default=1024)
    ap.add_argument("--eval_batch", type=int, default=8)
    ap.add_argument("--save_stats", default=None,
                    help="write our sweep stats JSON here (the --ref_stats input of "
                         "cross-checking runs)")
    ap.add_argument("--dry_run", default=None, metavar="DIR",
                    help="no-weights rehearsal in DIR (synthetic data, biased weights "
                         "in both checkpoint layouts; gate 0)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # no card and no --device cpu: raise before any work

    if args.dry_run:
        return dry_run(args.dry_run, inference_config(image_size=args.image_size, name="cocoa"),
                       n_images=args.limit or 3, eval_batch=args.eval_batch,
                       device=args.device)
    if not args.model or not args.dataset:
        ap.error("--model and --dataset are required (or use --dry_run DIR)")

    ours = run_sweep(args.model, args.glm_weights, args.dataset, args.data_type, args.limit,
                     args.image_size, args.eval_batch, args.device)
    if args.save_stats:
        with open(args.save_stats, "w") as f:
            json.dump(ours, f, indent=1)
        print(f"sweep stats written to {args.save_stats}")
    if args.ref_stats:
        with open(args.ref_stats) as f:
            ref = json.load(f)
        if not compare(ours, ref, args.gate):
            raise SystemExit(1)
        print(f"\nPARITY OK: every compared stat within {args.gate} AP points")
    elif not args.save_stats:
        print("(no --ref_stats given — nothing to compare; use --save_stats to record "
              "this run)")
    return ours


if __name__ == "__main__":
    main()
