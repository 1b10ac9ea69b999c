"""Batch > 1 training soak of the port, the counterpart of the JAX
package's ``scripts/train_soak.py``.

Writes a synthetic 1024² COCOA-style training set (8 images with their
sem-dist maps), then runs one heads-stage epoch at the requested batch size
through the real pipeline (the host ``TrainLoader``, or with
``--device_prep`` the ``DevicePrepLoader`` that builds the targets on the
device, feeding ``Trainer.train_stage``), from the seeded init, and
asserts finite losses. Prints the ``SOAK OK`` line with the median step
time from step 2 on (the spacing of the steps' ends on the device, by CUDA
events; on the CPU by the host clock).

Usage:
    python -m sln_amodal_tpu_torch.cli.train_soak [--batch 8] [--steps 50] \\
        [--size 1024] [--device_prep] [--root DIR] [--device cuda]

Runs on the card (``--device cuda``, the default; it raises without one)
in the ``Config`` default dtypes, bfloat16 compute with float32 parameters.
``build_soak_pipeline`` is the pipeline a benchmark of the batch-8 train
step times.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import tempfile
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config, training_config
from ..convert import init_params
from ..data.dataset import AmodalDataset
from ..data.device_prep import DevicePrepLoader
from ..data.pipeline import TrainLoader
from ..device import resolve_device
from ..train.trainer import Trainer
from ..utils.synthetic import make_synthetic_dataset


def build_soak_pipeline(batch: int = 8, size: int = 1024, device_prep: bool = False,
                        root: Optional[str] = None, config: Optional[Config] = None,
                        device="cuda"):
    """(trainer, loader, config) of the soak: 8 synthetic images under
    ``root`` (default: a new temporary directory), ``config`` (default
    ``training_config`` at ``size``² and ``batch``), a ``Trainer`` from the
    seeded init on ``device``, and the real loader of ``batch`` images
    (``TrainLoader``, or ``DevicePrepLoader`` on ``device`` with
    ``device_prep``)."""
    config = config or training_config(image_size=size, batch_size=batch, name="soak")
    root = root or tempfile.mkdtemp(prefix="soak_ds_")
    make_synthetic_dataset(root, n_images=8, size=config.image_size)
    dataset = AmodalDataset()
    dataset.load_amodal(root, "train")
    dataset.prepare()
    trainer = Trainer(config, init_params(config, seed=0, device=device), device=device)
    if device_prep:
        loader = DevicePrepLoader(dataset, config, batch_size=batch, seed=0, device=device)
    else:
        loader = TrainLoader(dataset, config, batch_size=batch, seed=0)
    return trainer, loader, config


class Soak(NamedTuple):
    last_losses: Dict[str, float]     # the last logged step's
    step_ms: List[float]              # steps 2.. (end of the step before to its end)
    median_step_ms: float
    wall_s: float                     # the whole stage, its first step included


def marked(loader, mark: Callable[[], None]) -> Iterator:
    """``loader``'s batches, calling ``mark`` as each batch after the first
    is requested: ``train_stage`` requests batch i + 1 right after it has
    enqueued step i, so the marks are the steps' ends."""
    first = True
    for batch in loader:
        if not first:
            mark()
        first = False
        yield batch


def soak(trainer: Trainer, loader, config: Config, steps: int) -> Soak:
    """One heads epoch of ``steps`` steps; raises unless the last logged
    losses are finite."""
    cuda = trainer.device.type == "cuda"
    marks: list = []

    def mark():
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    t = time.perf_counter()
    last = trainer.train_stage(marked(loader, mark), "heads", config.learning_rate, epochs=1,
                               steps_per_epoch=steps)
    mark()
    if cuda:
        torch.cuda.synchronize(trainer.device)
    wall = time.perf_counter() - t
    if not all(np.isfinite(v) for v in last.values()):
        raise AssertionError(f"soak: a last loss is not finite: {last}")
    step_ms = [(a.elapsed_time(b) if cuda else (b - a) * 1e3)
               for a, b in zip(marks, marks[1:])]
    return Soak(last, step_ms, statistics.median(step_ms) if step_ms else float("nan"), wall)


def main(argv=None) -> Soak:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--root", default=None,
                    help="where to write the synthetic set (default: a temporary "
                         "directory, removed after)")
    ap.add_argument("--device_prep", action="store_true",
                    help="use DevicePrepLoader (the targets built on --device)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    with contextlib.ExitStack() as stack:
        root = args.root or stack.enter_context(tempfile.TemporaryDirectory(prefix="soak_ds_"))
        trainer, loader, config = build_soak_pipeline(
            batch=args.batch, size=args.size, device_prep=args.device_prep, root=root,
            device=args.device)
        out = soak(trainer, loader, config, args.steps)
    clock = "CUDA events" if trainer.device.type == "cuda" else "host clock"
    print(f"SOAK OK: batch={args.batch} steps={args.steps} size={config.image_size} "
          f"final_total={out.last_losses['total']:.4f} wall={out.wall_s:.1f}s "
          f"(~{out.wall_s / args.steps * 1e3:.0f} ms/step incl. the first step) "
          f"median_step_ms={out.median_step_ms:.1f} (steps 2-{args.steps}, {clock})")
    return out


if __name__ == "__main__":
    main()
