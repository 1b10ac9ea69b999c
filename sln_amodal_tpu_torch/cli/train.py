"""Train / evaluate CLI of the port: the reference ``amodal_train.py``
surface (``amodal_train.py:507-675``), as the JAX package's ``cli/train.py``.

Usage:
    python -m sln_amodal_tpu_torch.cli.train train --dataset /path/coco_amodal \\
        --model coco --data_type COCOA [--stage heads --epochs 2]
    python -m sln_amodal_tpu_torch.cli.train evaluate --dataset /path/coco_amodal \\
        --model ./checkpoints/COCOA.pth --data_type COCOA --limit 100

Both run on the card (``--device cuda``, the default) in the ``Config``
default dtypes, as the JAX package's CLI: bfloat16 compute with float32
parameters, gradients and optimizer state. ``train`` runs the
reference's three-stage schedule, or one ``--stage`` for ``--epochs``, and
saves a reference-layout ``.pth`` (which ``evaluate`` loads) and a
``.pth.state`` resume file after every epoch; with ``--device_prep`` its
training and validation targets are built on ``--device``
(:class:`DevicePrepLoader`), as in the JAX package's CLI, which reads the
flag only in ``train``. ``evaluate --data_parallel`` splits each eval batch
over every local card (``Detector(mesh=...)``). Data-parallel training is
one process per card, each launched with ``--coordinator host:port
--num_processes N --process_id i``; each process uses card ``i`` modulo the
host's cards (unless ``--device cpu``), streams its slice of the dataset
and trains on ``--batch_size`` images per step, and process 0 writes the
checkpoints. ``--trace_dir DIR`` records the whole run with
``torch.profiler`` (``utils/profiling.py``; the card's kernels too on
``--device cuda``) and writes a Chrome / TensorBoard trace into DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config, inference_config, training_config
from ..convert import init_params
from ..data.dataset import AmodalCoco, AmodalDataset, DetectionResults
from ..data.device_prep import DevicePrepLoader
from ..data.pipeline import TrainLoader
from ..eval_amodal.amodal_eval import AmodalEval, evaluate_sweep
from ..eval_amodal.coco_results import build_coco_results_crops
from ..infer import Detector, PendingDetect
from ..parallel import multihost
from ..parallel.mesh import make_mesh
from ..train import checkpoint as ckpt
from ..train.optim import StageSchedule
from ..train.trainer import Trainer
from ..utils import profiling
from ..utils.logging import log, print_network, progress_bar

DEFAULT_COCO_WEIGHTS = "./checkpoints/mask_rcnn_coco.pth"
DEFAULT_GLM_WEIGHTS = "./checkpoints/deeplabv2.pth"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train or evaluate SLN-Amodal with the PyTorch port.")
    p.add_argument("command", metavar="<command>", help="'train' or 'evaluate'")
    p.add_argument("--dataset", required=True, help="COCO-amodal dataset root")
    p.add_argument("--year", default="2014")
    p.add_argument("--model", required=False,
                   help="reference .pth path, 'coco', 'last', or 'random'")
    p.add_argument("--logs", default="./logs")
    p.add_argument("--limit", type=int, default=-1,
                   help="images for evaluation (-1 = all)")
    p.add_argument("--data_type", default="COCOA", choices=["COCOA", "D2SA"])
    p.add_argument("--glm_weights", default=DEFAULT_GLM_WEIGHTS)
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights that no checkpoint provides, of the "
                        "loader and of the target sampling")
    p.add_argument("--batch_size", type=int, default=1,
                   help="train: images per step of each process")
    p.add_argument("--steps_per_epoch", type=int, default=2500)
    p.add_argument("--sticky_freeze", action="store_true",
                   help="reproduce the reference's sticky layer freezing")
    p.add_argument("--stage", default=None,
                   help="train only this stage (heads/3+/4+/5+/all/mask) instead of "
                        "the three-stage schedule")
    p.add_argument("--epochs", type=int, default=1, help="epochs when --stage is given")
    p.add_argument("--validate_steps", type=int, default=0,
                   help="run N validation batches after each epoch")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in --logs: its weights, "
                        "and the momentum and step of its .state file (mid-stage)")
    p.add_argument("--eval_batch", type=int, default=8,
                   help="images per device batch during evaluation")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--data_parallel", action="store_true",
                   help="evaluate: shard each eval batch over ALL local "
                        "devices (data-parallel serving; detections are "
                        "identical to single-device, see test_torch_parallel)")
    p.add_argument("--device_prep", action="store_true",
                   help="build training targets (sem-dist decode, bboxes, RPN matching) "
                        "on --device instead of in host numpy; equivalence pinned by "
                        "tests/test_torch_device_prep.py")
    p.add_argument("--coordinator", default=None,
                   help="multi-process training: host:port of process 0 "
                        "(launch one process per card with --num_processes "
                        "and --process_id; gradients average over a "
                        "torch.distributed group, see parallel/multihost.py)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--trace_dir", default=None,
                   help="record the whole run with torch.profiler (host ops, and the "
                        "card's kernels on --device cuda) into this directory "
                        "(Chrome / TensorBoard trace; keep the run small: pair with "
                        "--limit or --steps_per_epoch)")
    return p


def refuse_unknown_command(args) -> None:
    """Exit non-zero on a command the CLI does not know."""
    if args.command not in ("train", "evaluate"):
        sys.exit(f"'{args.command}' is not recognized. Use 'train' or 'evaluate'")


def eval_config(args) -> Config:
    """The evaluation config at the model's full width (bfloat16 compute)."""
    return inference_config(image_size=args.image_size, name=args.data_type.lower())


def resolve_weights(args, config: Config, template):
    """The reference's weight selection: path | 'coco' | 'last' | the
    template (seeded init)."""
    model_path = args.model or ""
    if model_path.lower() == "coco":
        model_path = DEFAULT_COCO_WEIGHTS
    elif model_path.lower() == "last":
        model_path = ckpt.find_last(args.logs, config.name)[0] or ""
    if model_path and model_path.lower() != "random" and os.path.exists(model_path):
        log(f"Loading weights {model_path}")
        glm = args.glm_weights if os.path.exists(args.glm_weights) else None
        return ckpt.load_weights(model_path, template, glm_path=glm)
    if model_path and model_path.lower() != "random":
        log(f"Weight file not found: {model_path} — using random init")
    return template


def make_detector(args, config: Config) -> Detector:
    """The evaluate detector on ``--device``; with ``--data_parallel``, one
    replica on each local card (on ``--device cpu``: the CPU alone)."""
    template = init_params(config, seed=args.seed, device=args.device)
    mesh = None
    if args.data_parallel:
        cuda = torch.device(args.device).type == "cuda"
        mesh = make_mesh() if cuda else make_mesh([args.device])
        log(f"Data-parallel eval over {len(mesh)} device(s)")
    return Detector(config, resolve_weights(args, config, template), device=args.device,
                    mesh=mesh)


def load_eval_dataset(args):
    """(dataset, annotations, the dataset indices to evaluate)."""
    dataset = AmodalDataset()
    data_type = "COCO" if args.data_type == "COCOA" else "D2S"
    coco = dataset.load_amodal(args.dataset, "val", data_type=data_type, year=args.year)
    dataset.prepare()
    image_ids = dataset.image_ids
    if args.limit and args.limit > 0:
        image_ids = image_ids[: args.limit]
    return dataset, coco, [int(i) for i in image_ids]


def load_batch(dataset: AmodalDataset, chunk: List[int], batch_size: int) -> List[np.ndarray]:
    """The chunk's images, the last repeated up to ``batch_size``: every
    batch has the same shape."""
    images = [dataset.load_image(i) for i in chunk]
    return images + [images[-1]] * (batch_size - len(images))


def coco_results(detector: Detector, dataset: AmodalDataset, chunk: List[int],
                 pending: PendingDetect) -> List[dict]:
    """Wait for a dispatched batch; the result dicts of its real images, RLE
    encoded straight off each box crop."""
    results = []
    for image_id, r in zip(chunk, detector.collect_crops(pending)):
        results.extend(build_coco_results_crops(
            dataset.image_info[image_id]["id"], r["rois"], r["class_ids"],
            r["scores"], r["crops"], r["image_shape"]))
    return results


def predict(detector: Detector, dataset: AmodalDataset, image_ids: List[int],
            batch_size: int, progress: bool = True) -> List[dict]:
    """The software-pipelined loop: dispatch batch N, then unmold and encode
    batch N-1 on the host (the reference runs the two strictly in turn,
    ``amodal_train.py:463-497``)."""
    results: List[dict] = []
    pending = None
    done = 0
    for start in range(0, len(image_ids), batch_size):
        chunk = image_ids[start: start + batch_size]
        handle = detector.dispatch(load_batch(dataset, chunk, batch_size))
        if pending is not None:
            results.extend(coco_results(detector, dataset, *pending))
            done += len(pending[0])
            if progress:
                progress_bar(done, len(image_ids), prefix="eval")
        pending = (chunk, handle)
    if pending is not None:
        results.extend(coco_results(detector, dataset, *pending))
        if progress:
            progress_bar(len(image_ids), len(image_ids), prefix="eval")
    return results


def score(coco: AmodalCoco, dataset: AmodalDataset, image_ids: List[int],
          results: List[dict], data_type: str,
          verbose: bool = True) -> Optional[Dict[str, np.ndarray]]:
    """The 12-way amodal sweep of ``results`` over exactly ``image_ids``."""
    if not results:
        log("no detections produced")
        return None
    order_key = "order" if data_type == "COCOA" else "amodal_region.order"
    ev = AmodalEval(coco, DetectionResults(results), order_key=order_key)
    # the reference pins the evaluated ids to the detected images
    # (amodal_train.py:490); a bare [:limit] over JSON order could differ
    ev.params.img_ids = [dataset.image_info[i]["id"] for i in image_ids]
    return evaluate_sweep(ev, verbose=verbose)


class Evaluation(NamedTuple):
    results: List[dict]
    stats: Optional[Dict[str, np.ndarray]]
    seconds: float                    # wall time of the prediction loop


def run_evaluate(args, config: Optional[Config] = None) -> Evaluation:
    """The evaluate command; ``config`` (default :func:`eval_config`) lets a
    caller evaluate another configuration of the model."""
    config = config or eval_config(args)
    dataset, coco, image_ids = load_eval_dataset(args)
    detector = make_detector(args, config)
    t0 = time.perf_counter()
    results = predict(detector, dataset, image_ids, max(1, args.eval_batch))
    elapsed = time.perf_counter() - t0
    log(f"Prediction time: {elapsed:.1f}s — "
        f"{len(image_ids) / max(elapsed, 1e-9):.2f} images/s")
    return Evaluation(results, score(coco, dataset, image_ids, results, args.data_type),
                      elapsed)


def train_config(args) -> Config:
    """The training config at the model's full width (bfloat16 compute)."""
    return training_config(image_size=args.image_size, batch_size=args.batch_size,
                           steps_per_epoch=args.steps_per_epoch,
                           name=args.data_type.lower())


def load_train_dataset(args, subset: str) -> AmodalDataset:
    dataset = AmodalDataset()
    data_type = "COCO" if args.data_type == "COCOA" else "D2S"
    dataset.load_amodal(args.dataset, subset, data_type=data_type, year=args.year)
    dataset.prepare()
    return dataset


class Training(NamedTuple):
    trainer: Optional[Trainer]        # None when nothing was left to train
    checkpoints: List[str]            # the .pth written, in order


def run_train(args) -> Training:
    config = train_config(args)
    resume_epoch, resume_state_path = 0, None
    if args.resume:
        last_path, last_epoch = ckpt.find_last(args.logs, config.name)
        if last_path is not None:
            log(f"Resuming from {last_path} (epoch {last_epoch})")
            args.model = last_path
            resume_epoch = last_epoch
            if os.path.exists(last_path + ".state"):
                resume_state_path = last_path + ".state"
        else:
            log(f"--resume: no checkpoint under {args.logs}/{config.name} — starting fresh")

    # a resume at or past the end of the requested schedule trains nothing:
    # say so before loading weights or building loaders
    if args.stage:
        total_epochs, advice = args.epochs, "raise --epochs"
    else:
        total_epochs = sum(e for _, _, e in StageSchedule(config.learning_rate).stages)
        advice = "use --stage <stage> --epochs N"
    if resume_epoch >= total_epochs:
        log(f"--resume: checkpoint is at epoch {resume_epoch}, requested schedule ends "
            f"at epoch {total_epochs} — nothing left to train ({advice}, or start a "
            "fresh --logs dir)")
        return Training(None, [])

    train_ds = load_train_dataset(args, "train")
    template = init_params(config, seed=args.seed, device=args.device)
    state_dict = resolve_weights(args, config, template)
    print_network(state_dict, "sln_amodal")
    trainer = Trainer(config, state_dict, device=args.device)
    # each process streams its own slice of the data
    loader_cls = TrainLoader
    loader_kw = dict(process_index=multihost.process_index(),
                     process_count=multihost.process_count())
    if args.device_prep:
        loader_cls, loader_kw["device"] = DevicePrepLoader, args.device
    loader = loader_cls(train_ds, config, seed=args.seed, **loader_kw)
    val_loader = None
    if args.validate_steps > 0:
        val_loader = loader_cls(load_train_dataset(args, "val"), config,
                                seed=args.seed + 1, augment=False, **loader_kw)

    written: List[str] = []

    def save_epoch(epoch: int) -> None:
        # process 0 writes (two writers of one path race); the others wait
        path = ckpt.checkpoint_path(args.logs, config.name, epoch)
        if multihost.process_index() == 0:
            ckpt.save(trainer.model.state_dict(), args.logs, config.name, epoch)
            ckpt.save_train_state(trainer.model, trainer.optimizer, trainer.step, args.logs,
                                  config.name, epoch)
            log(f"checkpoint: {path}")
        multihost.barrier()
        written.append(path)
        if val_loader is not None:
            val = trainer.validate(val_loader, steps=args.validate_steps)
            log("  val " + " ".join(f"{k}={v:.4f}" for k, v in sorted(val.items())))

    if args.stage:
        trainer.epoch = resume_epoch
        trainer.train_stage(loader, args.stage, config.learning_rate, args.epochs,
                            steps_per_epoch=args.steps_per_epoch, seed=args.seed,
                            on_epoch_end=save_epoch, resume_state_path=resume_state_path,
                            start_epoch=resume_epoch)
    else:
        trainer.train(loader, steps_per_epoch=args.steps_per_epoch,
                      sticky_freeze=args.sticky_freeze, on_epoch_end=save_epoch,
                      resume_epoch=resume_epoch, resume_state_path=resume_state_path,
                      seed=args.seed)
    return Training(trainer, written)


def main(argv=None):
    """Runs the command; returns its :class:`Training` or :class:`Evaluation`."""
    args = build_parser().parse_args(argv)
    refuse_unknown_command(args)
    distributed = bool(args.num_processes and args.num_processes > 1)
    if distributed:
        # before anything touches a card: one process per card
        if torch.device(args.device).type == "cuda":
            args.device = str(multihost.local_device(args.process_id or 0))
        multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                             device=args.device)
        log(f"Multi-process: process {multihost.process_index()}/"
            f"{multihost.process_count()} on {args.device}")
    log(f"Command: {args.command}")
    log(f"Dataset: {args.dataset}")
    log(f"Model:   {args.model}")
    tracing = contextlib.nullcontext()
    if args.trace_dir:
        tracing = profiling.trace(args.trace_dir,
                                  cuda=torch.device(args.device).type == "cuda")
        log(f"Profiler trace → {args.trace_dir}")
    try:
        with tracing:
            if args.command == "train":
                return run_train(args)
            return run_evaluate(args)
    finally:
        if distributed:
            multihost.shutdown()


if __name__ == "__main__":
    main()
