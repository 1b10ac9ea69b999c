"""Evaluate CLI of the port: the reference ``amodal_train.py`` surface
(``amodal_train.py:507-675``) on :class:`sln_amodal_tpu_torch.infer.Detector`.

Usage:
    python -m sln_amodal_tpu_torch.cli.train evaluate --dataset /path/coco_amodal \\
        --model ./checkpoints/COCOA.pth --data_type COCOA --limit 100

It runs on the card (``--device cuda``, the default) in float32: the port
has no bfloat16 compute yet, so it does not follow the ``Config`` default
``compute_dtype="bfloat16"`` that the JAX package's CLI evaluates in.
The command ``train`` and the flags of later slices (``--data_parallel``,
``--device_prep``, ``--coordinator``, ``--trace_dir``) exit with an error
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from ..config import Config, inference_config
from ..convert import init_params
from ..data.dataset import AmodalCoco, AmodalDataset, DetectionResults
from ..eval_amodal.amodal_eval import AmodalEval, evaluate_sweep
from ..eval_amodal.coco_results import build_coco_results_crops
from ..infer import Detector, PendingDetect
from ..train import checkpoint as ckpt
from ..utils.logging import log, progress_bar

DEFAULT_COCO_WEIGHTS = "./checkpoints/mask_rcnn_coco.pth"
DEFAULT_GLM_WEIGHTS = "./checkpoints/deeplabv2.pth"

# what later slices of the port bring, by ROADMAP item
NOT_PORTED = {
    "train": "the command 'train' is ROADMAP item 11 (training slice)",
    "device_prep": "--device_prep is ROADMAP item 12 (data path)",
    "data_parallel": "--data_parallel is ROADMAP item 13 (data parallelism)",
    "coordinator": "--coordinator is ROADMAP item 13 (data parallelism)",
    "trace_dir": "--trace_dir is ROADMAP item 14 (serving and tooling)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate SLN-Amodal with the PyTorch port. Runs in float32 "
                    "(bfloat16 compute is not ported yet).")
    p.add_argument("command", metavar="<command>",
                   help="'evaluate' ('train' is not ported yet)")
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
                   help="seed of the weights that no checkpoint provides")
    p.add_argument("--eval_batch", type=int, default=8,
                   help="images per device batch during evaluation")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--data_parallel", action="store_true", help="not ported yet")
    p.add_argument("--device_prep", action="store_true", help="not ported yet")
    p.add_argument("--coordinator", default=None, help="not ported yet")
    p.add_argument("--trace_dir", default=None, help="not ported yet")
    return p


def refuse_unported(args) -> None:
    """Exit non-zero if ``args`` ask for something a later slice ports."""
    asked = [NOT_PORTED["train"]] if args.command == "train" else []
    asked += [msg for flag, msg in NOT_PORTED.items()
              if flag != "train" and getattr(args, flag)]
    if asked:
        sys.exit("not ported yet: " + "; ".join(asked))
    if args.command != "evaluate":
        sys.exit(f"'{args.command}' is not recognized. Use 'evaluate'")


def eval_config(args) -> Config:
    """The evaluation config at the model's full width, in float32."""
    return inference_config(image_size=args.image_size, name=args.data_type.lower(),
                            compute_dtype="float32", param_dtype="float32")


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
    template = init_params(config, seed=args.seed, device=args.device)
    return Detector(config, resolve_weights(args, config, template), device=args.device)


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


def run_evaluate(args) -> Evaluation:
    config = eval_config(args)
    dataset, coco, image_ids = load_eval_dataset(args)
    detector = make_detector(args, config)
    t0 = time.perf_counter()
    results = predict(detector, dataset, image_ids, max(1, args.eval_batch))
    elapsed = time.perf_counter() - t0
    log(f"Prediction time: {elapsed:.1f}s — "
        f"{len(image_ids) / max(elapsed, 1e-9):.2f} images/s")
    return Evaluation(results, score(coco, dataset, image_ids, results, args.data_type),
                      elapsed)


def main(argv=None) -> Evaluation:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    log(f"Command: {args.command}")
    log(f"Dataset: {args.dataset}")
    log(f"Model:   {args.model}")
    return run_evaluate(args)


if __name__ == "__main__":
    main()
