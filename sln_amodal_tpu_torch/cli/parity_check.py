"""Inference parity harness of the port against the reference
implementation, the counterpart of the JAX package's
``scripts/parity_check.py``.

The reference's ``amodal_test.py`` pickles one result dict per image
(rois / class_ids / scores / masks; ``cli.test_images`` writes the same
format). Given a directory of those pickles, the same images and a
reference checkpoint, this runs the port's ``Detector`` on each image and
reports box, score and mask agreement: the BASELINE.md "mask-level bit
parity" gate, runnable as soon as the released checkpoints and datasets
are present. Exits 1 if any image is out of tolerance or missing, or if
nothing was compared.

Usage:
    python -m sln_amodal_tpu_torch.cli.parity_check --images ./images \\
        --model ./checkpoints/COCOA.pth --reference_results ./ref_results \\
        [--iou_tol 0.99] [--box_tol 1]

Runs on the card (``--device cuda``, the default; it raises without one)
in the ``Config`` default dtypes, bfloat16 compute with float32 parameters;
``--device cpu`` runs the plain path.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import Optional

import numpy as np
from PIL import Image

from ..config import inference_config
from ..convert import init_params
from ..device import resolve_device
from ..infer import Detector
from ..train import checkpoint as ckpt


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 1.0


def compare_image(ref: dict, got: dict, box_tol: float, iou_tol: float):
    """(issues, stats) of one image's detections against the reference's:
    the count, the largest box deviation in pixels, the largest score
    difference, and the masks (in order) below ``iou_tol``."""
    issues = []
    n_ref, n_got = len(ref["scores"]), len(got["scores"])
    n = min(n_ref, n_got)
    if n_ref != n_got:
        issues.append(f"detection count {n_got} vs reference {n_ref}")
    box_err = (np.abs(ref["rois"][:n].astype(np.int64) - got["rois"][:n].astype(np.int64)).max()
               if n else 0)
    if box_err > box_tol:
        issues.append(f"max box deviation {box_err}px > {box_tol}")
    score_err = (float(np.abs(np.asarray(ref["scores"][:n]) - np.asarray(got["scores"][:n])).max())
                 if n else 0.0)
    ious = [mask_iou(ref["masks"][:, :, i] > 0, got["masks"][:, :, i] > 0) for i in range(n)]
    bad = [i for i, v in enumerate(ious) if v < iou_tol]
    if bad:
        issues.append(f"{len(bad)}/{n} masks below IoU {iou_tol} (min {min(ious):.4f})")
    return issues, dict(n=n, box_err=int(box_err), score_err=score_err,
                        mean_mask_iou=float(np.mean(ious)) if ious else 1.0)


def find_image(images: str, stem: str) -> Optional[str]:
    for ext in (".jpg", ".jpeg", ".png"):
        path = os.path.join(images, stem + ext)
        if os.path.exists(path):
            return path
    return None


def main(argv=None) -> int:
    """Compares every reference pickle; returns the exit status: 1 if any
    image is out of tolerance or missing from ``--images``, or if there is
    no pickle to compare (where the JAX script skips a missing image and
    passes an empty directory), else 0."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--glm_weights", default="./checkpoints/deeplabv2.pth")
    p.add_argument("--reference_results", required=True,
                   help="dir of reference amodal_test.py pickles")
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--box_tol", type=float, default=1.0)
    p.add_argument("--iou_tol", type=float, default=0.99)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    resolve_device(args.device)

    config = inference_config(image_size=args.image_size)
    template = init_params(config, seed=0, device=args.device)
    glm = args.glm_weights if os.path.exists(args.glm_weights) else None
    detector = Detector(config, ckpt.load_weights(args.model, template, glm_path=glm),
                        device=args.device)

    names = sorted(f for f in os.listdir(args.reference_results) if f.endswith(".json"))
    failures = 0
    for name in names:
        stem = os.path.splitext(name)[0]
        image_path = find_image(args.images, stem)
        if image_path is None:
            print(f"{stem}: MISMATCH: image not found")
            failures += 1
            continue
        with open(os.path.join(args.reference_results, name), "rb") as f:
            ref = pickle.load(f)
        image = np.asarray(Image.open(image_path).convert("RGB"))
        got = detector.detect([image])[0]
        issues, stats = compare_image(ref, got, args.box_tol, args.iou_tol)
        status = "OK" if not issues else "MISMATCH: " + "; ".join(issues)
        print(f"{stem}: n={stats['n']} box_err={stats['box_err']} "
              f"mask_iou={stats['mean_mask_iou']:.4f} — {status}")
        failures += bool(issues)
    print(f"\n{len(names) - failures}/{len(names)} images within tolerance")
    return 1 if failures or not names else 0


if __name__ == "__main__":
    sys.exit(main())
