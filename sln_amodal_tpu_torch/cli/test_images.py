"""Single-image inference CLI of the port (the reference ``amodal_test.py``):
detection over every image in a directory, one pickled result dict per
image.

Usage:
    python -m sln_amodal_tpu_torch.cli.test_images --images ./images \\
        --model ./checkpoints/COCOA.pth --out ./results

Runs on the card (``--device cuda``, the default) in the ``Config`` default
dtypes: bfloat16 compute, float32 parameters.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import List

import numpy as np
from PIL import Image

from ..config import inference_config
from ..convert import init_params
from ..infer import Detector
from ..train import checkpoint as ckpt
from ..utils.logging import log


def main(argv=None) -> List[str]:
    """Returns the paths written."""
    p = argparse.ArgumentParser(
        description="Detect amodal instances in every image of a directory.")
    p.add_argument("--images", required=True, help="directory of images")
    p.add_argument("--model", required=False, help="reference .pth path")
    p.add_argument("--glm_weights", default="./checkpoints/deeplabv2.pth")
    p.add_argument("--out", default="./results")
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    config = inference_config(image_size=args.image_size)
    weights = init_params(config, seed=0, device=args.device)
    if args.model and os.path.exists(args.model):
        glm = args.glm_weights if os.path.exists(args.glm_weights) else None
        weights = ckpt.load_weights(args.model, weights, glm_path=glm)
        log(f"Loaded weights {args.model}")
    detector = Detector(config, weights, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    names = sorted(f for f in os.listdir(args.images)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    written = []
    for name in names:
        image = np.asarray(Image.open(os.path.join(args.images, name)).convert("RGB"))
        r = detector.detect([image])[0]
        out_path = os.path.join(args.out, os.path.splitext(name)[0] + ".json")
        # the reference pickles the result dict (amodal_test.py:61-63)
        with open(out_path, "wb") as f:
            pickle.dump({k: r[k] for k in ("rois", "class_ids", "scores", "masks")}, f)
        log(f"{name}: {len(r['scores'])} detections → {out_path}")
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
