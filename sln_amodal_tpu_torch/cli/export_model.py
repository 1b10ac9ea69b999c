"""Export a checkpoint as a serving artifact (``torch.export``).

Usage:
    python -m sln_amodal_tpu_torch.cli.export_model \\
        --model ./checkpoints/COCOA.pth --out ./artifacts/cocoa_b8 \\
        --batch 8 [--image_size 1024] [--full] [--mesh N] [--device cuda]

The artifact directory (``model.pt2`` with the weights inside, and
``manifest.json``) is loaded with
``sln_amodal_tpu_torch.serve.ServingDetector.load(dir)``: no model code and
no checkpoint handling on the serving host. See ``serve/export.py`` for the
format. The port's counterpart of the JAX package's ``cli/export_model.py``;
``--device`` (the card by default) takes the place of its ``--platforms``.
The graph is exported in the ``Config`` default dtypes (bfloat16 compute,
float32 parameters; the weights are stored as the graph uses them, in
bfloat16), as the JAX package's CLI exports.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..config import inference_config
from ..convert import init_params
from ..parallel.mesh import make_mesh
from ..serve.export import export_detector
from ..train import checkpoint as ckpt
from ..utils.logging import log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a serving artifact of the PyTorch port.")
    p.add_argument("--model", required=True,
                   help="reference .pth path, or 'random' (seeded weights)")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--batch", type=int, default=8,
                   help="static serving batch size (smaller requests are padded up by "
                        "the loader)")
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--glm_weights", default="./checkpoints/deeplabv2.pth")
    p.add_argument("--full", action="store_true",
                   help="export the full contract incl. the GLM global label "
                        "(default: the detect() contract)")
    p.add_argument("--mesh", type=int, default=0,
                   help="export the per-replica program of a data-parallel artifact "
                        "over this many devices (the first cards; on --device cpu, the "
                        "CPU that many times); 0 = one device")
    p.add_argument("--seed", type=int, default=0, help="seed of 'random' weights")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu': the device "
                        "type the artifact serves on")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    config = inference_config(image_size=args.image_size)
    template = init_params(config, seed=args.seed, device=args.device)
    if args.model.lower() == "random":
        state_dict = template
    else:
        glm = args.glm_weights if os.path.exists(args.glm_weights) else None
        state_dict = ckpt.load_weights(args.model, template, glm_path=glm)
    mesh = None
    if args.mesh > 1:
        if torch.device(args.device).type == "cpu":
            mesh = make_mesh([args.device] * args.mesh)
        else:
            mesh = make_mesh()[: args.mesh]
            if len(mesh) < args.mesh:
                raise ValueError(f"--mesh {args.mesh}: only {len(mesh)} card(s) available")
    out = export_detector(config, state_dict, args.out, batch=args.batch,
                          detect_only=not args.full, device=args.device, mesh=mesh)
    log(f"Exported serving artifact → {out} "
        f"(batch {args.batch}, image {args.image_size}², "
        f"{'full' if args.full else 'detect-only'}"
        f"{f', {args.mesh}-device mesh' if mesh is not None else ''})")
    return out


if __name__ == "__main__":
    main()
