"""Dataset conversion tools of the port (the reference's conversion
notebooks, ``scripts/*.ipynb`` there), on the port's own dataset reader and
sem-dist codec:

- ``encode``: COCOA/D2SA amodal annotation JSON → per-image uint64 sem-dist
  ``.npz`` maps beside each image (the ``reLayerMask`` encoder flow), which
  the training loaders read (``--device_prep`` requires them);
- ``check``: decode a sample of ``.npz`` maps and compare their object
  counts with the annotations (the notebooks' "check file" cells);
- ``d2s_to_amodal``: raw D2S amodal annotation JSON (one flat annotation
  per object, carrying ``occl_depth``) → amodal-COCO region format (one
  annotation per image with depth-sorted ``regions[]``), the
  ``D2S TO Amodal COCO.ipynb`` flow.

Usage:
    python -m sln_amodal_tpu_torch.cli.convert_dataset encode --dataset /path/root \\
        --subset train --data_type COCO
    python -m sln_amodal_tpu_torch.cli.convert_dataset check --dataset /path/root \\
        --subset val
    python -m sln_amodal_tpu_torch.cli.convert_dataset d2s_to_amodal \\
        --ann /path/D2S_amodal_training_rot0.json \\
        --out /path/annotations/D2SA_amodal_train2014.json
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import numpy as np

from ..data import semdist
from ..data.dataset import AmodalDataset


def load_dataset(args) -> AmodalDataset:
    ds = AmodalDataset()
    ds.load_amodal(args.dataset, args.subset, data_type=args.data_type, year=args.year)
    ds.prepare()
    return ds


def encode(args) -> None:
    ds = load_dataset(args)
    for image_id in range(ds.num_images):
        info = ds.image_info[image_id]
        amodal, _, _, invis = ds.load_mask(image_id)
        n = amodal.shape[-1]
        label = semdist.encode_layer_map(
            [amodal[:, :, i] for i in range(n)],
            [invis[:, :, i] if invis[:, :, i].any() else None for i in range(n)],
            min_size=args.min_size,
        )
        out = info["path"][:-4] + ".npz"
        np.savez_compressed(out, layer=label)
        print(f"[{image_id + 1}/{ds.num_images}] {out} ({n} objects)")


def check(args) -> None:
    ds = load_dataset(args)
    n_check = min(args.limit, ds.num_images) if args.limit > 0 else ds.num_images
    bad = 0
    for image_id in range(n_check):
        path = ds.image_info[image_id]["path"][:-4] + ".npz"
        if not os.path.exists(path):
            print(f"MISSING {path}")
            bad += 1
            continue
        amodal, _, _, _ = semdist.decode_instance_masks(semdist.load_layer_file(path))
        n_dec, n_ann = amodal.shape[-1], ds.load_mask(image_id)[0].shape[-1]
        status = "ok"
        if n_dec != min(n_ann, 32):
            status = f"OBJECT-COUNT {n_dec} vs {n_ann}"
            bad += 1
        print(f"[{image_id + 1}/{n_check}] {os.path.basename(path)}: "
              f"{n_dec} decoded / {n_ann} annotated — {status}")
    print(f"checked {n_check}, problems: {bad}")
    if bad:
        sys.exit(1)


def d2s_to_amodal_dataset(dataset: dict) -> dict:
    """Raw D2S amodal dataset dict → amodal-COCO region format.

    The reference's ``D2S TO Amodal COCO.ipynb`` (cell 2): group the flat
    per-object annotations by ``image_id``, sort each group by
    ``occl_depth`` (depth 0 is frontmost: this order is the layer ground
    truth the D2SA evaluator matches against), and emit one annotation per
    image, ``{size, id, regions[], image_id}``. Region dicts pass through
    as they are; images, categories and info are kept."""
    by_image = collections.defaultdict(list)
    for ann in dataset["annotations"]:
        by_image[ann["image_id"]].append(ann)

    annotations = []
    for new_id, img_id in enumerate(sorted(by_image)):
        regions = sorted(by_image[img_id], key=lambda reg: reg["occl_depth"])
        annotations.append({
            "size": len(regions),
            "id": new_id,
            "regions": regions,
            "image_id": img_id,
        })
    out = dict(dataset)
    out["annotations"] = annotations
    return out


class NumpyEncoder(json.JSONEncoder):
    """Writes numpy scalars and arrays as JSON (notebook cell 3)."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def d2s_to_amodal(args) -> None:
    with open(args.ann) as f:
        dataset = json.load(f)
    out = d2s_to_amodal_dataset(dataset)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, cls=NumpyEncoder)
    print(f"{len(dataset['annotations'])} object annotations → "
          f"{len(out['annotations'])} image annotations → {args.out}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert amodal datasets for the port.")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("encode", encode), ("check", check)):
        sp = sub.add_parser(name)
        sp.add_argument("--dataset", required=True)
        sp.add_argument("--subset", default="train")
        sp.add_argument("--data_type", default="COCO")
        sp.add_argument("--year", default="2014")
        sp.add_argument("--min_size", type=int, default=64)
        sp.add_argument("--limit", type=int, default=-1)
        sp.set_defaults(fn=fn)
    sp = sub.add_parser("d2s_to_amodal")
    sp.add_argument("--ann", required=True,
                    help="raw D2S amodal annotation JSON (flat per-object)")
    sp.add_argument("--out", required=True,
                    help="output amodal-COCO region-format JSON")
    sp.set_defaults(fn=d2s_to_amodal)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
