"""COCO-amodal dataset containers (no pycocotools dependency).

Covers the reference's data access layer:

- :class:`AmodalCoco` — the annotation container the evaluator consumes
  (the role of the vendored ``pycocotools.coco.COCO`` + the region indexing
  of ``AmodalDataset.load_amodal``, ``amodal_train.py:72-172``);
- :class:`AmodalDataset` — the training/eval dataset: image registry,
  image loading, sem-dist ``.npz`` layer decode (``load_layers`` ≙
  ``load_layer2``, amodal_train.py:236-271), polygon/RLE instance masks
  (``load_mask``, amodal_train.py:292-354);
- :class:`DetectionResults` — ``COCO.loadRes`` equivalent for detection
  dicts produced by :func:`sln_amodal_tpu_torch.eval_amodal.coco_results.build_coco_results`.

Annotation JSON layout (``{data_type}_amodal_{subset}{year}.json``): each
image has one annotation carrying ``regions``: a list of region dicts with
``segmentation`` (polygon list or RLE), optional ``visible_mask`` /
``invisible_mask`` (RLE), ``isStuff``, ``occlude_rate``, ``order``.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image, ImageDraw

from ..eval_amodal import rle as rle_api
from . import semdist


class AmodalCoco:
    """Minimal COCO-style container over an amodal annotation JSON."""

    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[dict] = None):
        if dataset is None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.imgs: Dict[int, dict] = {}
        self.anns: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = {}
        self.regions: List[dict] = []
        self._index()

    def _index(self) -> None:
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)
            for region in ann.get("regions", []):
                region["image_id"] = ann["image_id"]
                self.regions.append(region)

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def get_ann_ids(self, img_ids=None) -> List[int]:
        if not img_ids:
            return list(self.anns.keys())
        lists = [self.img_to_anns.get(i, []) for i in img_ids]
        return [a["id"] for a in itertools.chain.from_iterable(lists)]

    def load_anns(self, ids) -> List[dict]:
        return [self.anns[i] for i in ids]

    # pycocotools-compatible aliases used by evaluator code
    getImgIds = get_img_ids
    getAnnIds = get_ann_ids
    loadAnns = load_anns


class DetectionResults:
    """Container for detection result dicts (COCO ``loadRes`` semantics:
    sequential ids, area from segmentation)."""

    def __init__(self, results: List[dict]):
        self.anns: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = {}
        for i, res in enumerate(results):
            ann = dict(res)
            ann["id"] = i + 1
            if "area" not in ann and "segmentation" in ann:
                ann["area"] = float(rle_api.area(ann["segmentation"]))
            ann.setdefault("category_id", 1)
            self.anns[ann["id"]] = ann
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    def get_ann_ids(self, img_ids=None) -> List[int]:
        if not img_ids:
            return list(self.anns.keys())
        out = []
        for i in img_ids:
            out.extend(a["id"] for a in self.img_to_anns.get(i, []))
        return out

    def load_anns(self, ids) -> List[dict]:
        return [self.anns[i] for i in ids]

    getAnnIds = get_ann_ids
    loadAnns = load_anns


def polygon_to_mask(seg: List[float], width: int, height: int) -> np.ndarray:
    """Rasterize one polygon with PIL (the reference's getAnnMask path,
    amodal_train.py:177-194)."""
    img = Image.new("L", (width, height))
    ImageDraw.Draw(img).polygon([float(v) for v in seg], fill=255)
    return np.asarray(img, dtype=bool)


def region_mask(region: dict, width: int, height: int) -> np.ndarray:
    """Amodal mask of a region: polygon or RLE."""
    seg = region["segmentation"]
    if isinstance(seg, list):
        return polygon_to_mask(seg, width, height)
    seg = dict(seg)
    if isinstance(seg.get("counts"), str):
        seg["counts"] = seg["counts"].encode()
    return rle_api.decode(seg).astype(bool)


class AmodalDataset:
    """Training / evaluation dataset over a COCO-amodal directory layout:

    ``{root}/annotations/{data_type}_amodal_{subset}{year}.json`` and images
    (with sibling ``.npz`` sem-dist maps) in ``{root}/{subset}{year}/``.
    """

    def __init__(self):
        self.image_info: List[dict] = []
        self.coco: Optional[AmodalCoco] = None
        self.class_names = ["BG", "foreground"]

    # ----------------------------------------------------------- loading --

    def load_amodal(self, dataset_dir: str, subset: str, data_type: str = "COCO",
                    year: str = "2014") -> AmodalCoco:
        path = os.path.join(
            dataset_dir, "annotations", f"{data_type}_amodal_{subset}{year}.json"
        )
        coco = AmodalCoco(path)
        if subset in ("minival", "valminusminival"):
            subset = "val"
        image_dir = os.path.join(dataset_dir, f"{subset}{year}")
        for i in sorted(coco.imgs.keys()):
            info = coco.imgs[i]
            self.image_info.append(
                dict(
                    id=i,
                    path=os.path.join(image_dir, info["file_name"]),
                    width=info["width"],
                    height=info["height"],
                    annotations=coco.img_to_anns.get(i, []),
                )
            )
        self.coco = coco
        return coco

    def prepare(self) -> None:
        self.num_images = len(self.image_info)
        self._image_ids = np.arange(self.num_images)

    @property
    def image_ids(self):
        return self._image_ids

    def load_image(self, image_id: int) -> np.ndarray:
        img = Image.open(self.image_info[image_id]["path"])
        img = img.convert("RGB")
        return np.asarray(img)

    def load_layers(self, image_id: int, num_layers: int):
        """Per-instance occlusion-layer masks from the sibling ``.npz``
        sem-dist map. Returns ([H, W, L, N] bool, class_ids [N])."""
        info = self.image_info[image_id]
        layer = semdist.load_layer_file(info["path"][:-4] + ".npz")
        return semdist.decode_layer_masks(layer, num_layers)

    def load_layers_legacy(self, image_id: int):
        """Legacy pickle ``<image>.layer`` sem-dist loader → per-instance
        (amodal, class_ids, vis, invis) (the reference ``load_layer``,
        amodal_train.py:196-234; superseded by the ``.npz`` format)."""
        import pickle

        info = self.image_info[image_id]
        with open(info["path"][:-4] + ".layer", "rb") as f:
            layer = pickle.load(f)
        return semdist.decode_instance_masks(np.asarray(layer, np.uint64))

    def load_mask(self, image_id: int):
        """Amodal/visible/invisible instance masks from region annotations.

        Returns (amodal [H,W,N], class_ids [N], vis [H,W,N], invis [H,W,N]).
        """
        info = self.image_info[image_id]
        h, w = info["height"], info["width"]
        amodal, vis, invis, class_ids = [], [], [], []
        anns = info["annotations"]
        regions = anns[0]["regions"] if anns else []
        for region in regions:
            m = region_mask(region, w, h)
            if not m.any():
                continue
            if "invisible_mask" in region:
                seg = dict(region["invisible_mask"])
                if isinstance(seg.get("counts"), str):
                    seg["counts"] = seg["counts"].encode()
                im = rle_api.decode(seg).astype(bool)
            else:
                im = np.zeros((h, w), bool)
            amodal.append(m)
            invis.append(im)
            vis.append(m & ~im)
            class_ids.append(1)
        if not class_ids:
            e = np.zeros((h, w, 0), bool)
            return e, np.zeros((0,), np.int32), e.copy(), e.copy()
        return (
            np.stack(amodal, axis=2),
            np.asarray(class_ids, np.int32),
            np.stack(vis, axis=2),
            np.stack(invis, axis=2),
        )

    def source_image_link(self, image_id: int) -> str:
        return self.image_info[image_id]["path"]
