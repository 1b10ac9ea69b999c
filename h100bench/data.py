"""The cells' images, made from the seed: a pool of JPEGs at COCO frame
sizes (COCOA annotates COCO images), written with a COCO-amodal annotation
file so that the program's dataset loader reads them as it reads COCOA.

Each image is a smooth random field (a coarse random grid, bilinearly
upsampled, plus fine noise): JPEG sizes and decode times of photographs,
not of white noise. Every seed draws the same list of frame sizes in
another order, so that seeds change the content and not the work.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image


def frame_sizes(sizes: Sequence[Sequence[int]], n: int, rng) -> List[Tuple[int, int]]:
    """``n`` (height, width) pairs: ``sizes`` repeated in turn, then
    shuffled by ``rng``."""
    out = [tuple(sizes[i % len(sizes)]) for i in range(n)]
    order = rng.permutation(n)
    return [out[i] for i in order]


def smooth_image(rng, h: int, w: int) -> np.ndarray:
    coarse = rng.integers(0, 256, (max(2, h // 40), max(2, w // 40), 3)).astype(np.uint8)
    up = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.float32)
    return np.clip(up + rng.normal(0.0, 12.0, (h, w, 3)), 0, 255).astype(np.uint8)


def image_pool(seed: int, n: int, sizes) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [smooth_image(rng, h, w) for h, w in frame_sizes(sizes, n, rng)]


def write_coco_amodal(root: str, images: List[np.ndarray], subset: str = "val",
                      year: str = "2014", quality: int = 90) -> Dict:
    """JPEGs under ``root/{subset}{year}`` and an annotation file with no
    regions (evaluation's loader needs only the image records)."""
    img_dir = os.path.join(root, f"{subset}{year}")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    records = []
    for i, img in enumerate(images):
        name = f"img_{i + 1:05d}.jpg"
        Image.fromarray(img).save(os.path.join(img_dir, name), quality=quality)
        records.append({"id": i + 1, "file_name": name, "height": int(img.shape[0]),
                        "width": int(img.shape[1])})
    ann = {"images": records, "annotations": []}
    with open(os.path.join(root, "annotations", f"COCO_amodal_{subset}{year}.json"), "w") as f:
        json.dump(ann, f)
    return ann


def read_image(path: str) -> np.ndarray:
    """A JPEG decoded to RGB uint8, as a dataset loader reads it."""
    return np.asarray(Image.open(path).convert("RGB"))


def region_masks(rng, h: int, w: int, count: int) -> List[np.ndarray]:
    """``count`` elliptical object masks of 10-60% of the frame's side, in
    depth order: each later region occludes the earlier ones it covers."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(count):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(0.05, 0.3) * h, rng.uniform(0.05, 0.3) * w
        out.append(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0)
    return out


def semdist_map(amodal: List[np.ndarray]) -> np.ndarray:
    """The sem-dist uint64 map of depth-ordered amodal masks: bit i where
    object i is visible, bit 32 + i where a later object hides it."""
    label = np.zeros(amodal[0].shape, np.uint64)
    covered = np.zeros(amodal[0].shape, bool)
    for i in reversed(range(len(amodal))):
        hidden = amodal[i] & covered
        label[hidden] |= np.uint64(1) << np.uint64(i + 32)
        label[amodal[i] & ~covered] |= np.uint64(1) << np.uint64(i)
        covered |= amodal[i]
    return label


def write_train_set(root: str, images: List[np.ndarray], seed: int,
                    counts: Sequence[int], subset: str = "train",
                    year: str = "2014") -> List[List[np.ndarray]]:
    """The images as JPEGs with a sibling ``.npz`` sem-dist map each
    (``counts`` regions per image, in turn) and a COCO-amodal annotation
    file; returns each image's amodal masks in depth order."""
    rng = np.random.default_rng([seed, 3])
    write_coco_amodal(root, images, subset=subset, year=year)
    img_dir = os.path.join(root, f"{subset}{year}")
    masks = []
    for i, img in enumerate(images):
        amodal = region_masks(rng, img.shape[0], img.shape[1], counts[i % len(counts)])
        np.savez(os.path.join(img_dir, f"img_{i + 1:05d}.npz"), layer=semdist_map(amodal))
        masks.append(amodal)
    return masks
