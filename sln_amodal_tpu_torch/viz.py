"""Amodal annotation / result visualization (numpy + PIL): the port's copy
of the JAX package's ``viz.py``, on the port's own ``data/dataset.py`` and
RLE library.

Covers the reference's ``Amodal(COCO)`` visualizer capabilities
(``/root/reference/modal/amodal.py:22-363``) without cv2/matplotlib:

- :func:`show_amodal_anns` — depth-sorted rendering of all regions of an
  image's amodal annotation (back-to-front, like ``showAmodalAnns``);
- :func:`show_modal_instance` / :func:`show_amodal_instance` — single
  instance, visible-only or full amodal extent;
- :func:`overlay_detections` — detection masks + boxes + scores over the
  image (the qualitative-results role of ``results/``).

All functions return uint8 RGB arrays; pass ``path=`` to also save a PNG.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

from .data.dataset import region_mask
from .eval_amodal import rle as rle_api

_PALETTE = np.asarray(
    [
        (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
        (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
        (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255),
    ],
    np.uint8,
)


def _blend(image: np.ndarray, mask: np.ndarray, color, alpha: float = 0.5):
    out = image.copy()
    color = np.asarray(color, np.float32)
    region = mask.astype(bool)
    out[region] = (
        (1 - alpha) * out[region].astype(np.float32) + alpha * color
    ).astype(np.uint8)
    return out


def _maybe_save(arr: np.ndarray, path: Optional[str]):
    if path:
        Image.fromarray(arr).save(path)
    return arr


def show_amodal_anns(image: np.ndarray, regions: Sequence[dict],
                     alpha: float = 0.5, path: Optional[str] = None) -> np.ndarray:
    """Depth-sorted amodal rendering: paint regions back-to-front by their
    ``order`` so nearer objects overwrite farther ones."""
    h, w = image.shape[:2]
    out = image.copy()
    ordered = sorted(regions, key=lambda r: -int(r.get("order", 0)))
    for i, region in enumerate(ordered):
        m = region_mask(region, w, h)
        out = _blend(out, m, _PALETTE[i % len(_PALETTE)], alpha)
    return _maybe_save(out, path)


def show_modal_instance(image: np.ndarray, region: dict, color=(0, 200, 60),
                        path: Optional[str] = None) -> np.ndarray:
    """Visible (modal) part of one instance."""
    h, w = image.shape[:2]
    if "visible_mask" in region:
        seg = dict(region["visible_mask"])
        if isinstance(seg.get("counts"), str):
            seg["counts"] = seg["counts"].encode()
        m = rle_api.decode(seg).astype(bool)
    else:
        m = region_mask(region, w, h)
    return _maybe_save(_blend(image, m, color), path)


def show_amodal_instance(image: np.ndarray, region: dict, color=(220, 40, 40),
                         path: Optional[str] = None) -> np.ndarray:
    """Full amodal extent of one instance (occluded parts included)."""
    h, w = image.shape[:2]
    m = region_mask(region, w, h)
    return _maybe_save(_blend(image, m, color), path)


def overlay_detections(image: np.ndarray, rois: np.ndarray, scores: np.ndarray,
                       masks: np.ndarray, alpha: float = 0.5,
                       path: Optional[str] = None) -> np.ndarray:
    """Render detector output: masks, boxes and scores."""
    out = image.copy()
    n = len(scores)
    for i in range(n):
        out = _blend(out, masks[:, :, i], _PALETTE[i % len(_PALETTE)], alpha)
    pil = Image.fromarray(out)
    draw = ImageDraw.Draw(pil)
    for i in range(n):
        y1, x1, y2, x2 = [int(v) for v in rois[i]]
        color = tuple(int(c) for c in _PALETTE[i % len(_PALETTE)])
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        draw.text((x1 + 2, max(y1 - 12, 0)), f"{scores[i]:.2f}", fill=color)
    return _maybe_save(np.asarray(pil), path)
