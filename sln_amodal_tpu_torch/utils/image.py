"""Host-side image molding / unmolding (numpy; PIL for the resizes).

The port's own copy of the JAX package's ``utils/image.py``, with the
reference's numerics:

- images are squash-resized to ``image_size`` squared with PIL bilinear
  (the reference's ``scipy.misc.imresize`` is PIL underneath); training
  samples take the same resize (``resize_image``), nearest-neighbour zoomed
  layer masks (``resize_layer_masks``) and the mean pixel subtracted on the
  host (``mold_image``);
- the mean pixel is subtracted on the device, after a uint8 upload
  (:class:`sln_amodal_tpu_torch.infer.Detector`);
- ``unmold_crop`` reproduces ``scipy.misc.imresize`` on a float mask:
  **bytescale by the mask's own min/max to uint8**, PIL bilinear resize,
  /255, threshold 0.5 — a relative threshold, a quirk masks depend on;
- ``unmold_detections`` trims the zero-padded detections, maps boxes back to
  the original frame and pastes full-frame masks.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def pil_resize_uint8(arr: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 array (H, W[, C]) via PIL."""
    if arr.shape[:2] == tuple(size_hw):
        return arr  # PIL bilinear at scale 1 is the identity
    from PIL import Image

    img = Image.fromarray(arr)
    img = img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img)


def bytescale(data: np.ndarray) -> np.ndarray:
    """scipy.misc.bytescale: min/max -> [0, 255] uint8 with +0.5 rounding."""
    cmin = float(data.min()) if data.size else 0.0
    cmax = float(data.max()) if data.size else 1.0
    cscale = cmax - cmin
    if cscale == 0:
        cscale = 1.0
    scale = 255.0 / cscale
    bytedata = (data - cmin) * scale
    return (np.clip(bytedata, 0, 255) + 0.5).astype(np.uint8)


def imresize_float(arr: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """scipy.misc.imresize on a float array: bytescale, PIL bilinear, a
    uint8 result (the caller divides by 255)."""
    return pil_resize_uint8(bytescale(arr), size_hw)


def resize_image(image: np.ndarray, image_size: int):
    """Squash-resize to (image_size, image_size): (resized, window, scale,
    padding) with the reference's conventions."""
    h, w = image.shape[:2]
    resized = pil_resize_uint8(image.astype(np.uint8), (image_size, image_size))
    window = (0, 0, image_size, image_size)
    scale = (image_size / h, image_size / w)
    padding = [(0, 0), (0, 0), (0, 0)]
    return resized, window, scale, padding


def resize_layer_masks(masks: np.ndarray, scale) -> np.ndarray:
    """Nearest-neighbour zoom of [H, W, L, N] layer masks (the reference's
    ``utils.py:358-362``)."""
    import scipy.ndimage

    return scipy.ndimage.zoom(masks, zoom=[scale[0], scale[1], 1, 1], order=0)


def mold_image(image: np.ndarray, mean_pixel) -> np.ndarray:
    """float32 image minus the mean pixel."""
    return image.astype(np.float32) - np.asarray(mean_pixel, np.float32)


def mold_inputs(images: List[np.ndarray], config):
    """Raw images -> (resized [N, S, S, 3] uint8, windows [N, 4])."""
    size = config.image_size
    molded = [pil_resize_uint8(im.astype(np.uint8), (size, size)) for im in images]
    windows = [(0, 0, size, size)] * len(images)
    return np.stack(molded), np.array(windows)


def unmold_crop(mask: np.ndarray, bbox) -> np.ndarray:
    """One low-res mask -> thresholded binary uint8 crop at box size."""
    y1, x1, y2, x2 = [int(v) for v in bbox]
    mask = np.squeeze(mask)
    resized = pil_resize_uint8(bytescale(mask), (y2 - y1, x2 - x1))
    resized = resized.astype(np.float32) / 255.0
    return np.where(resized >= 0.5, 1, 0).astype(np.uint8)


def unmold_detections_parts(detections: np.ndarray, mrcnn_mask: np.ndarray,
                            image_shape, window):
    """-> (boxes px int32 [N, 4], class_ids, scores, binary box-crop list)."""
    zero_ix = np.where(detections[:, 4] == 0)[0]
    n = zero_ix[0] if zero_ix.shape[0] > 0 else detections.shape[0]

    boxes = detections[:n, :4]
    class_ids = detections[:n, 4].astype(np.int32)
    class_ids[class_ids > 0] = 1  # single foreground class
    scores = detections[:n, 5]
    masks = mrcnn_mask[np.arange(n), :, :, class_ids]

    h_scale = image_shape[0] / (window[2] - window[0])
    w_scale = image_shape[1] / (window[3] - window[1])
    scales = np.array([h_scale, w_scale, h_scale, w_scale])
    shifts = np.array([window[0], window[1], window[0], window[1]])
    boxes = np.multiply(boxes - shifts, scales).astype(np.int32)

    exclude = np.where((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) <= 0)[0]
    if exclude.shape[0] > 0:
        boxes = np.delete(boxes, exclude, axis=0)
        class_ids = np.delete(class_ids, exclude, axis=0)
        scores = np.delete(scores, exclude, axis=0)
        masks = np.delete(masks, exclude, axis=0)
        n = class_ids.shape[0]

    crops = [unmold_crop(masks[i], boxes[i]) for i in range(n)]
    return boxes, class_ids, scores, crops


def unmold_detections(detections: np.ndarray, mrcnn_mask: np.ndarray, image_shape, window):
    """Network outputs -> (boxes px, class_ids, scores, masks [H, W, N]).

    detections: [D, 6] zero-padded; mrcnn_mask: [D, mh, mw, C] (NHWC)."""
    boxes, class_ids, scores, crops = unmold_detections_parts(
        detections, mrcnn_mask, image_shape, window)
    n = len(crops)
    if n == 0:
        return boxes, class_ids, scores, np.empty(image_shape[:2] + (0,))
    full = np.zeros((n,) + tuple(image_shape[:2]), np.uint8)
    for i, crop in enumerate(crops):
        y1, x1, y2, x2 = boxes[i]
        full[i, y1:y2, x1:x2] = crop
    return boxes, class_ids, scores, full.transpose(1, 2, 0)
