"""Sem-dist (semantics-aware distance map / level-set) uint64 codec.

Each pixel of an image carries a ``uint64`` label:

- low 32 bits  — bit-set of object IDs *visible* at this pixel,
- high 32 bits — bit-set of object IDs *occluded* (invisible) at this pixel.

This module re-implements, bit-exactly but vectorized, the reference decoders
(``modal/Functions.py:1010-1132``), the training-time layer decode
(``load_layer2``, ``amodal_train.py:236-271``) and the encoder
(``reLayerMask`` + ``remove_small_path``, ``utils.py:531-557``).

All functions are pure numpy — this is host-side data preparation; the
resulting dense layer masks are what gets shipped to the device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import scipy.ndimage

U64 = np.uint64
_ONE = U64(1)
_THIRTY_TWO = U64(32)


def get_image_labels(label_map: np.ndarray) -> np.ndarray:
    """Unique non-zero uint64 labels present in the map.

    Reference: ``get_image_labals`` (Functions.py:1012-1016).
    """
    ids = np.unique(label_map)
    if ids.size and ids[0] == 0:
        ids = ids[1:]
    return ids.astype(U64)


def split_vis_invis(label_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split uint64 labels into (low-32 visible bits, high-32 invisible bits)."""
    label_ids = label_ids.astype(U64)
    vis = label_ids & U64(0xFFFFFFFF)
    invis = label_ids >> _THIRTY_TWO
    return vis, invis


def bits_to_indices(value: int) -> List[int]:
    """Indices of set bits, ascending.

    Reference: ``number_to_index`` (Functions.py:1050-1060); returns [] for 0
    (the reference returns None — callers only use the truthy case).
    """
    value = int(value)
    out = []
    i = 0
    while value:
        if value & 1:
            out.append(i)
        value >>= 1
        i += 1
    return out


def max_object_id(label_ids: np.ndarray) -> int:
    """Number of object slots = 1 + highest 'top visible bit' scanned
    sequentially from 0.

    Replicates the exact loop of ``max_objectID`` (Functions.py:1074-1079):
    increments while *some* label's visible bits shifted right by ``shift``
    equal exactly 1 (i.e. a label whose top visible bit is ``shift`` exists).
    """
    if label_ids.size == 0:
        return 0
    vis, _ = split_vis_invis(label_ids)
    shift = 0
    while np.any(vis >> U64(shift) == _ONE):
        shift += 1
    return shift


def object_masks(
    label_map: np.ndarray, object_id: int, label_ids: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Visible / invisible boolean masks of one object.

    Vectorized equivalent of ``objectID_to_masks`` (Functions.py:1020-1033):
    union of the per-label masks rather than a list (callers union anyway).

    Returns (vis_mask[H,W], invis_mask[H,W]) boolean.
    """
    if label_ids is None:
        label_ids = get_image_labels(label_map)
    vis_bit = (label_ids >> U64(object_id)) & _ONE == _ONE
    invis_bit = (label_ids >> U64(object_id + 32)) & _ONE == _ONE
    vis_mask = np.isin(label_map, label_ids[vis_bit])
    invis_mask = np.isin(label_map, label_ids[invis_bit])
    return vis_mask, invis_mask


def occlusion_depth(label_id: int, object_id: int) -> int:
    """Occlusion depth of ``object_id`` within one label's invisible set.

    Reference semantics (``objIDs_to_sindistanceLayer`` + ``+1`` at
    amodal_train.py:254): the invisible object IDs of a label, sorted
    ascending, define the depth order; depth = 1 + rank of ``object_id``.
    """
    _, invis = split_vis_invis(np.asarray([label_id], dtype=U64))
    ids = bits_to_indices(int(invis[0]))
    return ids.index(object_id) + 1


def decode_layer_masks(
    label_map: np.ndarray, num_layers: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a sem-dist map into per-instance occlusion-layer masks.

    Bit-exact vectorized equivalent of ``AmodalDataset.load_layer2``
    (``amodal_train.py:236-271``) with
    ``num_layers = config.NUM_CLASSES - 1``:

    - channel 0: the object's visible mask,
    - channel d (1 <= d < num_layers-1): pixels where the object is occluded
      at depth d,
    - channel num_layers-1: overflow — depths >= num_layers-1.
      (With num_layers == 1, everything lands in channel 0: the amodal mask.)

    Returns:
        masks: bool [H, W, num_layers, N] (N = number of objects)
        class_ids: int32 [N] (all 1 — single foreground class)
    """
    label_ids = get_image_labels(label_map)
    n_objects = max_object_id(label_ids)
    h, w = label_map.shape
    if n_objects == 0:
        return (
            np.zeros((h, w, num_layers, 0), dtype=bool),
            np.zeros((0,), dtype=np.int32),
        )

    masks = np.zeros((h, w, num_layers, n_objects), dtype=bool)
    vis_bits, invis_bits = split_vis_invis(label_ids)

    # Precompute, per label, the ascending list of invisible object ids.
    invis_lists = [bits_to_indices(int(v)) for v in invis_bits]

    # Map each label id to its pixel mask once.
    # (labels are few; per-label boolean compare is the hot part)
    label_pixel_masks = {int(lid): (label_map == lid) for lid in label_ids}

    for obj in range(n_objects):
        has_vis = (vis_bits >> U64(obj)) & _ONE == _ONE
        for lid in label_ids[has_vis]:
            masks[:, :, 0, obj] |= label_pixel_masks[int(lid)]

        has_invis = (invis_bits >> U64(obj)) & _ONE == _ONE
        for lid in label_ids[has_invis]:
            depth = invis_lists[int(np.where(label_ids == lid)[0][0])].index(obj) + 1
            if depth >= num_layers - 1:
                channel = num_layers - 1
            else:
                channel = depth
            masks[:, :, channel, obj] |= label_pixel_masks[int(lid)]

    class_ids = np.ones((n_objects,), dtype=np.int32)
    return masks, class_ids


def decode_instance_masks(
    label_map: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode into (amodal, class_ids, visible, invisible) instance masks.

    Equivalent of ``AmodalDataset.load_layer`` (amodal_train.py:196-231) on an
    in-memory map: per object, amodal = vis | invis.

    Returns:
        amodal: bool [H, W, N]; class_ids: int32 [N];
        vis: bool [H, W, N]; invis: bool [H, W, N].
    """
    label_ids = get_image_labels(label_map)
    n_objects = max_object_id(label_ids)
    h, w = label_map.shape
    vis = np.zeros((h, w, n_objects), dtype=bool)
    invis = np.zeros((h, w, n_objects), dtype=bool)
    for obj in range(n_objects):
        v, iv = object_masks(label_map, obj, label_ids)
        vis[:, :, obj] = v
        invis[:, :, obj] = iv
    amodal = vis | invis
    class_ids = np.ones((n_objects,), dtype=np.int32)
    return amodal, class_ids, vis, invis


def remove_small_patches(label_map: np.ndarray, min_size: int = 64) -> np.ndarray:
    """Zero out label colors whose every connected component is < min_size px.

    Reference: ``remove_small_path`` (utils.py:550-557), which uses
    ``skimage.morphology.remove_small_objects`` per color and zeroes the color
    if nothing survives. Re-implemented with ``scipy.ndimage.label``
    (1-connectivity, matching skimage's default for 2-D).
    """
    out = label_map.copy()
    for color in np.unique(label_map):
        mask = label_map == color
        comp, n = scipy.ndimage.label(mask)
        if n == 0:
            survives = False
        else:
            sizes = np.bincount(comp.ravel())[1:]
            survives = bool(np.any(sizes >= min_size))
        if not survives:
            out[mask] = 0
    return out


def encode_layer_map(
    amodal_masks: List[np.ndarray],
    invis_masks: List[Optional[np.ndarray]],
    min_size: int = 64,
) -> np.ndarray:
    """Encode per-object amodal/invisible masks into a sem-dist uint64 map.

    Reference: ``reLayerMask`` (utils.py:531-547). Objects with index >= 32
    are skipped (the bit-field holds 32 object slots).
    """
    assert len(amodal_masks) == len(invis_masks)
    shape = amodal_masks[0].shape
    label = np.zeros(shape, dtype=U64)
    for i, (amodal, invis) in enumerate(zip(amodal_masks, invis_masks)):
        if i >= 32:
            continue
        if invis is not None and np.size(invis):
            inv = invis > 0
            label[inv] |= U64(1) << U64(i + 32)
            mask_vis = amodal.astype(np.int64) - inv.astype(np.int64)
        else:
            mask_vis = amodal.astype(np.int64)
        label[mask_vis > 0] |= U64(1) << U64(i)

    return remove_small_patches(label, min_size=min_size)


def load_layer_file(path: str) -> np.ndarray:
    """Load a per-image ``<image>.npz['layer']`` sem-dist map
    (reference: amodal_train.py:238)."""
    return np.load(path)["layer"]
