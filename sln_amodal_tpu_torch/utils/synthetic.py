"""Deterministic synthetic checkpoints and datasets for tests, the smoke
and the no-weights rehearsals of the CLIs.

:func:`rpn_biased_variables` is the training start of the convergence
check: only the RPN is biased (zero deltas, equal foreground scores, so
the proposals tile the image with anchors and positives reach the heads
from the first step), and the classifier's final layers are scaled by
0.01 (near-zero predictions, well-scaled first gradients).

:func:`detection_biased_variables` biases a state_dict so that inference
emits real detections without training, with the JAX package's recipe:

- zero RPN and classifier box heads: the detections are exactly anchors;
- zero RPN class kernel with a (bg, fg) = (0, 1) bias for every anchor:
  equal scores, so the proposal order is the stable anchor order and NMS
  tiles the image with kept anchors;
- a +8 foreground classifier bias: every detection is foreground;
- the mask head: conv4 zero with bias 1 (a constant map), a 2x2 transposed
  conv with one tap in four at 0.5 (a fixed dither), conv5 at 10 on the
  layer channels (logits 5 and 10). A constant mask would rescale to all
  zeros in the unmold's bytescale by its own min/max; the dither survives
  it as a 75%-coverage mask of the box.

:func:`make_synthetic_dataset` writes a COCOA-style set (images, sem-dist
``.npz`` maps, amodal JSON); by default the files of the tests' fixture
(``tests/fixtures.py``), and with ``regions=biased_pair(config)`` regions
on the boxes that :func:`detection_biased_init`'s checkpoint detects.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def detection_biased_variables(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` (the reference layout) with the recipe
    above applied; the other weights are kept."""
    sd = {k: v.clone() for k, v in state_dict.items()}
    for key in ("rpn.conv_bbox", "classifier.linear_bbox", "rpn.conv_class",
                "mask.conv4", "mask.deconv", "mask.conv5"):
        sd[f"{key}.weight"].zero_()
        sd[f"{key}.bias"].zero_()
    sd["rpn.conv_class.bias"][1::2] = 1.0          # (bg, fg) channel pairs
    sd["classifier.linear_class.bias"].zero_()
    sd["classifier.linear_class.bias"][1] = 8.0
    sd["mask.conv4.bias"].fill_(1.0)
    # ConvTranspose2d weight [in, out, kh, kw]: input channel 0 drives every
    # output channel; the low tap sits at (1, 1), where the JAX package's
    # spatially flipped flax kernel has it at (0, 0)
    deconv = sd["mask.deconv.weight"]
    deconv[0] = 1.0
    deconv[0, :, 1, 1] = 0.5
    sd["mask.conv5.weight"][1:, 0, 0, 0] = 10.0
    return sd


def rpn_biased_variables(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` with the JAX package's
    ``utils/synthetic.py::rpn_biased_variables`` recipe: the RPN's box and
    class convs zero, a (bg, fg) = (0, 1) class bias for every anchor
    (anchor-major channel pairs), and the classifier's two final linear
    weights times 0.01 (their biases kept)."""
    sd = {k: v.clone() for k, v in state_dict.items()}
    for key in ("rpn.conv_bbox", "rpn.conv_class"):
        sd[f"{key}.weight"].zero_()
        sd[f"{key}.bias"].zero_()
    sd["rpn.conv_class.bias"][1::2] = 1.0
    for key in ("classifier.linear_class", "classifier.linear_bbox"):
        sd[f"{key}.weight"] *= 0.01
    return sd


def detection_biased_init(config, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The detection-biased state_dict of ``config``'s model, on the CPU:
    the seeded init with a zero classifier kernel, under
    :func:`detection_biased_variables`. With random trunks the RoI features
    are large and alike, so a random kernel decides foreground or
    background for every RoI at once, by the seed's luck (seed 0 gives all
    foreground under PyTorch 2.13 and all background under 2.11, which
    draws other values for the seed). A zero kernel leaves the recipe's +8
    foreground bias alone: equal scores, and the detections are the first
    proposals in order (:func:`biased_detection_boxes`)."""
    from ..convert import init_params

    base = init_params(config, seed=seed, device="cpu")
    base["classifier.linear_class.weight"].zero_()
    return detection_biased_variables(base)


def biased_detection_boxes(config) -> np.ndarray:
    """Pixel boxes of the detections :func:`detection_biased_init` gives
    every image. Its RPN scores all anchors equally and predicts zero
    deltas, so the proposals are the first ``pre_nms_limit`` anchors,
    clipped and thinned by NMS (computed here with the plain versions on
    the CPU); its classifier scores every proposal equally, so the
    detections are the first ``detection_max_instances`` proposals, each
    masked by a 75% dither of its box."""
    from ..detect.proposal import proposal_layer_batched
    from ..ops.anchors import config_anchors

    anchors = torch.from_numpy(config_anchors(config))
    n = anchors.shape[0]
    props, valid = proposal_layer_batched(
        torch.full((1, n, 2), 0.5), torch.zeros((1, n, 4)), anchors,
        proposal_count=config.post_nms_rois_inference, nms_threshold=config.rpn_nms_threshold,
        image_size=config.image_size, rpn_bbox_std_dev=config.rpn_bbox_std_dev,
        pre_nms_limit=config.pre_nms_limit)
    boxes = torch.round(props[0][valid[0]] * config.image_size).numpy().astype(np.int32)
    boxes = boxes[:config.detection_max_instances]
    return boxes[(boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])]


Box = Tuple[int, int, int, int]
Regions = Callable[[np.random.RandomState], Tuple[Box, Box]]


def biased_pair(config) -> Regions:
    """Draws an image's two regions from the boxes the biased RPN proposes
    first (:func:`biased_detection_boxes`): one at random and the box that
    overlaps it most. The detection-biased checkpoint's dithered masks match
    them (a nonzero recall shows the masks survived the unmold), and
    training from the RPN-biased checkpoint samples positive ROIs on them."""
    boxes = biased_detection_boxes(config)
    y1, x1 = np.maximum(boxes[:, None, :2], boxes[None, :, :2]).transpose(2, 0, 1)
    y2, x2 = np.minimum(boxes[:, None, 2:], boxes[None, :, 2:]).transpose(2, 0, 1)
    overlap = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    np.fill_diagonal(overlap, -1)

    def pair(rng):
        a = rng.randint(len(boxes))
        return tuple(boxes[a]), tuple(boxes[int(np.argmax(overlap[a]))])
    return pair


def square_pair(size: int) -> Regions:
    """Draws an image's two regions as the tests' fixture places them: two
    half-size squares at a seeded offset, the second shifted by a quarter
    of the image."""
    def pair(rng):
        o, half = rng.randint(0, size // 4), size // 2
        q = o + half // 2
        return (o, o, o + half, o + half), (q, q, q + half, q + half)
    return pair


def make_synthetic_dataset(root: str, n_images: int = 4, size: int = 64,
                           data_type: str = "COCO", subset: str = "train",
                           year: str = "2014", seed: int = 0,
                           regions: Optional[Regions] = None,
                           alternate_stuff: bool = False) -> str:
    """Images, sibling ``.npz`` sem-dist maps and the amodal annotation
    JSON (``annotations/{data_type}_amodal_{subset}{year}.json``), the port's
    copy of ``tests/fixtures.py::make_synthetic_dataset``: seeded noise
    images, each with two rectangular regions, region 0 occluded by region
    1. ``regions(rng)`` draws their pixel boxes (y1, x1, y2, x2); the
    default, :func:`square_pair`, writes the fixture's files byte for
    byte. With ``alternate_stuff`` region 1 of every second image (the
    second, the fourth, ...) is stuff (``isStuff`` 1), so that the sweep's
    things and stuff slices both hold regions."""
    from PIL import Image

    from ..data import semdist
    from ..eval_amodal import rle

    regions = regions or square_pair(size)
    rng = np.random.RandomState(seed)
    folder = subset if subset not in ("minival", "valminusminival") else "val"
    img_dir = os.path.join(root, f"{folder}{year}")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    def rect(box):
        m = np.zeros((size, size), bool)
        m[box[0]:box[2], box[1]:box[3]] = True
        return m

    def rle_str(mask):
        r = rle.encode(np.asfortranarray(mask.astype(np.uint8)))
        return {"size": r["size"], "counts": r["counts"].decode()}

    images, annotations = [], []
    for i in range(n_images):
        img_id, fname = i + 1, f"img_{i + 1:04d}.jpg"
        Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(
            os.path.join(img_dir, fname))
        a0, a1 = (rect(box) for box in regions(rng))
        inv0 = a0 & a1
        np.savez(os.path.join(img_dir, fname[:-4] + ".npz"),
                 layer=semdist.encode_layer_map([a0, a1], [inv0, None], min_size=4))
        regions_json = [
            {"segmentation": rle_str(a0), "visible_mask": rle_str(a0 & ~inv0),
             "invisible_mask": rle_str(inv0), "isStuff": 0,
             "occlude_rate": float(inv0.sum()) / max(float(a0.sum()), 1.0), "order": 1,
             "amodal_region": {"order": 1}, "area": int(a0.sum())},
            {"segmentation": rle_str(a1), "visible_mask": rle_str(a1),
             "isStuff": i % 2 if alternate_stuff else 0, "occlude_rate": 0.0, "order": 2,
             "amodal_region": {"order": 2}, "area": int(a1.sum())},
        ]
        images.append({"id": img_id, "file_name": fname, "width": size, "height": size})
        annotations.append({"id": img_id, "image_id": img_id, "regions": regions_json})
    with open(os.path.join(ann_dir, f"{data_type}_amodal_{subset}{year}.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return root
