"""Deterministic synthetic checkpoints for tests and the smoke.

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
"""

from __future__ import annotations

from typing import Dict

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
