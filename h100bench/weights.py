"""The benchmark's weights: made on the device from the seed, in the
reference ``.pth`` layout, float32 (the parameter dtype both configurations
state).

The trunk's part of the recipe comes from its file,
``reference/trunks/<backbone>.py``; the rest is the same for every trunk.

A seeded network of random weights detects nothing useful and, under
identity frozen batch norm, grows its activations some 500-fold through
the trunk, where every box's features become nearly alike: then rounding
alone reorders the detections. :func:`inference_weights` therefore
applies a recipe (after ``utils/synthetic.py::detection_biased_variables``
of the program, which it extends) and sets statistics and scales from one
calibration pass of the reference over the first image of the cell:

- every frozen batch norm of the GLM, the classifier and the mask head,
  and those the trunk file names (``calibrated``), takes the per-channel
  mean and mean square of its input in that pass (:func:`standardizing`),
  and the weights that scale each residual branch (the trunk file's
  ``branches``, the last batch norm of the GLM's bottlenecks) the factor
  ``BRANCH_GAIN``, as a trained residual network's branches are small
  beside their shortcut: a random network with full-scale branches is
  chaotic, and rounding in its first layers would grow until the boxes
  it detects are others;

- the RPN's class conv zero with a (0, 1) bias per anchor and its box conv
  zero: every anchor scores alike, so the proposals are the first
  ``pre_nms_limit`` anchors in their published order thinned by NMS, the
  same in every precision (the proposal NMS still runs on 6000 real boxes);
- the FPN's smooth convs scaled so that P2..P5 have unit RMS;
- the classifier's two final layers scaled so that, over the proposals,
  the foreground-minus-background logit has mean ``CLASS_MARGIN`` and
  standard deviation ``CLASS_SPREAD``, and the box deltas the means and
  spreads of ``DELTA_MEAN`` / ``DELTA_SPREAD``: the refined boxes grow
  from the 32-pixel anchors to object sizes (about 50 to 150 pixels of
  the 1024 frame) and move off the top strip, each by the features at its
  proposal (a wider spread would amplify rounding in the features into
  box positions beyond what the judge can tell from a lower precision);
- the mask head's last conv scaled so that the layer logit has spread
  ``MASK_SPREAD`` and mean 0 over the calibration image's detections.

Every other weight keeps its seeded value, so every layer (trunk, FPN,
classifier, mask head, the GLM prior for boxes at the top or left edge)
moves what the judge compares.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch

from .reference.model import FrozenBN, Reference, crop_and_resize, roi_align

BRANCH_GAIN = 0.1
CLASS_MARGIN, CLASS_SPREAD = 3.0, 1.5
DELTA_MEAN = (30.0, 0.0, 5.0, 5.0)      # (dy, dx, log dh, log dw), before the std devs
DELTA_SPREAD = (20.0, 20.0, 1.5, 1.5)
MASK_SPREAD = 2.0
TRUNK = "fpn."                          # the trunk file's network in the state_dict


def seeded(ref: Reference, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state_dict of ``ref``'s layout: conv, transposed-conv and linear
    weights normal with variance 1/fan_in, biases zero, frozen BN the
    identity, and what else the trunk starts otherwise (its file's
    ``start``). All weights come from one draw of a generator on
    ``device``; a trunk's further draws follow it."""
    sd = {k: torch.zeros(v.shape, dtype=torch.float32, device=device)
          for k, v in ref.state_dict().items()}
    layers = [(name, mod) for name, mod in ref.named_modules()
              if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear))]
    sizes = [mod.weight.numel() for _, mod in layers]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    for (name, mod), part in zip(layers, torch.split(draw, sizes)):
        shape = tuple(mod.weight.shape)
        fan_in = (shape[0] if isinstance(mod, torch.nn.ConvTranspose2d) else shape[1]) \
            * math.prod(shape[2:])
        sd[f"{name}.weight"] = part.reshape(shape) / math.sqrt(fan_in)
    for name, mod in ref.named_modules():
        if isinstance(mod, FrozenBN):
            sd[f"{name}.weight"].fill_(1.0)
            sd[f"{name}.running_var"].fill_(1.0)
    trunk = {k[len(TRUNK):]: v for k, v in sd.items() if k.startswith(TRUNK)}
    ref.trunk.start(ref.fpn, trunk, gen)
    sd.update((TRUNK + k, v) for k, v in trunk.items())
    return sd


def gain_branches(ref: Reference, sd: Dict[str, torch.Tensor]) -> None:
    """Scale each residual branch by ``BRANCH_GAIN``: the trunk's (its
    file's ``branches``), each GLM bottleneck's last batch norm and the
    mask head's third batch norm (which a suffix rule meant for the trunk
    has always reached; kept so that the weights stay as they were)."""
    for key in ref.trunk.branches(ref.fpn):
        sd[TRUNK + key].mul_(BRANCH_GAIN)
    for name in sd:
        if name.endswith(".increase.bn.weight") or name == "mask.bn3.weight":
            sd[name].fill_(BRANCH_GAIN)


def frozen_bns(module: torch.nn.Module):
    return [m for m in module.modules() if isinstance(m, FrozenBN)]


@contextlib.contextmanager
def standardizing(modules):
    """While open, each frozen batch norm of ``modules`` takes, at its first
    call, its input's per-channel mean as its mean and the per-channel mean
    square as its variance: the layers that follow see centred channels at
    most of unit scale (the role a trained network's statistics play), so
    activations neither grow through the depth nor collapse onto one
    common direction. Dividing by the mean square, not the variance, keeps
    a channel that barely varies from amplifying its rounding."""
    done = set()

    def hook(mod, args):
        if mod in done:
            return
        x = args[0].detach()
        mod.running_mean.copy_(x.mean((0, 2, 3)))
        mod.running_var.copy_(x.pow(2).mean((0, 2, 3)))
        done.add(mod)

    handles = [m.register_forward_pre_hook(hook) for m in modules]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _rescale_rows(sd, key, rows, raw, mean, spread):
    """Scale rows of a linear layer so that its outputs ``raw`` [N, rows]
    get the given mean and spread: w' = k w, b' = (b - mu) k + mean."""
    mu, sigma = raw.mean(0), raw.std(0).clamp_min(1e-12)
    k = torch.tensor(spread, dtype=raw.dtype, device=raw.device) / sigma
    target = torch.tensor(mean, dtype=raw.dtype, device=raw.device)
    sd[f"{key}.weight"][rows] *= k[:, None]
    sd[f"{key}.bias"][rows] = (sd[f"{key}.bias"][rows] - mu) * k + target


@torch.no_grad()
def inference_weights(cfg: Dict, seed: int, image_u8: torch.Tensor,
                      device) -> Dict[str, torch.Tensor]:
    """The inference cells' state_dict (see the module docstring), on
    ``device``; ``image_u8`` [1, S, S, 3] is the calibration image."""
    ref = Reference(cfg).to(device)
    sd = seeded(ref, seed, device)
    for key in ("rpn.conv_class", "rpn.conv_bbox"):
        sd[f"{key}.weight"].zero_()
        sd[f"{key}.bias"].zero_()
    sd["rpn.conv_class.bias"][1::2] = 1.0
    gain_branches(ref, sd)
    ref.load_state_dict(sd)
    x = ref.molded(image_u8)
    with standardizing(ref.trunk.calibrated(ref.fpn)):
        feats = ref.fpn(x)
    with standardizing(frozen_bns(ref.GLM_modual)):
        ref.prior(x)
    rms = max(float(p.pow(2).mean().sqrt()) for p in feats[:4])
    for level in range(2, 6):
        conv = getattr(ref.fpn, f"P{level}_conv2")[1]
        conv.weight /= rms
        conv.bias /= rms
    feats = [p / rms for p in feats]
    rois, _ = ref.proposals(*ref.rpn_outputs(feats)[1:])
    crops = roi_align(feats[:4], rois, cfg["pool_size"], cfg["image_size"])
    with standardizing(frozen_bns(ref.classifier)):
        hidden = ref.classifier.features(crops)
    sd = {k: v.clone() for k, v in ref.state_dict().items()}
    w, b = sd["classifier.linear_class.weight"], sd["classifier.linear_class.bias"]
    margin = hidden @ (w[1] - w[0])
    k = CLASS_SPREAD / float(margin.std().clamp_min(1e-12))
    w *= k
    b[0], b[1] = 0.0, CLASS_MARGIN - k * float(margin.mean())
    raw = hidden @ sd["classifier.linear_bbox.weight"].T + sd["classifier.linear_bbox.bias"]
    fg = slice(4, 8)                       # class 1's deltas: the detections use them
    _rescale_rows(sd, "classifier.linear_bbox", fg, raw[:, fg], DELTA_MEAN, DELTA_SPREAD)
    ref.load_state_dict(sd)
    cands, levels, prior = ref.candidates(image_u8)
    boxes = cands.boxes[cands.detections]
    norm = boxes / float(cfg["image_size"])
    fpn = roi_align(levels, norm, cfg["mask_pool_size"], cfg["image_size"])
    zero = torch.zeros(boxes.shape[0], dtype=torch.long, device=boxes.device)
    glm = crop_and_resize(prior, boxes, zero, cfg["mask_pool_size"])
    with standardizing(frozen_bns(ref.mask)):
        hidden = ref.mask.features(fpn, glm)
    for name, v in ref.mask.state_dict().items():
        if "bn" in name:
            sd[f"mask.{name}"] = v.clone()
    logits = torch.einsum("nchw,oc->nhwo", hidden,
                          sd["mask.conv5.weight"][:, :, 0, 0]) + sd["mask.conv5.bias"]
    layer = logits[..., 1:].sum(-1)
    k = MASK_SPREAD / float(layer.std().clamp_min(1e-12))
    shift = float(layer.mean()) / (logits.shape[-1] - 1)
    sd["mask.conv5.weight"][1:] *= k
    sd["mask.conv5.bias"][1:] = (sd["mask.conv5.bias"][1:] - shift) * k
    return sd


@torch.no_grad()
def training_weights(cfg: Dict, seed: int, image_u8: torch.Tensor,
                     device) -> Dict[str, torch.Tensor]:
    """The training cell's starting state_dict, on ``device``: the seeded
    weights with ``chip_smoke.py::train_start_weights``'s changes for a
    random network, where they keep the step well scaled (the classifier's
    two final layers times 0.01; the frozen batch norms and the FPN scaled
    as in :func:`inference_weights`), but the RPN kept seeded (its box conv
    times 1e-3): its scores then follow the features, so the proposals
    spread over the frame at every scale and reach the regions, where
    anchors scored alike would all sit in the first rows of the image."""
    ref = Reference(cfg).to(device)
    sd = seeded(ref, seed, device)
    sd["rpn.conv_bbox.weight"] *= 1e-3
    for key in ("classifier.linear_class", "classifier.linear_bbox"):
        sd[f"{key}.weight"] *= 0.01
    gain_branches(ref, sd)
    ref.load_state_dict(sd)
    x = ref.molded(image_u8)
    with standardizing(ref.trunk.calibrated(ref.fpn)):
        feats = ref.fpn(x)
    with standardizing(frozen_bns(ref.GLM_modual)):
        prior = ref.prior(x)
    rms = max(float(p.pow(2).mean().sqrt()) for p in feats[:4])
    for level in range(2, 6):
        conv = getattr(ref.fpn, f"P{level}_conv2")[1]
        conv.weight /= rms
        conv.bias /= rms
    feats = [p / rms for p in feats]
    rois, _ = ref.proposals(*ref.rpn_outputs(feats)[1:], cfg["post_nms_rois_training"])
    rois = rois[:cfg["train_rois_per_image"]]
    with standardizing(frozen_bns(ref.classifier)):
        ref.classifier.features(roi_align(feats[:4], rois, cfg["pool_size"], cfg["image_size"]))
    m = cfg["mask_pool_size"]
    zero = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    with standardizing(frozen_bns(ref.mask)):
        ref.mask.features(roi_align(feats[:4], rois, m, cfg["image_size"]),
                          crop_and_resize(prior, rois, zero, m))
    return {k: v.clone() for k, v in ref.state_dict().items()}
