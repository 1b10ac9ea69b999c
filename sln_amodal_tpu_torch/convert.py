"""Weights for the port: carried from JAX variables, or a seeded init.

:func:`params_from_jax` maps the JAX package's ``{'params': ...}`` tree (as
nested dicts of numpy arrays) to the reference ``.pth`` state_dict layout
that :class:`~sln_amodal_tpu_torch.models.sln.SLNAmodal` is named after. The
port keeps its own copy of the flax -> reference mapping:

- flax Conv kernel HWIO -> Conv2d OIHW;
- flax Dense kernel [in, out] -> Linear [out, in];
- the mask head's transposed conv kernel [kh, kw, in, out], which flax
  applies spatially flipped -> ConvTranspose2d [in, out, kh, kw], un-flipped;
- frozen BN (scale, bias, mean, var) -> (weight, bias, running_mean,
  running_var).

Arrays keep their dtype. :func:`init_params` makes a state_dict of the same
layout from a seed, in ``param_dtype``, for runs with no JAX at hand.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .config import Config
from .device import resolve_device, torch_dtype
from .models.common import FrozenBatchNorm2d

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _conv(sd: StateDict, tree: Mapping, name: str) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1)))
    if "bias" in tree:
        sd[f"{name}.bias"] = _t(tree["bias"])


def _deconv(sd: StateDict, tree: Mapping, name: str) -> None:
    k = np.asarray(tree["kernel"])[::-1, ::-1]
    sd[f"{name}.weight"] = _t(np.transpose(k, (2, 3, 0, 1)))
    sd[f"{name}.bias"] = _t(tree["bias"])


def _linear(sd: StateDict, tree: Mapping, name: str) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(tree["kernel"]).T)
    sd[f"{name}.bias"] = _t(tree["bias"])


def _bn(sd: StateDict, tree: Mapping, name: str) -> None:
    for src, dst in (("scale", "weight"), ("bias", "bias"),
                     ("mean", "running_mean"), ("var", "running_var")):
        sd[f"{name}.{dst}"] = _t(tree[src])


def mask_layers(sd: StateDict, tree: Mapping, prefix: str) -> None:
    """The conv stack of the mask head (and of the refine head, which has
    its layers): ``{prefix}conv1..5``, ``{prefix}bn1..4``, ``{prefix}deconv``."""
    for i in range(1, 5):
        _conv(sd, tree[f"conv{i}"], f"{prefix}conv{i}")
        _bn(sd, tree[f"frozen_bn{i}"], f"{prefix}bn{i}")
    _deconv(sd, tree["deconv"], f"{prefix}deconv")
    _conv(sd, tree["conv5"], f"{prefix}conv5")


def _numbered(tree: Mapping, prefix: str):
    """Subtree keys ``{prefix}{i}`` in numeric order."""
    keys = [k for k in tree if re.fullmatch(rf"{prefix}\d+", k)]
    return sorted(keys, key=lambda k: int(k[len(prefix):]))


def params_from_jax(variables: Mapping) -> StateDict:
    """JAX ``{'params': ...}`` tree -> the port's state_dict (CPU tensors)."""
    p = variables["params"]
    sd: StateDict = {}

    fpn = p["fpn"]
    _conv(sd, fpn["stem_conv"], "fpn.C1.0")
    _bn(sd, fpn["stem_frozen_bn"], "fpn.C1.1")
    for stage in (2, 3, 4, 5):
        layer = fpn[f"layer{stage}"]
        for b, key in enumerate(_numbered(layer, "block")):
            blk, name = layer[key], f"fpn.C{stage}.{b}"
            for i in (1, 2, 3):
                _conv(sd, blk[f"conv{i}"], f"{name}.conv{i}")
                _bn(sd, blk[f"frozen_bn{i}"], f"{name}.bn{i}")
            if "downsample_conv" in blk:
                _conv(sd, blk["downsample_conv"], f"{name}.downsample.0")
                _bn(sd, blk["downsample_frozen_bn"], f"{name}.downsample.1")
    for lvl in (2, 3, 4, 5):
        _conv(sd, fpn[f"p{lvl}_lateral"], f"fpn.P{lvl}_conv1")
        _conv(sd, fpn[f"p{lvl}_smooth"], f"fpn.P{lvl}_conv2.1")

    for key in ("conv_shared", "conv_class", "conv_bbox"):
        _conv(sd, p["rpn"][key], f"rpn.{key}")

    cls = p["classifier"]
    for i in (1, 2):
        _conv(sd, cls[f"conv{i}"], f"classifier.conv{i}")
        _bn(sd, cls[f"frozen_bn{i}"], f"classifier.bn{i}")
    _linear(sd, cls["linear_class"], "classifier.linear_class")
    _linear(sd, cls["linear_bbox"], "classifier.linear_bbox")

    # the mask head, and the refine head where the tree has one
    for head in ("mask", "amodal_refine"):
        if head in p:
            mask_layers(sd, p[head], f"{head}.")

    base = p["glm"]["base"]
    prefix = "GLM_modual.base"

    def conv_bn(tree: Mapping, name: str) -> None:
        _conv(sd, tree["conv"], f"{name}.conv")
        _bn(sd, tree["frozen_bn"], f"{name}.bn")

    conv_bn(base["stem"], f"{prefix}.layer1.conv1")
    for li in (2, 3, 4, 5):
        layer = base[f"layer{li}"]
        for key in _numbered(layer, "block"):
            for part in ("reduce", "conv3x3", "increase", "shortcut"):
                if part in layer[key]:
                    conv_bn(layer[key][part], f"{prefix}.layer{li}.{key}.{part}")
    for key in _numbered(base["aspp"], "c"):
        _conv(sd, base["aspp"][key], f"{prefix}.aspp.{key}")
    return sd


def init_params(config: Config, seed: int = 0, device="cuda") -> StateDict:
    """A seeded state_dict for the port, on ``device``.

    Conv, transposed-conv and linear weights are truncated-normal with
    variance 1/fan_in (flax's lecun_normal), biases zero, frozen BN the
    identity. The values come from a CPU ``torch.Generator``, so a seed gives
    the same weights on every device."""
    from .models.sln import SLNAmodal

    dev = resolve_device(device)
    with torch.device("meta"):
        skeleton = SLNAmodal(config.replace(compute_dtype="float32",
                                            param_dtype="float32"), device="meta")
    gen = torch.Generator().manual_seed(seed)
    dtype = torch_dtype(config.param_dtype)
    sd: StateDict = {}
    for mod_name, mod in skeleton.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, FrozenBatchNorm2d):
            n = mod.weight.shape[0]
            sd[prefix + "weight"] = torch.ones(n)
            sd[prefix + "bias"] = torch.zeros(n)
            sd[prefix + "running_mean"] = torch.zeros(n)
            sd[prefix + "running_var"] = torch.ones(n)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            shape = tuple(mod.weight.shape)
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = shape[0] * shape[2] * shape[3]
            else:
                fan_in = math.prod(shape[1:])
            # lecun_normal: a normal truncated at 2 sigma, rescaled to unit variance
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
            sd[prefix + "weight"] = w
            if mod.bias is not None:
                sd[prefix + "bias"] = torch.zeros(mod.bias.shape)
    return {k: v.to(device=dev, dtype=dtype) for k, v in sd.items()}
