"""Checkpoints of the port: reference ``.pth`` state_dicts.

The port's state_dict has the reference layout, so a released post-surgery
``COCOA.pth`` / ``D2SA.pth`` loads key for key. :func:`load_weights` also
takes the two other files the reference uses:

- a checkpoint without ``GLM_modual.*`` keys gets the standalone
  ``deeplabv2.pth`` under that prefix (the reference's
  ``amodal_train.py:612-613``), or keeps the template's with a warning;
- the pre-surgery 81-class ``mask_rcnn_coco.pth`` takes the four layers the
  reference re-creates after loading it (``amodal_train.py:606-610``) from
  the template;
- the refine head (``amodal_refine.*``, with ``use_refine_head``), which no
  reference checkpoint holds, keeps the template's.

Checkpoints the port writes are ``{log_dir}/{name}/sln_amodal_{name}_{epoch:04d}.pth``,
and beside each, for a resume in the middle of a stage, ``<that>.state``
(:func:`save_train_state`: the state_dict, the SGD momentum buffers, the
gradient accumulator with its micro-step count, and the stage's step
counter, in torch format).
"""

from __future__ import annotations

import os
import re
import sys
from typing import Dict, Mapping, Optional, Tuple

import torch

StateDict = Dict[str, torch.Tensor]

CKPT_RE = re.compile(r"sln_amodal_(\w+)_(\d{4})\.pth$")

GLM_PREFIX = "GLM_modual."
REFINE_PREFIX = "amodal_refine."

# The four modules the reference re-creates after loading mask_rcnn_coco.pth:
# mask.conv1 (439 inputs), mask.conv5 and both classifier linears (2 classes).
SURGICAL_LAYERS = ("classifier.linear_class", "classifier.linear_bbox",
                   "mask.conv1", "mask.conv5")


def checkpoint_path(log_dir: str, name: str, epoch: int) -> str:
    return os.path.join(log_dir, name.lower(), f"sln_amodal_{name.lower()}_{epoch:04d}.pth")


def save(state_dict: Mapping[str, torch.Tensor], log_dir: str, name: str, epoch: int) -> str:
    path = checkpoint_path(log_dir, name, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    return path


def save_train_state(model, optimizer, step: int, log_dir: str, name: str,
                     epoch: int) -> str:
    """The full resume state of a stage at the end of ``epoch``: the model's
    state_dict, the optimizer's (momentum buffers, and the accumulated
    gradients of a run cut between micro-steps) and the step counter."""
    path = checkpoint_path(log_dir, name, epoch) + ".state"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "optimizer": optimizer.state_dict(), "step": int(step)}, path)
    return path


def restore_train_state(path: str, model, optimizer) -> int:
    """Load a ``.state`` file into ``model`` and ``optimizer`` (the same
    stage's, built over the same parameters); returns the step counter."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def find_last(log_dir: str, name: str) -> Tuple[Optional[str], Optional[int]]:
    """Newest checkpoint path + its epoch, or (None, None)."""
    d = os.path.join(log_dir, name.lower())
    if not os.path.isdir(d):
        return None, None
    best, best_epoch = None, -1
    for fn in os.listdir(d):
        m = CKPT_RE.search(fn)
        if m and int(m.group(2)) > best_epoch:
            best_epoch = int(m.group(2))
            best = os.path.join(d, fn)
    return best, (best_epoch if best else None)


def read_state_dict(path: str) -> StateDict:
    """A ``.pth`` state_dict's tensors (loaded without running pickled code)."""
    if not path.endswith(".pth"):
        raise ValueError(
            f"{path}: not a reference .pth checkpoint. A JAX-package .ckpt "
            "(flax msgpack) is converted with `python -m "
            "sln_amodal_tpu.convert.torch_export CKPT OUT.pth`")
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def is_pre_surgery(sd: Mapping[str, torch.Tensor], template: Mapping[str, torch.Tensor]) -> bool:
    """True for the 81-class ``mask_rcnn_coco.pth`` layout: its classifier
    has another class count than the amodal model's."""
    key = "classifier.linear_class.weight"
    return key in sd and sd[key].shape[0] != template[key].shape[0]


def load_weights(path: str, template: Mapping[str, torch.Tensor],
                 glm_path: Optional[str] = None) -> StateDict:
    """A state_dict for the model ``template`` is the state_dict of, read
    from a reference ``.pth``.

    Every key of the template must come from the file (after the two cases
    in the module docstring) with the template's shape, or this raises. Keys
    the model does not have (such as BatchNorm ``num_batches_tracked``) are
    dropped and listed in a warning. Tensors take the template's dtype and
    device."""
    sd = read_state_dict(path)
    if is_pre_surgery(sd, template):
        for layer in SURGICAL_LAYERS:
            for part in ("weight", "bias"):
                sd[f"{layer}.{part}"] = template[f"{layer}.{part}"]
    if not any(k.startswith(GLM_PREFIX) for k in sd):
        if glm_path is not None:
            sd.update({GLM_PREFIX + k: v for k, v in read_state_dict(glm_path).items()})
        else:
            # the reference requires deeplabv2.pth; keep the template's GLM so
            # that runs without it still go, but loudly: random GLM priors make
            # full-parity eval numbers meaningless
            print(f"WARNING: {path} has no GLM weights and no glm_path was given "
                  "(deeplabv2.pth not found?): using the template's GLM. Detection "
                  "masks will not match the reference checkpoints.", file=sys.stderr)
            sd.update({k: v for k, v in template.items() if k.startswith(GLM_PREFIX)})

    # a reference .pth has no refine head (the reference never builds it):
    # the model's own, seeded, stays
    sd.update({k: v for k, v in template.items()
               if k.startswith(REFINE_PREFIX) and k not in sd})
    missing = sorted(set(template) - set(sd))
    if missing:
        raise KeyError(f"{path}: {len(missing)} keys of the model are missing, "
                       f"e.g. {missing[:5]}")
    dropped = sorted(set(sd) - set(template))
    if dropped:
        print(f"WARNING: {path}: {len(dropped)} keys the model does not have are "
              f"ignored: {dropped}", file=sys.stderr)
    out: StateDict = {}
    for k, t in template.items():
        v = sd[k]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the model "
                             f"{tuple(t.shape)}")
        out[k] = v.to(device=t.device, dtype=t.dtype)
    return out
