"""Optimizer and staged layer freezing: port of the JAX package's
``train/optim.py``.

The reference's step (``model.py:304-358``, ``amodal_train.py:642-663``):
SGD with momentum 0.9, weight decay 1e-4 on the trained non-BN parameters,
the gradient clipped to a global norm of 5.0, and a trainable set chosen by
stage ("heads", "5+", "4+", "3+", "all", "mask").

- The stage predicates are written over the port's state_dict names (the
  reference's): ``fpn.C{k}`` is the JAX tree's ``fpn/layer{k}``,
  ``fpn.P{l}_conv1`` / ``fpn.P{l}_conv2`` the lateral / smooth convs, and
  ``rpn.``, ``classifier.``, ``mask.`` the heads. ``GLM_modual.`` is never
  trained, and frozen batch norm holds buffers, not parameters.
- The update equals the JAX package's optax chain, in its order: the frozen
  gradients are zero (here: the frozen parameters take no gradient), the
  gradient is clipped by its global norm (``g / norm * max_norm`` when
  ``norm >= max_norm``, no epsilon: not ``clip_grad_norm_``, which scales
  by ``max_norm / (norm + 1e-6)``), then ``torch.optim.SGD`` adds
  ``wd * p``, keeps the momentum trace (no dampening, no Nesterov) and
  steps by ``-lr``.
- Each stage's trainable set is computed afresh (the intended schedule);
  ``sticky_freeze`` reproduces the reference's effective behaviour, where a
  stage can only shrink the trainable set.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Mapping, Sequence, Union

import torch
from torch import nn

GLM_PREFIX = "GLM_modual."
_FPN_HEAD = re.compile(r"fpn\.P[2-5]_conv[12]\.")


def _heads(name: str) -> bool:
    return name.startswith(("rpn.", "classifier.", "mask.")) or bool(_FPN_HEAD.match(name))


def _from(*stages: int) -> Callable[[str], bool]:
    prefixes = tuple(f"fpn.C{k}." for k in stages)
    return lambda name: _heads(name) or name.startswith(prefixes)


STAGES: Dict[str, Callable[[str], bool]] = {
    "heads": _heads,
    "5+": _from(5),
    "4+": _from(4, 5),
    "3+": _from(3, 4, 5),
    "all": lambda name: True,
    "mask": lambda name: name.startswith("mask."),
}

Stage = Union[str, Callable[[str], bool], Mapping[str, bool]]


def parameter_names(model: Union[nn.Module, Iterable[str]]) -> List[str]:
    if isinstance(model, nn.Module):
        return [name for name, _ in model.named_parameters()]
    return list(model)


def trainable_mask(model: Union[nn.Module, Iterable[str]], stage: Stage) -> Dict[str, bool]:
    """{parameter name: trained in ``stage``}. ``stage`` is a stage name,
    a predicate over names, or a mask (returned as it is)."""
    if isinstance(stage, Mapping):
        return dict(stage)
    pred = STAGES[stage] if isinstance(stage, str) else stage
    return {name: not name.startswith(GLM_PREFIX) and bool(pred(name))
            for name in parameter_names(model)}


class StageSchedule:
    """The reference's three stages: heads x2 epochs, 4+ x3 epochs, all x1
    epoch at lr / 10."""

    def __init__(self, learning_rate: float, sticky_freeze: bool = False):
        self.stages: List[tuple] = [
            ("heads", learning_rate, 2),
            ("4+", learning_rate, 3),
            ("all", learning_rate / 10.0, 1),
        ]
        self.sticky_freeze = sticky_freeze

    def stage_mask(self, model: Union[nn.Module, Iterable[str]],
                   stage_idx: int) -> Dict[str, bool]:
        names = parameter_names(model)
        mask = trainable_mask(names, self.stages[stage_idx][0])
        if self.sticky_freeze:
            for prev in range(stage_idx):
                prev_mask = trainable_mask(names, self.stages[prev][0])
                mask = {k: v and prev_mask[k] for k, v in mask.items()}
        return mask


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` when the global norm is ``>= max_norm`` (else
    ``g / 1 * 1``). Returns the norm (a tensor: no host synchronisation).
    Multi-tensor kernels: a few launches for all the gradients, not a few
    per gradient."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


class StagedSGD:
    """One stage's optimizer over ``model`` (the JAX package's
    ``make_optimizer``: clip(5.0) -> + wd * p -> momentum -> -lr): sets
    ``requires_grad`` by the stage's mask (the rest of the model takes no
    gradient), and steps as the optax chain does. A new stage takes a new
    one, with fresh momentum."""

    def __init__(self, model: nn.Module, stage: Stage, learning_rate: float,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 clip_norm: float = 5.0):
        self.mask = trainable_mask(model, stage)
        self.params = []
        for name, p in model.named_parameters():
            p.requires_grad_(self.mask[name])
            if self.mask[name]:
                self.params.append(p)
        self.clip_norm = clip_norm
        self.sgd = torch.optim.SGD(self.params, lr=learning_rate, momentum=momentum,
                                   dampening=0.0, weight_decay=weight_decay,
                                   nesterov=False)

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, decay, momentum, step; returns the gradient's global norm.
        A trained parameter the loss did not reach steps with a zero
        gradient, as in optax (weight decay and momentum still apply)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in self.params], self.clip_norm)
        self.sgd.step()
        return norm

    def state_dict(self) -> dict:
        return self.sgd.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state)
