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
- In a data-parallel run the gradients are averaged over the processes
  before the clip (the JAX step clips the psum-averaged gradient).
- ``accumulate_steps = k > 1`` is ``optax.MultiSteps(every_k_schedule=k)``
  (optax 0.2.6, ``transforms/_accumulation.py``): a running mean of the
  gradients, ``acc + (g - acc) / (mini_step + 1)``, and the clipped SGD
  step on that mean on every k-th micro-step only; on the others the
  parameters and the momentum stay as they are. The reference steps its
  optimizer once every BATCH_SIZE micro-batches (``model.py:442-448``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Union

import torch
from torch import nn

from ..parallel import multihost

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
    ``make_optimizer``: clip(5.0) -> + wd * p -> momentum -> -lr, wrapped in
    ``optax.MultiSteps`` when ``accumulate_steps > 1``): sets
    ``requires_grad`` by the stage's mask (the rest of the model takes no
    gradient and has no accumulator), and steps as the optax chain does. A
    new stage takes a new one, with fresh momentum."""

    def __init__(self, model: nn.Module, stage: Stage, learning_rate: float,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 clip_norm: float = 5.0, accumulate_steps: int = 1):
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, not {accumulate_steps}")
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
        self.accumulate_steps = accumulate_steps
        self.mini_step = 0
        # the running mean of the gradients, one tensor per trained parameter
        self.accumulated = ([torch.zeros_like(p) for p in self.params]
                            if accumulate_steps > 1 else None)

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> Optional[torch.Tensor]:
        """Average over the processes, accumulate, then on the k-th
        micro-step clip, decay, momentum, step; returns the global norm of
        the gradient stepped with (None on a micro-step that does not step).
        A trained parameter the loss did not reach steps with a zero
        gradient, as in optax (weight decay and momentum still apply)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if multihost.is_distributed():
            multihost.all_reduce_mean_(grads)
        if self.accumulated is not None:
            with torch.no_grad():
                acc = self.accumulated
                count = torch.tensor(self.mini_step + 1, dtype=acc[0].dtype,
                                     device=acc[0].device)
                torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(grads, acc),
                                                            count))
            self.mini_step = (self.mini_step + 1) % self.accumulate_steps
            if self.mini_step:
                return None
            torch._foreach_copy_(grads, acc)
            torch._foreach_zero_(acc)
        norm = clip_by_global_norm_(grads, self.clip_norm)
        self.sgd.step()
        return norm

    def state_dict(self) -> dict:
        """The SGD momentum, and the accumulator with its micro-step count."""
        return {"sgd": self.sgd.state_dict(), "mini_step": self.mini_step,
                "accumulated": None if self.accumulated is None else
                [a.detach().cpu() for a in self.accumulated]}

    def load_state_dict(self, state: dict) -> None:
        """Restores :meth:`state_dict`'s layout, or the bare SGD state that
        ``.state`` files held before accumulation (no accumulated
        gradients: micro-step 0)."""
        if "sgd" not in state:
            state = {"sgd": state, "mini_step": 0, "accumulated": None if
                     self.accumulated is None else [torch.zeros_like(p) for p in self.params]}
        self.sgd.load_state_dict(state["sgd"])
        if (state["accumulated"] is None) != (self.accumulated is None):
            raise ValueError("the saved optimizer state and this one disagree on "
                             "gradient accumulation")
        self.mini_step = int(state["mini_step"])
        if self.accumulated is not None:
            with torch.no_grad():
                torch._foreach_copy_(self.accumulated,
                                     [a.to(self.accumulated[0].device)
                                      for a in state["accumulated"]])
