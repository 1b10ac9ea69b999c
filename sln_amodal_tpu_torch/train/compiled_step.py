"""The train step as one captured CUDA graph per key: the port's counterpart
of the JAX package's ``jax.jit(step_fn, donate_argnums=(0,))``
(``train/trainer.py:185-200``), which runs the forward, the losses, the
gradient and the update as one compiled program and updates the donated
state in place.

A :class:`CapturedStep` runs one stage's step. Its key is (the accumulation
phase, ``StagedSGD.mini_step`` before the step; the shapes and dtypes of the
batch's six tensors and of the two uniform rows of the target layer's
draws): with ``accumulate_steps = k`` there are k keys per shape, k - 1
micro-steps that only accumulate and the one that clips and steps. The
object belongs to the stage's optimizer; ``Trainer.train_stage`` makes one
per stage and drops it when the stage ends. Per key:

1. The first call runs the eager step on the side stream. It is that
   batch's real step: its update counts. It makes what a step makes once:
   the SGD momentum (at the first update), the constants the step keeps on
   the device, cuDNN's and cuBLAS's choices and workspaces.
2. The second call copies the batch and the uniforms into the key's static
   buffers, sets every ``.grad`` to None (so the captured backward assigns
   the gradients rather than adding to them), captures the whole step (the
   training graph, the losses, the backward, the all-reduces of an NCCL
   process group, the clipped SGD update) and replays it at once: a capture
   runs nothing.
3. Every later call copies the inputs into the static buffers, replays,
   and copies the detached losses out on the same stream.

The parameters, the momentum and the accumulator are updated in place by
every replay: they are the graph's donated state, made outside its memory
pool, and nothing may replace one of those tensors while the stage's
graphs live (a checkpoint only reads them; a resumed state is restored
before the first step). The graphs of one stage share one memory pool:
their replays follow the order of their captures (the micro-steps in turn),
and nothing a replay leaves in the pool is read after the next one (the
losses are copied out; the state lies outside the pool). Between two steps
``.grad`` is the pool's, not a result to read.

The side stream, the pool and the capture itself are
``compiled.CudaGraphs``'s, as for the detect program.

There is no fallback: a capture that fails raises, naming its key. On the
CPU there is no graph, and in a process group whose collectives cannot be
captured (gloo copies through the host) the step runs eagerly; the choice
is made from the group's backend when the stage starts and is logged.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence

import torch

from ..compiled import CudaGraphs, capture_failed
from ..parallel import multihost
from ..utils.logging import log


def collectives_capturable() -> bool:
    """Whether the process group's collectives (if there is a group) can be
    captured in a CUDA graph: NCCL's can, gloo's cannot."""
    return multihost.backend() in (None, "nccl")


class _Entry(NamedTuple):
    replay: Callable[[], None]
    mini_step: int             # the optimizer's micro-step after the step


class CapturedStep:
    """One stage's train step, captured once per key and replayed (see the
    module docstring). ``step_fn(batch, (pos_uniform, neg_uniform))`` is
    the eager step on tensors on ``device``; it returns its losses as a
    dict of 0-d tensors. ``graphs`` runs and captures (the stage's
    ``compiled.CudaGraphs``, or a stand-in in the tests). ``captures``
    counts the captures made and ``capture_seconds`` holds each key's."""

    def __init__(self, step_fn: Callable, optimizer, graphs, device):
        self.step_fn = step_fn
        self.optimizer = optimizer
        self.graphs = graphs
        self.device = torch.device(device)
        self.captures = 0
        self.capture_seconds: Dict = {}
        self._static: Dict = {}      # input shapes -> (batch buffers, uniform buffers)
        self._entries: Dict = {}     # key -> _Entry
        self._eager_keys = set()     # keys whose first call has run
        self._names = None           # the losses' names, sorted
        self._losses = None          # the graphs' output: the losses in that order

    def keys(self):
        """The keys of the captured graphs, in the order of their captures."""
        return list(self._entries)

    def __call__(self, batch: Mapping[str, torch.Tensor],
                 uniforms: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` (tensors on the host or on the device) with
        the target layer's ``uniforms``; returns the detached losses."""
        shapes = (tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items())
                  + tuple((tuple(u.shape), u.dtype) for u in uniforms))
        static = self._static.get(shapes)
        if static is None:
            static = self._static[shapes] = (
                {k: torch.empty(shape, dtype=dtype, device=self.device)
                 for k, shape, dtype in shapes[:len(batch)]},
                tuple(torch.empty(u.shape, dtype=u.dtype, device=self.device)
                      for u in uniforms))
        buffers, draws = static
        for k, v in batch.items():
            buffers[k].copy_(v, non_blocking=True)
        for buf, u in zip(draws, uniforms):
            buf.copy_(u, non_blocking=True)
        key = (self.optimizer.mini_step, shapes)
        entry = self._entries.get(key)
        if entry is None:
            if key not in self._eager_keys:
                self._eager_keys.add(key)
                losses = self.graphs.run_side(lambda: self.step_fn(buffers, draws), self.device)
                if self._names is None:
                    self._names = sorted(losses)
                    self._losses = torch.empty(len(self._names), dtype=losses[self._names[0]].dtype,
                                               device=self.device)
                return losses
            entry = self._capture(key, buffers, draws)
        entry.replay()
        self.optimizer.mini_step = entry.mini_step
        return dict(zip(self._names, self._losses.clone().unbind()))

    def _capture(self, key, buffers, draws) -> _Entry:
        def step():
            losses = self.step_fn(buffers, draws)
            self._losses.copy_(torch.stack([losses[k] for k in self._names]))

        after = (key[0] + 1) % self.optimizer.accumulate_steps
        self.optimizer.zero_grad()
        t = time.perf_counter()
        try:
            replay, _ = self.graphs.capture_only(step, self.device)
        except Exception as err:
            raise capture_failed(f"the train step for key {key}", err) from err
        self.capture_seconds[key] = time.perf_counter() - t
        self.captures += 1
        entry = self._entries[key] = _Entry(replay, after)
        return entry


def stage_step(step_fn: Callable, optimizer, device) -> Optional[CapturedStep]:
    """The stage's :class:`CapturedStep` on ``device``, or None where the
    step runs eagerly: where ``CudaGraphs`` does not capture (the CPU), and
    in a process group whose collectives cannot be captured. On a card the
    choice is logged."""
    if not CudaGraphs.captures_on(device):
        return None
    backend = multihost.backend()
    if not collectives_capturable():
        log(f"  train step: eager (a {backend} process group's collectives cannot be "
            "captured in a CUDA graph)")
        return None
    log("  train step: captured as a CUDA graph per shape and micro-step"
        + (f" ({backend} process group)" if backend else ""))
    return CapturedStep(step_fn, optimizer, CudaGraphs(), device)
