"""Tracing and step timing: the port's counterpart of the JAX package's
``utils/profiling.py`` (``jax.profiler`` there, ``torch.profiler`` here).

- :func:`trace` — a context manager that records a run with
  ``torch.profiler`` and writes a Chrome / TensorBoard trace;
- :func:`annotate` — a named region that shows in the trace;
- :class:`StepProfiler` — wall-clock step statistics with a device
  synchronize every ``sync_every`` steps (step timing without a trace).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None) -> Iterator[torch.profiler.profile]:
    """Record the host ops, and with ``cuda`` (default: a card is
    present) the card's kernels and copies, of the ``with`` block; on exit
    write ``<worker>.<time>.pt.trace.json`` into ``log_dir``
    (``chrome://tracing``, Perfetto or TensorBoard's profiler plugin)."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """A named region of the trace: ``with profiling.annotate("step"): ...``."""
    return torch.profiler.record_function(name)


def _first_tensor(result) -> Optional[torch.Tensor]:
    for leaf in torch.utils._pytree.tree_leaves(result):
        if isinstance(leaf, torch.Tensor):
            return leaf
    return None


class StepProfiler:
    """Rolling step-time statistics with explicit sync points."""

    def __init__(self, sync_every: int = 10):
        self.sync_every = sync_every
        self.times: list[float] = []
        self._last = time.perf_counter()
        self._step = 0

    def step(self, result=None) -> Optional[float]:
        """Call once per step; every ``sync_every`` steps, wait for the
        device of the first tensor in ``result`` (a tensor or a nest of
        them) and return the mean seconds per step since the last sync."""
        self._step += 1
        if self._step % self.sync_every:
            return None
        tensor = _first_tensor(result)
        if tensor is not None and tensor.device.type == "cuda":
            torch.cuda.synchronize(tensor.device)
        now = time.perf_counter()
        dt = (now - self._last) / self.sync_every
        self._last = now
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_step_s": float(arr.mean()),
            "p50_step_s": float(np.percentile(arr, 50)),
            "p95_step_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / arr.mean()),
        }
