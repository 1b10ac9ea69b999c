"""One captured CUDA graph per input shape: the port's counterpart of the
JAX package's ``infer.py::_jitted_infer``, which runs ``detect`` as one
compiled XLA program per (config, mode, mesh) (``jax.jit``, kept by
``functools.lru_cache(maxsize=16)``).

A :class:`CapturedProgram` wraps a callable on tensors. On CUDA inputs, the
first call for a shape key runs the callable once on a side stream (the
warm-up: cuDNN and cuBLAS make their choices, constants built at first use
such as the bfloat16 resize weights are made), then captures it once into a
``torch.cuda.CUDAGraph`` that reads static input buffers. Every call copies
its inputs into those buffers, replays the graph and copies the outputs out
of the graph's buffers into fresh tensors on the same stream: a caller may
hold a call's outputs while it makes the next call (the evaluate loop
dispatches batch N + 1 before it collects batch N), and the graphs of one
owner share one memory pool, so a later replay of any of them may reuse
those buffers. The upload into the static inputs and that copy are the only
work outside the graph.

There is no fallback: a capture that fails raises, naming the shape key.
On the CPU there is no graph; the callable runs as it is. The device of the
inputs decides, as it does for the kernels.

The wrapped callable must be capturable: no host synchronisation, no
pageable host-to-device copy and no allocation the caching allocator does
not make, after the warm-up. Kernel launches through ``cuda_build`` read the
current stream at each call, so they land in the graph.
"""

from __future__ import annotations

import collections
import gc
from typing import Callable, Hashable, NamedTuple, Tuple

import torch

from .utils import profiling

MAX_ENTRIES = 16   # the JAX package's lru_cache(maxsize=16)


def capture_failed(what: str, err: Exception) -> RuntimeError:
    """The error that a failed capture of ``what`` raises. A failure inside
    the capture surfaces again at its end: it names both."""
    cause = err.__context__
    return RuntimeError(f"capturing {what} failed: {type(err).__name__}: {err}"
                        + (f" (after {type(cause).__name__}: {cause})" if cause else ""))


class CudaGraphs:
    """Runs and captures callables for the graphs of one owner (a
    ``Detector``'s replicas and shapes, a training stage's step): one side
    stream per device, and one memory pool that the owner's graphs share,
    made at the first capture. Sharing is safe where every replay's outputs
    are copied out before the next replay is enqueued on the stream.

    Captures run in ``thread_local`` mode: only the capturing thread's
    unsafe CUDA calls fail them, as other threads work on the card
    meanwhile (``DevicePrepLoader``'s thread builds the next batch on its
    own stream, a process group's watchdog polls its events)."""

    def __init__(self):
        self._pool = None
        self._streams = {}

    @staticmethod
    def captures_on(device: torch.device) -> bool:
        return torch.device(device).type == "cuda"

    def _side(self, device: torch.device):
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        return side

    def run_side(self, fn: Callable, device: torch.device):
        """``fn()`` on the side stream of ``device``, after the current
        stream's work so far and before its later work."""
        with torch.cuda.device(device):
            current, side = torch.cuda.current_stream(), self._side(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = fn()
            current.wait_stream(side)
        return out

    def capture_only(self, fn: Callable, device: torch.device, inputs: tuple = ()):
        """Capture ``fn(*inputs)`` on the side stream of ``device`` into a
        new ``torch.cuda.CUDAGraph`` (a capture runs nothing); returns
        (replay, ``fn``'s outputs: the graph's tensors). First, as
        ``torch.cuda.graph`` does, the garbage is collected and the caching
        allocator's free blocks are returned to the card: the graph's pool
        cannot draw on blocks that eager work left cached (a batch-8 train
        step's capture ran out of memory beside 45 GB of them). Recorded as
        a ``graph.capture`` span: one in a steady loop means a graph was
        built again."""
        with profiling.span("graph.capture"), torch.cuda.device(device):
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # capture_begin/end by hand, not ``torch.cuda.graph``: its exit
            # leaves the capture stream current when the capture fails
            with torch.cuda.stream(self._side(device)):
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    outputs = fn(*inputs)
                finally:
                    graph.capture_end()

        def replay():
            with torch.cuda.device(device):
                graph.replay()

        return replay, outputs

    def capture(self, fn: Callable, inputs: Tuple[torch.Tensor, ...]):
        """Warm ``fn`` up on ``inputs`` on the side stream, then capture it;
        returns (replay, the graph's output tensors)."""
        device = inputs[0].device
        self.run_side(lambda: fn(*inputs), device)
        return self.capture_only(fn, device, inputs)


class _Entry(NamedTuple):
    inputs: Tuple[torch.Tensor, ...]   # the graph's static input buffers
    replay: Callable[[], None]
    outputs: tuple                     # the graph's output tensors


class CapturedProgram:
    """``fn`` captured once per shape key and replayed (see the module
    docstring). ``graphs`` captures (``CudaGraphs``, shared by the programs
    of one owner, or a stand-in in the tests). At most ``MAX_ENTRIES``
    graphs are kept, the least recently used dropped first.

    ``fn`` returns a tuple or a named tuple of tensors; a call returns the
    same type holding copies of them. ``captures`` counts the captures
    made."""

    def __init__(self, fn: Callable, graphs):
        self.fn = fn
        self.graphs = graphs
        self.captures = 0
        self._entries: "collections.OrderedDict[Hashable, _Entry]" = collections.OrderedDict()

    def keys(self):
        """The shape keys of the kept graphs, least recently used first."""
        return list(self._entries)

    def __call__(self, key: Hashable, *inputs: torch.Tensor):
        """``fn(*inputs)``; ``key`` names what the graph depends on beyond
        the inputs' shapes, dtypes and devices (which join it here)."""
        if not self.graphs.captures_on(inputs[0].device):
            return self.fn(*inputs)
        key = (key, tuple((tuple(x.shape), x.dtype, x.device) for x in inputs))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._capture(key, inputs)
        else:
            self._entries.move_to_end(key)
            for buf, x in zip(entry.inputs, inputs):
                buf.copy_(x)
        entry.replay()
        copies = [out.clone() for out in entry.outputs]
        kind = type(entry.outputs)
        return kind(*copies) if hasattr(kind, "_fields") else kind(copies)

    def _capture(self, key, inputs) -> _Entry:
        static = tuple(x.clone() for x in inputs)
        try:
            replay, outputs = self.graphs.capture(self.fn, static)
        except Exception as err:
            raise capture_failed(f"the program for shape key {key}", err) from err
        entry = self._entries[key] = _Entry(static, replay, outputs)
        self.captures += 1
        while len(self._entries) > MAX_ENTRIES:
            self._entries.popitem(last=False)
        return entry
