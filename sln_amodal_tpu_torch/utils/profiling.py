"""Tracing: the port's counterpart of the JAX package's
``utils/profiling.py`` (``jax.profiler`` there, ``torch.profiler`` here).

- :func:`span` — a named, timed region of the program, kept in memory by
  a flight recorder that is on by default: the most recent
  :data:`CAPACITY` spans, each with its request id, its parent (the
  innermost span open on the same thread) and small counts such as bytes
  or detections. :func:`spans` reads them back, :func:`clear` empties the
  recorder and :func:`recording` turns it off and on. The inference path
  records ``detector.*`` (``infer.py``, ``utils/image.py``),
  ``predict.*`` (``cli/train.py``) and ``graph.capture`` (``compiled.py``).
- :func:`trace` — a context manager that records a run with
  ``torch.profiler`` and writes a Chrome / TensorBoard trace, and beside
  it ``spans.json``, the spans of the run. While a profiler records, each
  span is also a ``torch.profiler`` host range, on the trace's timeline
  beside the kernels and copies it launched.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

CAPACITY = 65536     # spans kept, the oldest dropped first


class Span(NamedTuple):
    """One recorded span. Times are ``time.perf_counter_ns()``; ``parent``
    is the name of the innermost span open on the same thread when this
    one opened; ``request`` the id given, or the parent's."""

    name: str
    request: Optional[int]
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int
    counts: Dict[str, int]


_RECORDER: "collections.deque[tuple]" = collections.deque(maxlen=CAPACITY)
_RECORDING = True
_profiler_enabled = torch._C._autograd._profiler_enabled
# A host range of torch.profiler. Not ``torch.profiler.record_function``: on
# a card the profiler copies each of its ranges onto the device timeline,
# from the first to the last kernel the range launched, so the host gaps
# between those kernels would read as device time.
_host_range = torch._C._profiler._RecordFunctionFast


class _Thread(threading.local):
    def __init__(self):
        self.open: List["_Open"] = []


_THREAD = _Thread()


class _Open:
    """A span being recorded (see :func:`span`)."""

    __slots__ = ("name", "request", "counts", "parent", "start_ns", "_open", "_range")

    def __init__(self, name: str, request: Optional[int], counts: Dict[str, int]):
        self.name, self.request, self.counts = name, request, counts

    def count(self, **counts: int) -> None:
        """Add counts known only inside the span (``bytes=...``)."""
        self.counts.update(counts)

    def __enter__(self) -> "_Open":
        self._open = stack = _THREAD.open
        if stack:
            outer = stack[-1]
            self.parent = outer.name
            if self.request is None:
                self.request = outer.request
        else:
            self.parent = None
        stack.append(self)
        # a range only while a profiler records: the check costs 0.1 us
        self._range = None
        if _profiler_enabled():
            self._range = _host_range(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._open.pop()
        # a plain tuple here; spans() makes the Span
        _RECORDER.append((self.name, self.request, self.parent, threading.get_ident(),
                          self.start_ns, end_ns, self.counts))


class _Off:
    """The span of a stopped recorder: records nothing."""

    def count(self, **counts: int) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def span(name: str, request: Optional[int] = None, **counts: int):
    """``with span("detector.mold", images=8) as s: ...`` records the block
    as a :class:`Span`; ``s.count(bytes=n)`` adds counts from inside it.
    Without ``request`` the span takes its parent's. With recording off,
    a shared no-op."""
    if not _RECORDING:
        return _OFF
    return _Open(name, request, counts)


def recording(on: bool) -> bool:
    """Turn the recorder on or off; returns whether it was on."""
    global _RECORDING
    was, _RECORDING = _RECORDING, bool(on)
    return was


def spans(start_ns: Optional[int] = None, end_ns: Optional[int] = None) -> List[Span]:
    """The recorded spans that lie wholly inside [start_ns, end_ns]
    (``time.perf_counter_ns()``; None: unbounded), in the order they
    ended."""
    lo = float("-inf") if start_ns is None else start_ns
    hi = float("inf") if end_ns is None else end_ns
    return [Span._make(s) for s in list(_RECORDER) if s[4] >= lo and s[5] <= hi]


def oldest_start_ns() -> Optional[int]:
    """The start of the oldest span the recorder still holds (None when it
    holds none): an interval that begins before it may have lost spans."""
    try:
        return _RECORDER[0][4]
    except IndexError:
        return None


def clear() -> None:
    """Drop every recorded span."""
    _RECORDER.clear()


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None) -> Iterator[torch.profiler.profile]:
    """Record the host ops, and with ``cuda`` (default: a card is
    present) the card's kernels and copies, of the ``with`` block; on exit
    write ``<worker>.<time>.pt.trace.json`` into ``log_dir``
    (``chrome://tracing``, Perfetto or TensorBoard's profiler plugin) and
    ``spans.json``, the spans recorded in the block."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    start_ns = time.perf_counter_ns()
    try:
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
            yield prof
    finally:
        os.makedirs(log_dir, exist_ok=True)
        recorded = spans(start_ns, time.perf_counter_ns())
        with open(os.path.join(log_dir, "spans.json"), "w") as f:
            json.dump({"clock": "time.perf_counter_ns",
                       "spans": [s._asdict() for s in recorded]}, f)
