"""Spans around the program's layers, and the reduction of a
``torch.profiler`` stretch to device busy time, kernel times and idle gaps.

Spans are recorded only in a traced run (``--trace 1``), from the
benchmark's own wrappers around named methods and functions of the
program objects a driver built: the program itself is not edited. Each
span also opens a ``torch.profiler.record_function`` range, so that the
profiled stretch can say what the host was doing in each idle gap of the
device.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

SPAN_PREFIX = "bench:"
NAME_CHARS = 160          # a kernel's name in the breakdown, cut to this length


class Spans:
    """Recorded spans: (name, start, end) on ``time.perf_counter``."""

    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self._undo: List[Callable[[], None]] = []

    def wrap(self, owner, attr: str, name: str) -> None:
        """Record a span named ``name`` around every call of
        ``owner.attr`` (a module function or an instance's method)."""
        inner = getattr(owner, attr)
        had_own = attr in vars(owner)

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(SPAN_PREFIX + name):
                t0 = time.perf_counter()
                try:
                    return inner(*args, **kwargs)
                finally:
                    self.records.append((name, t0, time.perf_counter()))

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, inner) if had_own
                          else delattr(owner, attr))

    def unwrap(self) -> None:
        while self._undo:
            self._undo.pop()()

    def between(self, t0: float, t1: float) -> List[Tuple[str, float, float]]:
        return [r for r in self.records if r[1] >= t0 and r[2] <= t1]


def union_length(intervals: Sequence[Tuple[float, float]]) -> Tuple[float, list]:
    """(total length of the union of intervals, the merged intervals)."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce_profile(events, stretch: str = SPAN_PREFIX + "stretch") -> Dict:
    """The profiled stretch from ``torch.profiler``'s events: its length,
    the device's busy seconds (the union of kernels and copies inside it),
    seconds and launches per device operation, and the idle gaps, each
    named by the innermost benchmark span open on the host at its middle.
    Times are in seconds; the events' are microseconds."""
    device, host = [], []
    window = None
    for e in events:
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith(SPAN_PREFIX):
            if e.device_type == torch.autograd.DeviceType.CUDA:
                continue            # the profiler's copy of a host range on the device
            if e.name == stretch:
                window = (start, end)
            else:
                host.append((e.name[len(SPAN_PREFIX):], start, end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((e.name, start, end))
    if window is None:
        raise RuntimeError("the profiled stretch has no range")
    t0, t1 = window
    inside = [(n, max(a, t0), min(b, t1)) for n, a, b in device if b > t0 and a < t1]
    busy, merged = union_length([(a, b) for _, a, b in inside])
    ops: Dict[str, List[float]] = {}
    for name, a, b in inside:
        rec = ops.setdefault(name, [0.0, 0])
        rec[0] += b - a
        rec[1] += 1
    gaps = []
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            open_spans = [(s1 - s0, n) for n, s0, s1 in host if s0 <= mid <= s1]
            gaps.append((min(open_spans)[1] if open_spans else "host", b - a))
    return {"window_s": t1 - t0, "busy_s": busy, "ops": ops,
            "gaps": sorted(gaps, key=lambda g: -g[1])}


@contextlib.contextmanager
def profiled(out: Dict):
    """Profile the block's CPU and CUDA activity; fill ``out`` with
    :func:`reduce_profile`'s reduction."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    acts += [torch.profiler.ProfilerActivity.CUDA] if cuda else []
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "stretch"):
            yield
            if cuda:
                torch.cuda.synchronize()
    out.update(reduce_profile(prof.events()))


def breakdown(profile: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the ten longest idle gaps by what the host was doing."""
    ops = sorted(profile["ops"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[name[:NAME_CHARS], secs] for name, (secs, _) in ops],
            "idle_gaps": [[name, secs] for name, secs in profile["gaps"][:10]]}
