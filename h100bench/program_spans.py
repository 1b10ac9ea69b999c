"""The program's own spans in a run's measured window. The program
(``sln_amodal_tpu_torch.utils.profiling``) keeps its spans in memory, on
``time.perf_counter_ns``; this reads them from the process without
importing the program, so a program without that recorder (an older
checkout) gives nothing to read."""

from __future__ import annotations

import sys
from typing import Dict, Optional

RECORDER = "sln_amodal_tpu_torch.utils.profiling"


def ms_per_dispatch(records: Dict, name: str) -> Optional[float]:
    """Milliseconds of the window's spans named ``name``, summed, per
    ``detector.dispatch`` span of the window: per batch in evaluation, per
    request in detection. None where the program records no spans, where
    its recorder no longer holds the window's start, or where the window
    holds no dispatch."""
    recorder = sys.modules.get(RECORDER)
    if recorder is None or not hasattr(recorder, "spans") \
            or not hasattr(recorder, "oldest_start_ns"):
        return None
    t0, t1 = int(records["window"]["t0"] * 1e9), int(records["window"]["t1"] * 1e9)
    oldest = recorder.oldest_start_ns()
    if oldest is None or oldest > t0:
        return None
    spans = recorder.spans(t0, t1)
    dispatches = sum(1 for s in spans if s.name == "detector.dispatch")
    if not dispatches:
        return None
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) / dispatches / 1e6
