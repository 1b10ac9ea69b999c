"""The program's own spans as the benchmark reads them: the tiny traced
CPU run of each cell reports every metric that reads them; the program's
``predict.drain`` and ``predict.load`` lie inside the benchmark's own
``eval.drain`` and ``eval.load`` spans of the same call, and the
benchmark's ``detect.unmold`` inside the program's ``detector.unmold``
(the program opens that span around the call the benchmark wraps). The
program's span inside covers at least 90% of the benchmark's; the one
around adds at most ``AROUND_NS``, room for the wrapper's own profiler
range, which its clock leaves out (about 0.1 ms on a CPU)."""

import pytest

from h100bench import trace

from .tiny import run

READ = {"sln_r101.eval-b8": ("eval.mold_ms", "eval.wait_ms", "eval.unmold_ms",
                             "eval.encode_ms"),
        "sln_r50.detect-b1": ("detect.mold_ms", "detect.upload_ms", "detect.wait_ms")}
# the benchmark's span -> the program's span of the same call, and whether
# the program's lies inside the benchmark's (else around it)
SAME_CALL = {"sln_r101.eval-b8": {"eval.drain": ("predict.drain", True),
                                  "eval.load": ("predict.load", True)},
             "sln_r50.detect-b1": {"detect.unmold": ("detector.unmold", False)}}
SLACK_NS = 1000     # the benchmark's perf_counter seconds against the program's ns
AROUND_NS = 1_000_000


@pytest.mark.parametrize("cell", sorted(READ))
def test_traced_run_reads_the_program_spans(cell, monkeypatch):
    from sln_amodal_tpu_torch.utils import profiling

    kept = []

    class Kept(trace.Spans):
        def __init__(self):
            super().__init__()
            kept.append(self)

    monkeypatch.setattr(trace, "Spans", Kept)
    profiling.clear()
    r = run(cell, traced=True)
    for name in READ[cell]:
        assert name in r["metrics"], name
        assert r["metrics"][name]["unit"] == "ms" and r["metrics"][name]["value"] >= 0
    assert r["metrics"]["eval.unmold_ms" if "eval" in cell else "detect.mold_ms"]["value"] > 0
    program = profiling.spans()
    (bench,) = kept
    for wrapper, (name, inside) in SAME_CALL[cell].items():
        wrapped = [(int(a * 1e9), int(b * 1e9)) for n, a, b in bench.records if n == wrapper]
        assert wrapped, wrapper
        matched = set()
        for a, b in wrapped:
            if inside:
                (got,) = [s for s in program if s.name == name and a - SLACK_NS <= s.start_ns
                          and s.end_ns <= b + SLACK_NS]
                assert got.end_ns - got.start_ns >= 0.9 * (b - a), (wrapper, got, a, b)
            else:
                (got,) = [s for s in program if s.name == name and s.start_ns <= a + SLACK_NS
                          and b - SLACK_NS <= s.end_ns]
                assert got.end_ns - got.start_ns - (b - a) <= AROUND_NS, (wrapper, got, a, b)
            matched.add((got.thread, got.start_ns))
        assert len(matched) == len(wrapped), wrapper
