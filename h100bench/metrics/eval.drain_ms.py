"""Host milliseconds of ``eval.drain`` per call in the window (see drivers)."""

from h100bench.readers import span_ms_per


def read(records):
    return span_ms_per(records, "eval.drain")
