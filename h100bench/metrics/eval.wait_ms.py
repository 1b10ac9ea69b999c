"""Host milliseconds of the program's ``detector.wait`` spans (host blocked on the card) per batch."""

from h100bench.program_spans import ms_per_dispatch


def read(records):
    return ms_per_dispatch(records, "detector.wait")
