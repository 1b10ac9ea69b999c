"""Host milliseconds of the program's ``detector.upload`` spans (host-to-device copy) per request."""

from h100bench.program_spans import ms_per_dispatch


def read(records):
    return ms_per_dispatch(records, "detector.upload")
