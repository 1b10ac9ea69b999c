"""Host milliseconds of the program's ``detector.unmold`` spans per batch."""

from h100bench.program_spans import ms_per_dispatch


def read(records):
    return ms_per_dispatch(records, "detector.unmold")
