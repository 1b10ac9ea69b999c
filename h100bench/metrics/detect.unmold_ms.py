"""Host milliseconds of ``detect.unmold`` per call in the window (see drivers)."""

from h100bench.readers import span_ms_per


def read(records):
    return span_ms_per(records, "detect.unmold")
