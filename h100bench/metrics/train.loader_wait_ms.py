"""Host milliseconds the step loop waited for each batch of the loader."""

from h100bench.readers import span_ms_per


def read(records):
    return span_ms_per(records, "train.wait")
