"""Host milliseconds of the program's ``predict.encode`` spans (COCO dicts, RLE) per batch."""

from h100bench.program_spans import ms_per_dispatch


def read(records):
    return ms_per_dispatch(records, "predict.encode")
