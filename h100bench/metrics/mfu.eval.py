"""Model FLOPs of the window over its wall time, share of the bf16 peak."""

from h100bench.readers import mfu_percent


def read(records):
    return mfu_percent(records)
