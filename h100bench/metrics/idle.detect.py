"""Share of the profiled stretch in which the device ran nothing."""

from h100bench.readers import idle_percent


def read(records):
    return idle_percent(records)
