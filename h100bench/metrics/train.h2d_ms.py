"""Device milliseconds of host-to-device copies per profiled training step."""

from h100bench.readers import h2d_ms_per_step


def read(records):
    return h2d_ms_per_step(records)
