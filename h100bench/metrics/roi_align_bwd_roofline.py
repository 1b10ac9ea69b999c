"""The RoIAlign backward kernels' share of their roofline (bound: bytes)."""

from h100bench.readers import backward_roofline_percent


def read(records):
    return backward_roofline_percent(records)
