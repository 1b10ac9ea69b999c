"""The proposal NMS kernels' share of their roofline (bound: operations)."""

from h100bench.readers import nms_roofline_percent


def read(records):
    return nms_roofline_percent(records)
