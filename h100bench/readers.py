"""Arithmetic the per-layer metric readers share. A reader takes the traced
run's records and returns one number, or None where it finds nothing to
read (the harness then leaves the metric out)."""

from __future__ import annotations

from typing import Dict, Optional

from .flops import PEAK_BF16_FLOPS, backward_bound_s, nms_bound_s


def span_ms_per(records: Dict, name: str) -> Optional[float]:
    """Mean wall milliseconds of the window's spans named ``name``."""
    spans = [b - a for n, a, b in records["spans"] if n == name]
    return 1e3 * sum(spans) / len(spans) if spans else None


def mfu_percent(records: Dict) -> Optional[float]:
    """Model FLOPs of the window's completed images over its wall seconds,
    as a share of the H100's dense bfloat16 peak (989 TFLOP/s)."""
    w = records["window"]
    if not w.get("images") or not records.get("flops_per_image"):
        return None
    return 100.0 * records["flops_per_image"] * w["images"] / w["wall_s"] / PEAK_BF16_FLOPS


def idle_percent(records: Dict) -> Optional[float]:
    """The profiled stretch's share with no kernel and no copy on the device."""
    p = records.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def kernel_seconds(records: Dict, names) -> tuple:
    """(device seconds, launches) of the profiled ops whose name contains
    one of ``names``."""
    secs, launches = 0.0, {n: 0 for n in names}
    for op, (s, count) in records.get("profile", {}).get("ops", {}).items():
        for n in names:
            if n in op:
                secs += s
                launches[n] += count
    return secs, launches


def nms_roofline_percent(records: Dict) -> Optional[float]:
    """The NMS kernels' least time over their device time in the profiled
    stretch: one bound per call (a call is one scan launch)."""
    nms = records.get("nms")
    secs, launches = kernel_seconds(records, ("nms_mask_kernel", "nms_scan_kernel"))
    calls = launches["nms_scan_kernel"]
    if not nms or not nms.get("pairs_per_image") or not calls or secs <= 0:
        return None
    bound, _ = nms_bound_s(nms["batch"], nms["n"], nms["max_out"],
                           nms["pairs_per_image"] * nms["batch"])
    return 100.0 * bound * calls / secs


def h2d_ms_per_step(records: Dict) -> Optional[float]:
    """Device milliseconds of host-to-device copies per profiled step."""
    secs = sum(s for op, (s, _) in records.get("profile", {}).get("ops", {}).items()
               if "Memcpy HtoD" in op)
    steps = records.get("stretch_steps")
    return 1e3 * secs / steps if steps and records.get("profile") else None


def backward_roofline_percent(records: Dict) -> Optional[float]:
    """The RoIAlign backward kernels' least time over their device time in
    the profiled steps: each op call (a fold and a gather launch) bounded
    by :func:`backward_bound_s`, one call per pool size per step."""
    b = records.get("backward")
    secs, launches = kernel_seconds(records, ("roi_align_backward_fold",
                                              "roi_align_backward_gather"))
    calls = launches["roi_align_backward_fold"]
    if not b or not calls or secs <= 0:
        return None
    per_step = sum(backward_bound_s(b["batch"], b["rois"], pool, b["levels"],
                                    b["bytes_per_element"])[0] for pool in b["pools"])
    return 100.0 * per_step * calls / len(b["pools"]) / secs
