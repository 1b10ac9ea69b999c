"""The metric arithmetic on synthetic records: percentiles, rates, span
means, the idle share and the roofline."""

from types import SimpleNamespace

import pytest
import torch

from h100bench import flops, harness, readers, trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def event(name, start_us, end_us, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start_us, end=end_us))


def test_quantiles_are_over_all_values():
    values = list(range(1, 101))
    assert harness.quantile(values, 50) == pytest.approx(50.5)
    assert harness.quantile(values, 95) == pytest.approx(95.05)
    assert harness.quantile([7.0], 95) == 7.0


def test_span_means_and_mfu():
    rec = {"spans": [("eval.drain", 0.0, 0.2), ("eval.drain", 1.0, 1.4), ("eval.load", 0, 1)],
           "window": {"images": 50, "wall_s": 2.0}, "flops_per_image": 1e12}
    assert readers.span_ms_per(rec, "eval.drain") == pytest.approx(300.0)
    assert readers.span_ms_per(rec, "nothing") is None
    assert readers.mfu_percent(rec) == pytest.approx(100 * 25e12 / 989e12)


def test_idle_share_counts_overlaps_once_and_names_gaps():
    events = [event("bench:stretch", 0, 1000, CPU), event("bench:eval.drain", 600, 1000, CPU),
              event("bench:stretch", 0, 1000, CUDA),          # the profiler's device copy
              event("k1", 100, 300), event("k2", 250, 400), event("Memcpy HtoD", 450, 500)]
    p = trace.reduce_profile(events)
    assert p["window_s"] == pytest.approx(1e-3)
    assert p["busy_s"] == pytest.approx(350e-6)
    assert readers.idle_percent({"profile": p}) == pytest.approx(65.0)
    assert p["gaps"][0] == ("eval.drain", pytest.approx(500e-6))
    assert p["ops"]["k1"] == [pytest.approx(200e-6), 1]
    bd = trace.breakdown(p)
    assert bd["device_ops"][0][0] == "k1" and len(bd["idle_gaps"]) == 3


def test_nms_roofline_is_bound_over_kernel_time():
    bound, by = flops.nms_bound_s(1, 6000, 1000, 3_000_000)
    assert by == "operations"
    assert bound == pytest.approx(3_000_000 * 15 / 67e12)
    rec = {"profile": {"ops": {"void nms_mask_kernel(float4 const*)": [2e-4, 2],
                               "nms_scan_kernel(int)": [2e-4, 2]}},
           "nms": {"batch": 1, "n": 6000, "max_out": 1000, "pairs_per_image": 3_000_000}}
    assert readers.nms_roofline_percent(rec) == pytest.approx(100 * 2 * bound / 4e-4)
    assert readers.nms_roofline_percent({"profile": {"ops": {}}, "nms": rec["nms"]}) is None
