"""The Swin-S configuration (``configs/sln_swin_s.json``, ``reference/trunks/swin_s.py``)
and its cell ``sln_swin_s.detect-b1``: the trunk file's FLOP count against
``FlopCounterMode``, its part of the weight recipe, the kernel's bound and
the ``window_attn_roofline`` reader, and the cell at a small size on the
CPU."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import flops, harness, weights
from h100bench.reference import trunks
from h100bench.reference.model import Reference
from h100bench.reference.train import trained

from . import tiny
from .test_bench_trunks import SEED, calibration_image

CELL = "sln_swin_s.detect-b1"


def small_cfg():
    return dict(harness.config_file("sln_swin_s"), **tiny.CFG)


def test_published_sizes_and_counts():
    cfg = harness.config_file("sln_swin_s")
    trunk = trunks.load(cfg["backbone"])
    assert [g[:3] for g in trunk.grids(1024)] == [(256, 259, 96), (128, 133, 192),
                                                  (64, 70, 384), (32, 35, 768)]
    assert trunk.blocks() == 24
    layers, levels = trunk.flop_layers(cfg)
    assert levels == [256, 128, 64, 32, 16]
    assert sum(x.flops for x in layers) == 495289542912.0
    assert flops.inference_flops(cfg)["total"] == 1759482704512.0
    bound, what = trunk.window_attention_bound_s(cfg)
    assert what == "bytes" and bound == pytest.approx(443.37e6 / 3.35e12, rel=1e-3)


def test_weights_recipe_and_trained_levels():
    cfg = small_cfg()
    ref = Reference(cfg)
    sd = weights.seeded(ref, SEED, torch.device("cpu"))
    norms = [k for k in sd if k.startswith("fpn.C") and ".norm" in k and k.endswith("weight")]
    assert len(norms) == 56 and all(float(sd[k].min()) == 1.0 for k in norms)
    tables = torch.cat([sd[k].flatten() for k in sd if k.endswith("position_bias_table")])
    assert 0.018 < float(tables.std()) < 0.022
    assert len(trunks.load("swin_s").branches(ref.fpn)) == 48
    names = {n for n, _ in trained(ref, "4+") if n.startswith("fpn.C")}
    assert "fpn.C4.merge.reduction.weight" in names and "fpn.C5.norm.weight" in names
    assert not any(n.startswith(("fpn.C1.", "fpn.C2.", "fpn.C3.")) for n in names)


def test_flop_count_is_the_references():
    """The trunk file's layers, with the shared heads and GLM, equal what
    ``FlopCounterMode`` counts on the calibrated reference's forward."""
    cfg = small_cfg()
    cpu = torch.device("cpu")
    calib = calibration_image(cfg)
    ref = Reference(cfg)
    ref.load_state_dict(weights.inference_weights(cfg, SEED, calib, cpu))
    with FlopCounterMode(display=False) as counter:
        cands, levels, prior = ref.candidates(calib)
        boxes = cands.boxes[cands.detections]
        ref.masks_at(levels, prior, boxes)
    assert torch.isfinite(cands.margin).all() and float(cands.margin.std()) > 0.5
    want = flops.inference_flops(cfg, rois=int(cands.boxes.shape[0]),
                                 detections=int(boxes.shape[0]))
    assert counter.get_total_flops() == pytest.approx(want["total"], rel=1e-9)


def test_roofline_reader():
    read = harness.reader("window_attn_roofline")
    assert read({"profile": {"ops": {}}}) is None
    bound, _ = trunks.load("swin_s").window_attention_bound_s(
        harness.config_file("sln_swin_s"))
    name = "void swin_window_attention_kernel<__nv_bfloat16>(__nv_bfloat16 const*, ...)"
    records = {"profile": {"ops": {name: (4 * bound, 48), "other": (1.0, 3)}}}
    assert read(records) == pytest.approx(50.0)


def test_cell_runs_on_the_cpu():
    """The cell at the tests' size: correct, both end-to-end metrics and
    setup_s untraced; traced, the detect spans and no roofline (the CPU
    runs the op's plain path, no kernel)."""
    r = tiny.run(CELL, seconds=1.0)
    assert r["correct"] and r["samples"] == 2
    assert set(r["metrics"]) == {"detect_ms_p50", "detect_ms_p95", "setup_s"}
    t = tiny.run(CELL, seconds=1.0, traced=True)
    assert t["correct"] and "detect.wait_ms" in t["metrics"]
    assert "window_attn_roofline" not in t["metrics"]
    assert all(math.isfinite(v["value"]) for v in t["metrics"].values())


def test_roofline_reader_is_listed_for_its_configuration_alone():
    """The records do not carry the configuration, so the reader takes its
    bound from one configuration file (``CONFIG``): every cell that lists
    ``window_attn_roofline`` has to run that configuration, or the share
    it reads is silently wrong."""
    bench = harness.spec()
    metric = next(m for m in bench["per_layer"] if m["name"] == "window_attn_roofline")
    config = harness.reader("window_attn_roofline").__globals__["CONFIG"]
    assert metric["workloads"]
    assert {harness.workload(w, bench)["config"] for w in metric["workloads"]} == {config}
