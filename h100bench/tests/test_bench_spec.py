"""BENCHMARK.json against the benchmark's contract, and every name it uses
resolved to its file."""

import json
import re

import pytest

from h100bench import harness
from h100bench.reference import trunks

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.spec()


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["h100bench"]
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names += [m["name"] for m in metrics] + [w["traffic"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_every_file(cell):
    w = harness.workload(cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = harness.config_file(w["config"])
    assert cfg["reduced"] == [] and cfg["source"]
    harness.port_config(cfg)
    trunks.load(cfg["backbone"])       # the trunk file, with all it provides
    traffic = harness.traffic_file(w["traffic"])
    assert hasattr(harness.driver(traffic["kind"]), "Cell")
    limits = harness.limits_file(cell)
    assert limits and all(NAME.match(k) and v >= 0 for k, v in limits.items())
    e2e = harness.e2e_names(SPEC, cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.per_layer_names(SPEC, cell, e2e)
    assert layers
    for metric in layers:
        assert callable(harness.reader(metric))


def test_every_config_is_used_and_its_file_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"] == f"h100bench/configs/{c['name']}.json"
