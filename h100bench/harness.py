"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the correctness check and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``configs/<config>.json``, ``traffic/<traffic>.json``
(whose ``kind`` names the driver ``drivers/<kind>.py``),
``metrics/<metric>.py`` and ``limits/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import judge, trace

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sln_amodal_tpu")


class RunFailed(RuntimeError):
    """A run that prints no result."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def spec() -> Dict:
    return load_json(REPO / "BENCHMARK.json")


def workload(name: str, bench: Optional[Dict] = None) -> Dict:
    for w in (bench or spec())["workloads"]:
        if w["name"] == name:
            return w
    raise RunFailed(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> Dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def traffic_file(name: str) -> Dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def limits_file(name: str) -> Dict[str, float]:
    return load_json(ROOT / "limits" / f"{name}.json")


def driver(kind: str):
    return importlib.import_module(f"h100bench.drivers.{kind}")


def reader(metric: str):
    path = ROOT / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"h100bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def port_config(cfg: Dict):
    """The program's ``Config`` with the configuration file's fields."""
    from sln_amodal_tpu_torch.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in cfg.items() if k in names})


def quantile(values: List[float], q: int) -> float:
    """The q-th percentile (1..99) of all values, Python's inclusive method."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")[q - 1])


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def per_layer_names(bench: Dict, name: str, e2e: List[str]) -> List[str]:
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (name in cells) if cells is not None else (m["moves"] in e2e):
            out.append(m["name"])
    return out


def e2e_names(bench: Dict, name: str) -> List[str]:
    return [m["name"] for m in bench["end_to_end"]
            if m.get("workloads") is None or name in m["workloads"]]


@dataclasses.dataclass
class Context:
    """What a driver is given: the configuration (the file's dict and the
    program's ``Config``), the traffic parameters, the seed, the device
    and a scratch directory of the run."""

    name: str
    cfg: Dict
    config: object
    traffic: Dict
    seed: int
    device: torch.device
    scratch: str
    marks: List = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """The end of a part of set-up (the result's ``setup_split``)."""
        self.marks.append((name, time.perf_counter()))


def run_cell(name: str, seed: int, seconds: float, traced: bool, started: float,
             device: str = "cuda", limits: Optional[Dict] = None,
             bench: Optional[Dict] = None, cfg_changes: Optional[Dict] = None,
             traffic_changes: Optional[Dict] = None) -> Dict:
    """One run of workload ``name``; returns the result line's object and
    the numbers compared (``checks``). ``started`` is the process start on
    ``time.perf_counter``. The tests run it on the CPU at a small size
    (``device``, ``cfg_changes``, ``traffic_changes``)."""
    bench = bench or spec()
    cell_spec = workload(name, bench)
    cfg = dict(config_file(cell_spec["config"]), **(cfg_changes or {}))
    traffic = dict(traffic_file(cell_spec["traffic"]), **(traffic_changes or {}))
    limits = limits if limits is not None else limits_file(name)
    scratch = tempfile.mkdtemp(prefix="h100bench-")
    dev = torch.device(device)
    try:
        ctx = Context(name, cfg, port_config(cfg), traffic, seed, dev, scratch)
        ctx.mark("imports")
        cell = driver(traffic["kind"]).Cell(ctx)
        cell.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cell.warm()
        spans = trace.Spans()
        if traced:
            cell.trace_spans(spans)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        profile: Dict = {}
        if hasattr(cell, "run"):          # set-up's last steps, window and stretch in one call
            window = cell.run(seconds, traced)
            profile = cell.profile or {}
        else:
            window = cell.window(seconds)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        if traced and not hasattr(cell, "run"):
            with trace.profiled(profile):
                cell.stretch()
        setup_s = window["t0"] - started
        marks = [("start", started)] + ctx.marks + [("warm_up", window["t0"])]
        spans.unwrap()
        found = forbidden_modules()
        if found:
            raise RunFailed("modules loaded that the port must not load: " + ", ".join(found))
        judged = time.perf_counter()
        readings = cell.judge()
        judged = time.perf_counter() - judged
        numbers = judge.worst(readings)
        correct = judge.verdict(numbers, limits, missing=cell.missing)
        checks = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
        e2e = e2e_names(bench, name)
        metrics = {}
        units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
        if traced:
            records = cell.records(window, spans, profile)
            for metric in per_layer_names(bench, name, e2e):
                value = reader(metric)(records)
                if value is not None:
                    metrics[metric] = {"value": value, "unit": units[metric]}
        else:
            values = dict(window["metrics"], setup_s=setup_s)
            metrics = {k: {"value": values[k], "unit": units[k]} for k in e2e}
        result = {"correct": bool(correct), "attempted": window["attempted"],
                  "failed": window["failed"], "metrics": metrics,
                  "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                             "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                             else "cpu",
                             "count": 1, "memory_peak_bytes": int(peak)}}
        if traced:
            result["device"]["busy_s"] = profile["busy_s"]
            result["device"]["window_s"] = profile["window_s"]
            result["breakdown"] = trace.breakdown(profile)
        result["samples"] = len(readings)
        result["judge_s"] = judged
        result["setup_split"] = {n: b - a for (_, a), (n, b) in zip(marks, marks[1:])}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def set_cache_dirs() -> None:
    """Kernel and extension caches inside the checkout, at fixed paths (the
    port's own nvcc and g++ builds already go to ``build/`` there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ.setdefault("USE_FLAX", "0")

