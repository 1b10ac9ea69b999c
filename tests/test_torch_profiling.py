"""The port's ``utils/profiling.py`` (``torch.profiler``) against the JAX
package's (``jax.profiler``): the ``StepProfiler`` cases of
``tests/test_observability.py`` and ``tests/test_checkpoint_state.py`` with
summaries of the same keys, ``trace`` and ``annotate``, and ``cli.train
evaluate --trace_dir`` on a 64² synthetic set."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import make_synthetic_dataset
from sln_amodal_tpu.utils import profiling as jax_profiling
from sln_amodal_tpu_torch.cli import train as port_train
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import init_params
from sln_amodal_tpu_torch.utils import profiling
from sln_amodal_tpu_torch.utils.synthetic import detection_biased_variables
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse)

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33, pre_nms_limit=200,
           post_nms_rois_inference=32, detection_max_instances=8, mask_pool_size=2,
           compute_dtype="float32", param_dtype="float32")


def run_both(sync_every, steps):
    port, ref = profiling.StepProfiler(sync_every), jax_profiling.StepProfiler(sync_every)
    got = [port.step(torch.ones(4)) for _ in range(steps)]
    want = [ref.step(jnp.ones((4,))) for _ in range(steps)]
    return port, ref, got, want


def test_step_profiler_sync_and_summary():
    port, ref, got, want = run_both(2, 4)
    assert got[0] is None and want[0] is None      # step 1: off-cycle, no measurement
    assert got[1] is not None and got[1] >= 0      # step 2: sync + measure
    assert [g is None for g in got] == [w is None for w in want]
    s = port.summary()
    assert set(s) == set(ref.summary()) == {"mean_step_s", "p50_step_s", "p95_step_s",
                                             "steps_per_s"}
    assert s["steps_per_s"] > 0 and len(port.times) == len(ref.times) == 2


def test_step_profiler_empty_summary():
    assert profiling.StepProfiler().summary() == jax_profiling.StepProfiler().summary() == {}


def test_step_profiler_six_steps():
    port, ref, _, _ = run_both(2, 6)
    s = port.summary()
    assert s["mean_step_s"] >= 0 and "steps_per_s" in s
    assert set(s) == set(ref.summary()) and len(port.times) == 3


def test_step_profiler_takes_nested_results():
    """``step`` waits on the first tensor of a nest (a dict, a tuple); a
    result without a tensor only times."""
    p = profiling.StepProfiler(sync_every=1)
    assert p.step({"loss": torch.ones(()), "n": 3}) >= 0
    assert p.step((1, [torch.zeros(2)])) >= 0
    assert p.step(None) >= 0 and p.step("no tensor") >= 0
    assert len(p.times) == 4


def test_annotate_usable_as_context():
    with profiling.annotate("test-region"):
        torch.ones(2).sum()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), cuda=False):
        with profiling.annotate("region-of-interest"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "region-of-interest" in names and "aten::mm" in names


@pytest.fixture(scope="module")
def biased_template():
    return detection_biased_variables(init_params(Config(**CFG), seed=0, device="cpu"))


def test_evaluate_trace_dir_writes_a_trace(biased_template, tmp_path, monkeypatch):
    """``evaluate --trace_dir`` on the CPU: a trace that holds the kernels'
    custom ops, and the results and sweeps of the run without it."""
    root = make_synthetic_dataset(str(tmp_path / "data"), n_images=3, size=64, subset="val")
    monkeypatch.setattr(port_train, "inference_config",
                        lambda **kw: Config(**dict(CFG, name=kw.get("name", "coco"))))
    monkeypatch.setattr(port_train, "init_params",
                        lambda config, seed=0, device="cuda": dict(biased_template))
    argv = ["evaluate", "--dataset", root, "--model", "random", "--eval_batch", "2",
            "--device", "cpu"]
    plain = port_train.main(argv)
    trace_dir = tmp_path / "trace"
    traced = port_train.main(argv + ["--trace_dir", str(trace_dir)])
    assert len(plain.results) > 0 and traced.results == plain.results
    assert all(np.array_equal(traced.stats[k], plain.stats[k]) for k in plain.stats)
    files = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # two batches: the proposals' NMS, both RoIAligns
    assert {"sln_amodal::nms_sorted_batched", "sln_amodal::roi_align"} <= names
    assert os.path.getsize(files[0]) > 0
