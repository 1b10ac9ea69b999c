"""The captured-graph path of ``Detector`` (``sln_amodal_tpu_torch/compiled.py``)
on the CPU, where there is no graph.

The capture class is replaced by a stand-in that, as a CUDA graph does,
writes every replay into the same output tensors: a dispatched batch's
outputs must survive the next dispatch, and the cache keys and its bound of
16 behave as the JAX package's ``lru_cache(maxsize=16)`` of jitted
programs. That a CPU ``Detector`` never captures, and still equals the JAX
``Detector``, is held in ``test_torch_slice.py`` on that file's JAX run; the
graph itself is held on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 4).
"""

import numpy as np
import pytest
import torch

from sln_amodal_tpu_torch import compiled, infer
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.infer import Detector
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse fixture)

# small, the GLM elided as the detect-only path allows
CFG = dict(image_size=64, backbone="resnet50", fpn_channels=32, glm_input_size=33,
           glm_scales=(), glm_elide_at_inference=True, pre_nms_limit=200,
           post_nms_rois_inference=32, detection_max_instances=6, mask_pool_size=8,
           compute_dtype="float32", param_dtype="float32")


class StandInGraphs:
    """Captures on any device: ``capture`` runs the program once and keeps
    its outputs; every replay runs it again on the static inputs and
    writes the results into those same tensors, as a CUDA graph's replay
    writes into its buffers."""

    @staticmethod
    def captures_on(device):
        return True

    def capture(self, fn, inputs):
        outputs = fn(*inputs)

        def replay():
            for buf, value in zip(outputs, fn(*inputs)):
                buf.copy_(value)

        return replay, outputs


def images(seed, n=2):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (64, 64, 3), np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def state_dict():
    """Seeded weights (PyTorch's default initialisation, quicker to draw
    than ``convert.init_params``' for the GLM's 56M parameters) whose heads
    detect: spread RPN scores, small box deltas, a foreground-leaning
    classifier."""
    torch.manual_seed(0)
    sd = SLNAmodal(Config(**CFG), device="cpu").state_dict()
    for key, s in (("rpn.conv_class.weight", 1e-3), ("rpn.conv_bbox.weight", 1e-4),
                   ("classifier.linear_class.weight", 1e-2),
                   ("classifier.linear_bbox.weight", 1e-3)):
        sd[key] = sd[key] * s
    sd["classifier.linear_class.bias"][1] = 2.0
    return sd


def test_outputs_outlive_the_next_dispatch(state_dict, monkeypatch):
    """Dispatch A, dispatch B, collect A: A's results, though B's replay
    rewrote the graph's output tensors in between."""
    reference = Detector(Config(**CFG), state_dict, device="cpu")
    a, b = images(1), images(2)
    want_a, want_b = (reference._fetch(reference.dispatch(x)) for x in (a, b))
    assert not np.array_equal(want_a[1], want_b[1])

    monkeypatch.setattr(infer, "CudaGraphs", StandInGraphs)
    det = Detector(Config(**CFG), state_dict, device="cpu")
    pending_a = det.dispatch(a)
    pending_b = det.dispatch(b)
    for pending, want in ((pending_a, want_a), (pending_b, want_b)):
        for got, expected in zip(det._fetch(pending), want):
            np.testing.assert_array_equal(got, expected)
    assert det.programs[0].captures == 1


def test_detector_keys_one_graph_per_shape_and_replica(state_dict, monkeypatch):
    """A graph per (rows, image size, compute dtype, detect_only) and per
    replica: a replica listed twice gets its own."""
    monkeypatch.setattr(infer, "CudaGraphs", StandInGraphs)
    det = Detector(Config(**CFG), state_dict, mesh=("cpu", "cpu"))
    for n in (2, 4, 2, 3):          # blocks of 1, 2, 1, 2 (3 padded to 4) rows
        assert len(det.detect(images(n, n))) == n
    for program in det.programs:
        assert program.captures == 2
        assert [(key, shapes[0][0][0]) for key, shapes in program.keys()] == [
            (("float32", True), 1), (("float32", True), 2)]
        assert program.keys()[0][1][0][0] == (1, 64, 64, 3)
    assert det.programs[0] is not det.programs[1]


def test_cache_keeps_the_16_most_recent_shapes():
    """The bound of the JAX package's ``lru_cache(maxsize=16)``: a 17th
    shape drops the least recently used one, which is captured again
    when it comes back; the caller's key is part of the shape key."""
    program = compiled.CapturedProgram(lambda x: (x * 2, x + 1), StandInGraphs())
    assert compiled.MAX_ENTRIES == 16

    def call(rows, key="k"):
        x = torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3)
        out = program(key, x)
        assert isinstance(out, tuple) and torch.equal(out[0], x * 2)
        return out

    for rows in range(1, 17):
        call(rows)
    assert program.captures == 16
    call(1)                          # a hit: 1 becomes the most recent
    call(17)                         # drops 2, the least recently used
    rows_kept = [shapes[0][0][0] for _, shapes in program.keys()]
    assert program.captures == 17 and len(rows_kept) == 16
    assert rows_kept[-2:] == [1, 17] and 2 not in rows_kept
    call(2)
    assert program.captures == 18
    call(17, key="other")            # same shape, another caller key
    assert program.captures == 19


def test_cpu_inputs_never_capture():
    """With the real capture class, CPU tensors run the callable as it is."""
    calls = []
    program = compiled.CapturedProgram(lambda x: calls.append(x) or (x,), compiled.CudaGraphs())
    x = torch.ones(2)
    out = program("k", x)
    assert out[0] is x and len(calls) == 1 and program.captures == 0 and program.keys() == []


def test_a_failed_capture_raises_with_its_key():
    class Failing(StandInGraphs):
        def capture(self, fn, inputs):
            raise RuntimeError("operation not permitted when stream is capturing")

    program = compiled.CapturedProgram(lambda x: (x,), Failing())
    with pytest.raises(RuntimeError, match=r"shape key .*'k'.*\(2, 3\).*not permitted"):
        program("k", torch.zeros(2, 3))
    assert program.captures == 0 and program.keys() == []
