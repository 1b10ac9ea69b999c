"""The serving artifact of the port (``serve/export.py``,
``cli/export_model.py``): ``torch.export`` of the detect graph, saved,
loaded by ``ServingDetector`` and run, against the port's ``Detector`` (bit
for bit) and the JAX ``Detector`` (the cases of
``tests/test_serve_export.py``).

``test_torch_slice.py``'s reduced configuration (64², ResNet-50, a 33² GLM
input, float64) and its detecting weights, carried by ``params_from_jax``;
one artifact at batch 2 for the file. On the CPU the program runs the
kernels' plain versions: the custom ops are in it as one node each.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.infer import Detector as JaxDetector
from sln_amodal_tpu_torch.cli import export_model
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import params_from_jax
from sln_amodal_tpu_torch.infer import Detector
from sln_amodal_tpu_torch.serve import ServingDetector, export_detector
from sln_amodal_tpu_torch.serve.export import _config_from_manifest
from test_torch_slice import CFG, detecting_variables
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse)

KEYS = ("rois", "class_ids", "scores", "masks")


def images(n, seed=0):
    """Off-size uint8 images: the squash resize of ``mold_inputs`` runs."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (64 + 9, 64 - 7, 3), np.uint8) for _ in range(n)]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def weights():
    variables = detecting_variables()
    return variables, params_from_jax(variables)


@pytest.fixture(scope="module")
def artifact(weights, tmp_path_factory):
    """(directory, loaded ServingDetector) of the batch-2 detect-only
    artifact, deleted after the file's tests (~800 MB of float64)."""
    out = tmp_path_factory.mktemp("artifact")
    export_detector(Config(**CFG), weights[1], str(out), batch=2, device="cpu")
    yield str(out), ServingDetector.load(str(out))
    shutil.rmtree(out)


@pytest.fixture(scope="module")
def direct(weights):
    return Detector(Config(**CFG), weights[1], device="cpu")


def test_round_trip_is_bit_identical(artifact, direct):
    _, served = artifact
    batch = images(2)
    got = served.detect(batch)
    assert sum(len(r["scores"]) for r in got) > 0
    assert_same(got, direct.detect(batch))
    # the device outputs before unmolding too
    for g, w in zip(served._fetch(served.dispatch(batch)), direct._fetch(direct.dispatch(batch))):
        np.testing.assert_array_equal(g, w)


def test_round_trip_matches_the_jax_detector(artifact, weights):
    """As ``test_torch_slice.py``: boxes, class ids and masks equal, scores
    (float32 probabilities in the reference) to float32 rounding."""
    _, served = artifact
    batch = images(2, seed=1)
    with jax.enable_x64(True):
        ref = JaxDetector(JaxConfig(**CFG), weights[0]).detect(batch)
    got = served.detect(batch)
    assert sum(len(r["scores"]) for r in ref) > 0
    for g, r in zip(got, ref):
        for k in ("rois", "class_ids", "masks"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=1e-6, atol=0)


def test_partial_batch_is_padded(artifact, direct):
    _, served = artifact
    one = images(1, seed=3)
    got = served.detect(one)          # padded 1 -> 2 inside, the pad row dropped
    assert len(got) == 1
    assert_same(got, direct.detect(one))
    assert len(served.collect_crops(served.dispatch(one))) == 1


def stub_detector(devices, batch):
    """A ``Detector`` through the initialiser both constructors end in,
    on a stand-in program per device whose detections carry each row's
    frame value (column 5) and record the rows it was given: the pad rule
    with no model and no export. ``batch`` None is ``Detector``'s rule,
    an int a served detector's."""
    calls = []

    def program(images_u8, windows):
        calls.append(images_u8.shape[0])
        detections = torch.zeros((images_u8.shape[0], 2, 6), dtype=torch.float64)
        detections[:, 0, 5] = images_u8[:, 0, 0, 0].to(torch.float64)
        return (detections, detections[..., 4] > 0,
                torch.zeros((images_u8.shape[0], 2, 2, 2, 2)))

    det = Detector.__new__(Detector)
    det._setup(Config(image_size=8), [torch.device("cpu")] * devices, [program] * devices,
               True, ("detections", "det_valid", "masks"), batch=batch,
               mesh=("cpu",) * devices if devices > 1 else None)
    return det, calls


@pytest.mark.parametrize("devices,batch,n,rows", [
    (1, None, 3, 3), (2, None, 1, 2), (2, None, 3, 4), (2, None, 4, 4),
    (1, 2, 1, 2), (1, 2, 2, 2), (2, 4, 1, 4), (2, 4, 3, 4)])
def test_pad_rule_repeats_the_last_table_row(devices, batch, n, rows):
    """``dispatch`` pads a request of ``n`` to ``rows`` (the fixed batch,
    else the next multiple of the devices) by repeating its last image's
    table row: a device uploads a frame once however many of its rows
    repeat it, the resize makes every row, each device gets an even block,
    ``_fetch`` gives every row and ``collect`` only the real images."""
    from sln_amodal_tpu_torch.utils import profiling

    det, calls = stub_detector(devices, batch)
    request = [np.full((8, 8, 3), 10 * (i + 1), np.uint8) for i in range(n)]
    profiling.clear()
    pending = det.dispatch(request)
    assert len(pending.out) == devices and calls == [rows // devices] * devices
    detections, masks = det._fetch(pending)
    assert detections.shape[0] == masks.shape[0] == len(pending.windows) == rows
    assert list(detections[:, 0, 5]) == [10 * (i + 1) for i in range(n)] + [10 * n] * (rows - n)
    spans = {s.name: s for s in profiling.spans()}
    # each device's block uploads each of its distinct frames once
    per = rows // devices
    frames = sum(len({min(r, n - 1) for r in range(i * per, (i + 1) * per)})
                 for i in range(devices))
    assert spans["detector.upload"].counts == {"bytes": frames * 8 * 8 * 3 + rows * 4 * 4}
    assert spans["detector.resize"].counts["images"] == rows
    assert len(det.collect(pending)) == n


def test_oversize_batch_is_refused(artifact):
    _, served = artifact
    with pytest.raises(ValueError, match="artifact batch"):
        served.detect(images(3))


def test_manifest_files_and_fields(artifact):
    out, served = artifact
    assert sorted(os.listdir(out)) == ["manifest.json", "model.pt2"]
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == 1
    assert (manifest["batch"], manifest["detect_only"], manifest["mesh_size"]) == (2, True, 1)
    assert manifest["device_type"] == "cpu" and manifest["torch_version"] == torch.__version__
    assert manifest["outputs"] == ["detections", "det_valid", "masks"]
    assert manifest["config"] == json.loads(json.dumps(dataclasses.asdict(Config(**CFG))))
    # JSON turns the tuple fields into lists; the loaded Config has tuples
    # again, hashes, and equals the exported one
    assert served.config == Config(**CFG) and hash(served.config) == hash(Config(**CFG))
    assert isinstance(served.config.rpn_anchor_scales, tuple)
    assert (served.batch, served.detect_only, served.mesh) == (2, True, None)


def test_config_from_manifest_skips_unknown_fields():
    fields = dataclasses.asdict(Config(**CFG))
    fields["field_of_a_later_version"] = [1, 2]
    del fields["mean_pixel"]
    cfg = _config_from_manifest(json.loads(json.dumps(fields)))
    assert cfg == Config(**CFG)


def test_load_refuses_another_device_type(artifact, tmp_path):
    out, _ = artifact
    with pytest.raises(ValueError, match="exported for cpu"):
        ServingDetector.load(out, device="meta")
    # an artifact of the card on a host without one: no fallback to the CPU
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump(dict(manifest, device_type="cuda"), f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingDetector.load(str(tmp_path))


def test_full_contract_global_label_matches_jax(weights, tmp_path):
    """``detect_only=False``: the artifact's ``last_global_label`` equals the
    port's ``Detector`` bit for bit and the JAX ``Detector``'s to float32
    rounding (the label is a float32 bilinear upsampling in both)."""
    out = str(tmp_path / "full")
    export_detector(Config(**CFG), weights[1], out, batch=1, detect_only=False, device="cpu")
    served = ServingDetector.load(out)
    one = images(1, seed=5)
    got = served.detect(one)
    shutil.rmtree(out)
    port = Detector(Config(**CFG), weights[1], detect_only=False, device="cpu")
    assert_same(got, port.detect(one))
    np.testing.assert_array_equal(served.last_global_label, port.last_global_label)
    with jax.enable_x64(True):
        ref = JaxDetector(JaxConfig(**CFG), weights[0], detect_only=False)
        ref.detect(one)
    assert served.last_global_label.shape == (1, 64, 64)
    np.testing.assert_allclose(served.last_global_label, np.asarray(ref.last_global_label),
                               rtol=1e-6, atol=1e-4)


@pytest.fixture(scope="module")
def mesh_artifact(weights, tmp_path_factory):
    """(manifest, loaded ServingDetector) of the batch-4 artifact over a
    CPU mesh of 2, the per-replica program at batch 2."""
    out = str(tmp_path_factory.mktemp("mesh"))
    export_detector(Config(**CFG), weights[1], out, batch=4, mesh=("cpu", "cpu"))
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    served = ServingDetector.load(out)
    shutil.rmtree(out)
    return manifest, served


@pytest.mark.parametrize("n", [1, 3, 4])
def test_mesh_artifact_matches_single_device(mesh_artifact, direct, n):
    """A mesh of (cpu, cpu) at batch 4: the per-replica program at batch 2,
    a request of ``n`` padded to 4 and split in two blocks, equal to the
    ``Detector`` without a mesh."""
    manifest, served = mesh_artifact
    assert (manifest["mesh_size"], manifest["batch"]) == (2, 4)
    assert served.mesh == (torch.device("cpu"), torch.device("cpu"))
    batch = images(n, seed=7)
    got = served.detect(batch)
    assert len(got) == n and sum(len(r["scores"]) for r in got) > 0
    assert_same(got, direct.detect(batch))
    with pytest.raises(ValueError, match="artifact batch"):
        served.detect(images(5))


def test_batch_the_mesh_does_not_divide_is_refused(weights, tmp_path):
    with pytest.raises(ValueError, match="divisible"):
        export_detector(Config(**CFG), weights[1], str(tmp_path), batch=3,
                        mesh=("cpu", "cpu"))
    assert not os.listdir(tmp_path)


def test_export_cli_on_cpu(weights, tmp_path, monkeypatch):
    """``cli.export_model --model random --device cpu`` writes an artifact
    that loads and detects (the reduced float32 model: the CLI's own
    full-width config is patched, as in ``test_torch_eval_slice.py``)."""
    seen = []

    def reduced(**kw):
        seen.append(kw)
        return Config(**dict(CFG, image_size=kw["image_size"], compute_dtype="float32",
                             param_dtype="float32"))

    monkeypatch.setattr(export_model, "inference_config", reduced)
    out = str(tmp_path / "cli")
    assert export_model.main(["--model", "random", "--out", out, "--batch", "1",
                              "--image_size", "128", "--device", "cpu"]) == out
    assert seen == [dict(image_size=128)]      # the dtypes are the Config's
    served = ServingDetector.load(out)
    assert (served.batch, served.config.image_size, served.device.type) == (1, 128, "cpu")
    assert served.config.compute_dtype == "float32"
    assert len(served.detect(images(1))) == 1
    shutil.rmtree(out)
    args = export_model.build_parser().parse_args(["--model", "m", "--out", "o"])
    assert (args.device, args.batch, args.image_size, args.mesh, args.full) == (
        "cuda", 8, 1024, 0, False)


def test_loading_imports_no_model_code(artifact):
    """A serving process loads and runs the artifact without ever importing
    ``sln_amodal_tpu_torch.models`` (nor JAX)."""
    out, _ = artifact
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"""
import sys
import numpy as np
for name in ("jax", "jaxlib", "flax", "sln_amodal_tpu"):
    sys.modules[name] = None
from sln_amodal_tpu_torch.serve import ServingDetector
served = ServingDetector.load({out!r})
rng = np.random.RandomState(0)
results = served.detect([rng.randint(0, 255, (64, 64, 3), np.uint8)])
leaked = sorted(n for n in sys.modules if n.startswith("sln_amodal_tpu_torch.models"))
assert not leaked, leaked
print("ok", len(results))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-2:] == ["ok", "1"]
