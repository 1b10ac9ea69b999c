"""The port's real-weights parity recipe (``cli/run_parity.py``) against the
JAX package's ``scripts/run_parity.py``.

The gate logic is held to the JAX ``compare`` on the cases of
``tests/test_run_parity.py`` (verdict and printed text). The no-weights
dry run runs at the reduced float64 configuration of
``test_torch_eval_slice.py`` on 3 images at ``eval_batch`` 2 (the last
batch padded), and its release-layout files (the ``.pth`` without
``GLM_modual.*`` keys, the standalone ``deeplabv2.pth``) go through the JAX
package's ``run_sweep`` too: the north-star recipe in miniature, both
packages evaluating the same files to equal sweeps at gate 0. The dry
run's data comes from the port's ``make_synthetic_dataset``, which writes
the files of the tests' fixture (``tests/fixtures.py``).
"""

import copy
import functools
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

import sln_amodal_tpu.cli.train as jax_cli
from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.convert import torch_weights as jax_torch_weights
from sln_amodal_tpu.models.sln import init_params as jax_init
from sln_amodal_tpu_torch.cli import run_parity
from sln_amodal_tpu_torch.cli import train as port_train
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.train import checkpoint as ckpt
from sln_amodal_tpu_torch.utils.synthetic import make_synthetic_dataset
from fixtures import make_synthetic_dataset as jax_make_synthetic_dataset
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse)

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import run_parity as jax_run_parity  # noqa: E402

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33,
           pre_nms_limit=400, post_nms_rois_inference=104,
           detection_max_instances=100, mask_pool_size=2,
           compute_dtype="float64", param_dtype="float64")

# tests/test_run_parity.py's four cases: (ours, ref, gate)
COMPARE_CASES = {
    "within_gate": ({"both/all": [0.310, 0.521], "things/all": [0.40]},
                    {"both/all": [0.312, 0.525], "things/all": [0.398]}, 0.5),
    "beyond_gate": ({"both/all": [0.310]}, {"both/all": [0.320]}, 0.5),
    "missing_slice": ({}, {"both/all": [0.3]}, 0.5),
    "partial_ref": ({"both/all": [0.30, 0.50, 0.20], "stuff/all": [0.99]},
                    {"both/all": [0.30]}, 0.0),
}


@pytest.mark.parametrize("data_type,subset,seed", [("COCO", "val", 1), ("D2S", "train", 2)])
def test_synthetic_dataset_equals_fixture(data_type, subset, seed, tmp_path):
    """The port's writer and ``tests/fixtures.py``'s write the same files:
    equal JSON, equal ``.npz`` arrays, equal image bytes."""
    kwargs = dict(n_images=3, size=64, data_type=data_type, subset=subset, seed=seed)
    ours = make_synthetic_dataset(str(tmp_path / "port"), **kwargs)
    ref = jax_make_synthetic_dataset(str(tmp_path / "jax"), **kwargs)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(root) for f in names)
    assert files(ours) == files(ref)
    assert {os.path.splitext(f)[1] for f in files(ref)} == {".json", ".jpg", ".npz"}
    for name in files(ref):
        a, b = os.path.join(ours, name), os.path.join(ref, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), name
        elif name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files) == ["layer"], name
                assert all(np.array_equal(za[k], zb[k]) for k in zb.files), name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_matches_jax(case, capsys):
    """The same verdict and the same printed table as the JAX ``compare``."""
    ours, ref, gate = COMPARE_CASES[case]
    want = jax_run_parity.compare(ours, ref, gate)
    want_out = capsys.readouterr().out
    got = run_parity.compare(ours, ref, gate)
    assert got == want and capsys.readouterr().out == want_out
    assert want == (case in ("within_gate", "partial_ref"))


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """The port's dry run at the reduced config. The CLI's seeded template is
    patched to a copy of the checkpoint's own state_dict (every key comes
    from the files, so its values are never read; ``init_params`` is most
    of a sweep's time on the CPU). Its files (1.6 GB in float64) are removed
    after the module."""
    cfg = Config(**CFG, name="cocoa")
    workdir = tmp_path_factory.mktemp("parity")
    template = {}

    def cached_init(config, seed=0, device="cuda"):
        if not template:
            template.update(ckpt.read_state_dict(ckpt.checkpoint_path(str(workdir), "parity", 1)))
        return {k: v.clone().to(device) for k, v in template.items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_train, "init_params", cached_init)
        out = run_parity.dry_run(str(workdir), cfg, n_images=3, eval_batch=2, device="cpu")
    yield out
    shutil.rmtree(workdir, ignore_errors=True)


def test_dry_run_sweeps_identical_and_nonempty(dry):
    assert list(dry.native) == list(dry.release) and len(dry.native) == 12
    assert dry.native == dry.release
    assert dry.native["both/all"][5] > 0
    assert len(dry.seconds) == 2 and min(dry.seconds) > 0


def test_dry_run_release_layout(dry):
    """The release ``.pth`` holds no GLM key; the standalone
    ``deeplabv2.pth`` holds exactly the native checkpoint's GLM, unprefixed."""
    native = ckpt.read_state_dict(dry.native_path)
    release = ckpt.read_state_dict(dry.release_path)
    glm = ckpt.read_state_dict(dry.glm_path)
    assert not any(k.startswith(ckpt.GLM_PREFIX) for k in release)
    assert glm and not any(k.startswith(ckpt.GLM_PREFIX) for k in glm)
    assert set(release) | {ckpt.GLM_PREFIX + k for k in glm} == set(native)
    for k, v in glm.items():
        assert torch.equal(native[ckpt.GLM_PREFIX + k], v)


def test_release_layout_same_sweep_through_both_packages(dry, monkeypatch):
    """The JAX package's ``run_sweep`` on the dry run's release files and
    dataset gives the port's sweep, stat for stat (gate 0). For the reduced
    config its CLI's ``inference_config`` is patched, its template is the
    model's shapes alone (the loader reads only the classifier's width from
    it), and its ``.pth`` converter reads a ResNet-50 trunk (it defaults to
    the full model's ResNet-101)."""
    def reduced(**overrides):
        return JaxConfig(**CFG, name=overrides.get("name", "cocoa"))

    monkeypatch.setattr(jax_cli, "inference_config", reduced)
    monkeypatch.setattr(jax_torch_weights, "convert_full_checkpoint", functools.partial(
        jax_torch_weights.convert_full_checkpoint, architecture="resnet50"))
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda k: jax_init(JaxConfig(**CFG), k), jax.random.PRNGKey(0))
        monkeypatch.setattr(jax_cli, "init_params", lambda config, rng: copy.deepcopy(shapes))
        ref = jax_run_parity.run_sweep(dry.release_path, dry.glm_path, dry.dataset, "COCOA",
                                       image_size=64, eval_batch=2)
    assert run_parity.compare(dry.release, ref, gate=0.0)
    assert dry.release == ref


def test_main_needs_a_card_unless_cpu(tmp_path):
    """The CLI defaults to the card and raises before any work without one."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_parity.main(["--dry_run", str(tmp_path / "dry")])
    assert not os.path.exists(tmp_path / "dry")
