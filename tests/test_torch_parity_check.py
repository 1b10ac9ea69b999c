"""The port's inference parity harness (``cli/parity_check.py``) against
the JAX package's ``scripts/parity_check.py``.

``compare_image`` gives the JAX function's issues and stats on crafted
cases. End to end, at the reduced float64 configuration of
``test_torch_eval_slice.py``: the JAX ``Detector`` writes the reference
pickles (the format of the reference's ``amodal_test.py``) of two
synthetic images with the detection-biased weights, and the port's
``parity_check`` on the same ``.pth`` and images finds them within
tolerance, and exits 1 on a pickle with a box moved by 3 px, on a pickle
whose image is missing and on a directory without pickles.
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

import jax

from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.convert import torch_weights as jax_torch_weights
from sln_amodal_tpu.infer import Detector as JaxDetector
from sln_amodal_tpu_torch.cli import parity_check
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.train import checkpoint as ckpt
from sln_amodal_tpu_torch.utils.synthetic import (biased_pair, detection_biased_init,
                                                  make_synthetic_dataset)
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse)

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import parity_check as jax_parity_check  # noqa: E402

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33,
           pre_nms_limit=400, post_nms_rois_inference=104,
           detection_max_instances=100, mask_pool_size=2,
           compute_dtype="float64", param_dtype="float64")


def result(n, size=32, seed=0):
    """A result dict of ``n`` detections on a ``size``² image."""
    rng = np.random.RandomState(seed)
    y, x = rng.randint(0, size // 2, (2, n))
    rois = np.stack([y, x, y + 8, x + 8], 1).astype(np.int32)
    masks = np.zeros((size, size, n), np.uint8)
    for i, (y1, x1, y2, x2) in enumerate(rois):
        masks[y1:y2, x1:x2, i] = 1
    return {"rois": rois, "class_ids": np.ones(n, np.int32),
            "scores": rng.uniform(0.5, 1.0, n).astype(np.float32), "masks": masks}


def crafted(case):
    ref = result(5)
    got = {k: v.copy() for k, v in ref.items()}
    if case == "count":
        got = result(4)
    elif case == "box_2px":
        got["rois"][2] += 2
        got["scores"][1] += 1e-3
    elif case == "mask_iou":
        got["masks"][:, :, 3] = 0
        got["masks"][0:4, 0:4, 3] = 1
    return ref, got


@pytest.mark.parametrize("case", ["equal", "count", "box_2px", "mask_iou"])
def test_compare_image_matches_jax(case):
    ref, got = crafted(case)
    want = jax_parity_check.compare_image(ref, got, 1.0, 0.99)
    assert parity_check.compare_image(ref, got, 1.0, 0.99) == want
    assert bool(want[0]) == (case != "equal")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(images dir, .pth, pickles dir): the JAX ``Detector``'s pickles of
    two synthetic images with the detection-biased weights, which the port
    saved as a reference ``.pth``."""
    tmp = tmp_path_factory.mktemp("parity_check")
    cfg = Config(**CFG)
    root = make_synthetic_dataset(str(tmp / "data"), n_images=2, size=64, subset="val",
                                  regions=biased_pair(cfg))
    model = ckpt.save(detection_biased_init(cfg), str(tmp), "biased", 1)
    images = os.path.join(root, "val2014")
    out = tmp / "ref"
    out.mkdir()
    sd = jax_torch_weights.load_torch_state_dict(model)
    with jax.enable_x64(True):
        variables = jax_torch_weights.convert_full_checkpoint(sd, architecture="resnet50")
        detector = JaxDetector(JaxConfig(**CFG), variables)
        for name in sorted(f for f in os.listdir(images) if f.endswith(".jpg")):
            image = np.asarray(Image.open(os.path.join(images, name)).convert("RGB"))
            r = detector.detect([image])[0]
            assert len(r["scores"]) > 0
            with open(out / (name[:-4] + ".json"), "wb") as f:
                pickle.dump({k: np.asarray(r[k]) for k in ("rois", "class_ids", "scores",
                                                           "masks")}, f)
    yield images, model, str(out)
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture
def reduced(reference, monkeypatch):
    """The CLI at the reduced config, its seeded template the checkpoint's
    own state_dict (every key comes from the file)."""
    template = ckpt.read_state_dict(reference[1])
    monkeypatch.setattr(parity_check, "inference_config",
                        lambda image_size: Config(**CFG))
    monkeypatch.setattr(parity_check, "init_params",
                        lambda config, seed=0, device="cuda": dict(template))


def test_parity_check_accepts_jax_pickles(reference, reduced, tmp_path, capsys):
    images, model, ref_dir = reference
    perturbed = tmp_path / "perturbed"
    shutil.copytree(ref_dir, perturbed)
    argv = ["--images", images, "--model", model, "--image_size", "64", "--device", "cpu"]
    assert parity_check.main(argv + ["--reference_results", ref_dir]) == 0
    out = capsys.readouterr().out
    assert "2/2 images within tolerance" in out and "MISMATCH" not in out

    first = sorted(os.listdir(perturbed))[0]
    with open(perturbed / first, "rb") as f:
        ref = pickle.load(f)
    ref["rois"][0] += 3
    with open(perturbed / first, "wb") as f:
        pickle.dump(ref, f)
    assert parity_check.main(argv + ["--reference_results", str(perturbed)]) == 1
    out = capsys.readouterr().out
    assert "max box deviation 3px > 1.0" in out and "1/2 images within tolerance" in out


@pytest.mark.parametrize("case", ["image_missing", "no_pickle"])
def test_parity_check_fails_when_nothing_is_held(case, reference, reduced, tmp_path, capsys):
    """A pickle whose image is missing counts as a mismatch, and a directory
    without pickles fails: the gate never passes on what it did not
    compare."""
    images, model, ref_dir = reference
    refs = tmp_path / "refs"
    refs.mkdir()
    if case == "image_missing":
        shutil.copy(os.path.join(ref_dir, sorted(os.listdir(ref_dir))[0]),
                    refs / "img_9999.json")
    argv = ["--images", images, "--model", model, "--image_size", "64", "--device", "cpu",
            "--reference_results", str(refs)]
    assert parity_check.main(argv) == 1
    out = capsys.readouterr().out
    if case == "image_missing":
        assert "img_9999: MISMATCH: image not found" in out
        assert "0/1 images within tolerance" in out
    else:
        assert "0/0 images within tolerance" in out


def test_main_needs_a_card_unless_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity_check.main(["--images", str(tmp_path), "--model", "m.pth",
                           "--reference_results", str(tmp_path)])
