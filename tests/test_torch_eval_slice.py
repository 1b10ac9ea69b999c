"""The whole eval slice: the port's ``cli.train evaluate`` path against the
JAX package's evaluate composition (``sln_amodal_tpu/cli/train.py:133-187``)
on shared weights, plus the two ported CLIs' plumbing and the import rule.

Reduced configuration (64² images, ResNet-50, a 33² GLM input, 4x4 mask
pooling), float64 on both sides, on the synthetic COCOA-style dataset of
``tests/fixtures.py``. The weights are the detection-biased checkpoint: the
JAX recipe on one side, the port's ``detection_biased_variables`` carried
through a ``.pth`` and the port's loader on the other. Its detections are
the first surviving anchors in anchor order (equal scores), and only a full
table of 100 reaches the synthetic regions: fewer give AR 0. Result dicts
are equal (scores to float32 rounding, as in ``test_torch_slice.py``), and
so are all 12 sweep vectors.
"""

import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from fixtures import make_synthetic_dataset
from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.data.dataset import AmodalDataset as JaxDataset
from sln_amodal_tpu.data.dataset import DetectionResults as JaxResults
from sln_amodal_tpu.eval_amodal.amodal_eval import AmodalEval as JaxEval
from sln_amodal_tpu.eval_amodal.amodal_eval import evaluate_sweep as jax_sweep
from sln_amodal_tpu.eval_amodal.coco_results import build_coco_results_crops as jax_crops
from sln_amodal_tpu.infer import Detector as JaxDetector
from sln_amodal_tpu.models.sln import init_params as jax_init
from sln_amodal_tpu.utils import synthetic as jax_synthetic
from sln_amodal_tpu_torch.cli import test_images as port_test_images
from sln_amodal_tpu_torch.cli import train as port_train
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import params_from_jax
from sln_amodal_tpu_torch.infer import Detector
from sln_amodal_tpu_torch.train import checkpoint as ckpt
from sln_amodal_tpu_torch.utils.synthetic import detection_biased_variables
from torch_port_helpers import random_variables

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33,
           pre_nms_limit=400, post_nms_rois_inference=104,
           detection_max_instances=100, mask_pool_size=2,
           compute_dtype="float64", param_dtype="float64")
BATCH = 2   # 3 images: the last batch is padded


def reduced_config(**overrides):
    """Stands in for the CLIs' ``inference_config`` (full width, float32):
    the reduced config in float64, keeping the run's name."""
    return Config(**dict(CFG, name=overrides.get("name", "coco")))


@pytest.fixture(scope="module")
def reduced_cli(weights):
    """Patches both CLIs to the reduced config, and their seeded template to
    a copy of the checkpoint's own state_dict: every key then comes from the
    file, so the template's values are never read, and ``init_params`` (most
    of a CLI run's time on the CPU) is not run."""
    template = weights[1]

    def cached_init(config, seed=0, device="cuda"):
        assert (config.backbone, config.compute_dtype, seed) == ("resnet50", "float64", 0)
        return {k: v.clone().to(device) for k, v in template.items()}

    def patch(mp):
        for module in (port_train, port_test_images):
            mp.setattr(module, "inference_config", reduced_config)
            mp.setattr(module, "init_params", cached_init)
    return patch


def synthetic(root, data_type):
    """The fixture dataset typed COCOA or D2SA: the same images and region
    geometry, the GT order nested in two ways."""
    return make_synthetic_dataset(root, n_images=3, size=64, subset="val",
                                  data_type="COCO" if data_type == "COCOA" else "D2S")


def jax_dataset(root, data_type):
    dataset = JaxDataset()
    coco = dataset.load_amodal(root, "val", data_type="COCO" if data_type == "COCOA" else "D2S")
    dataset.prepare()
    return dataset, coco, [int(i) for i in dataset.image_ids]


def jax_detect(root, variables):
    """The JAX package's prediction loop, as its CLI composes it (in turn:
    the JAX graph's dispatch is asynchronous either way)."""
    dataset, _, image_ids = jax_dataset(root, "COCOA")
    with jax.enable_x64(True):
        detector = JaxDetector(JaxConfig(**CFG), variables)
        results = []
        for start in range(0, len(image_ids), BATCH):
            chunk = image_ids[start:start + BATCH]
            images = [dataset.load_image(i) for i in chunk]
            images += [images[-1]] * (BATCH - len(images))
            for image_id, r in zip(chunk, detector.collect_crops(detector.dispatch(images))):
                results.extend(jax_crops(dataset.image_info[image_id]["id"], r["rois"],
                                         r["class_ids"], r["scores"], r["crops"],
                                         r["image_shape"]))
    return results


def jax_score(root, results, data_type):
    """The JAX package's evaluator and 12-way sweep over ``results``."""
    dataset, coco, image_ids = jax_dataset(root, data_type)
    order_key = "order" if data_type == "COCOA" else "amodal_region.order"
    ev = JaxEval(coco, JaxResults(copy.deepcopy(results)), order_key=order_key)
    ev.params.img_ids = [dataset.image_info[i]["id"] for i in image_ids]
    return jax_sweep(ev, verbose=False)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("weights")
    shapes = jax.eval_shape(lambda k: jax_init(JaxConfig(**CFG), k), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_synthetic, "init_params", lambda config, rng: copy.deepcopy(variables))
        biased = jax_synthetic.detection_biased_variables(JaxConfig(**CFG))
    port_sd = detection_biased_variables(params_from_jax(variables))
    return biased, port_sd, ckpt.save(port_sd, str(tmp), "biased", 1)


@pytest.fixture(scope="module")
def jax_results(weights, tmp_path_factory):
    return jax_detect(synthetic(str(tmp_path_factory.mktemp("data")), "COCOA"), weights[0])


@pytest.fixture(scope="module", params=["COCOA", "D2SA"])
def evaluations(request, weights, jax_results, reduced_cli, tmp_path_factory):
    data_type = request.param
    root = synthetic(str(tmp_path_factory.mktemp(f"data_{data_type}")), data_type)
    ref = jax_results, jax_score(root, jax_results, data_type)
    with pytest.MonkeyPatch.context() as mp:
        reduced_cli(mp)
        out = port_train.main([
            "evaluate", "--dataset", root, "--data_type", data_type, "--model", weights[2],
            "--glm_weights", os.path.join(root, "no_such_deeplabv2.pth"),
            "--image_size", "64", "--eval_batch", str(BATCH), "--device", "cpu"])
    return ref, out


def test_biased_state_dict_matches_jax_recipe(weights):
    """The port's recipe, carried through the flax->reference mapping (the
    transposed conv's spatial flip included), equals the JAX recipe."""
    biased, port_sd, _ = weights
    ref = params_from_jax(biased)
    assert set(port_sd) == set(ref)
    for k in ref:
        assert torch.equal(port_sd[k], ref[k]), k


def test_result_dicts_equal_jax(evaluations):
    (ref_results, _), out = evaluations
    assert len(out.results) == len(ref_results) > 0
    for r, o in zip(ref_results, out.results):
        assert o["image_id"] == r["image_id"] and o["category_id"] == r["category_id"]
        assert o["bbox"] == r["bbox"]
        np.testing.assert_allclose(o["score"], r["score"], rtol=1e-6, atol=0)
        assert o["segmentation"] == r["segmentation"]


def test_sweep_equals_jax(evaluations):
    (_, ref_stats), out = evaluations
    assert list(out.stats) == list(ref_stats) and len(ref_stats) == 12
    for key in ref_stats:
        assert np.array_equal(out.stats[key], ref_stats[key]), (key, out.stats[key], ref_stats[key])
    assert out.stats["both/all"][5] > 0, "AR@100 is 0: the masks did not survive the unmold"


def test_evaluate_cli_plumbing(weights, reduced_cli, tmp_path, monkeypatch, capsys):
    """One in-process ``main`` run on 2 images: the limit, the printed sweep
    and the returned dicts."""
    root = make_synthetic_dataset(str(tmp_path / "data"), n_images=3, size=64, subset="val")
    reduced_cli(monkeypatch)
    out = port_train.main(["evaluate", "--dataset", root, "--model", weights[2],
                           "--limit", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "Loading weights" in printed and "images/s" in printed
    assert printed.count("Average Recall") == 3 * 12
    assert {r["image_id"] for r in out.results} == {1, 2}
    assert len(out.stats) == 12 and out.seconds > 0


def test_test_images_cli_writes_pickled_results(weights, reduced_cli, tmp_path, monkeypatch):
    root = make_synthetic_dataset(str(tmp_path / "data"), n_images=2, size=64, subset="val")
    images = os.path.join(root, "val2014")
    reduced_cli(monkeypatch)
    written = port_test_images.main(["--images", images, "--model", weights[2],
                                     "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == ["img_0001.json", "img_0002.json"]
    detector = Detector(reduced_config(), weights[1], device="cpu")
    ds = port_train.AmodalDataset()
    ds.load_amodal(root, "val")
    for i, path in enumerate(written):
        with open(path, "rb") as f:
            got = pickle.load(f)
        ref = detector.detect([ds.load_image(i)])[0]
        assert set(got) == {"rois", "class_ids", "scores", "masks"}
        assert len(got["scores"]) > 0
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k])


def test_evaluate_data_parallel_equals_one_device(weights, reduced_cli, tmp_path, monkeypatch):
    """``evaluate --data_parallel`` (on the CPU a mesh of the CPU alone)
    gives the result dicts and the 12 sweeps of the run without it."""
    root = make_synthetic_dataset(str(tmp_path / "data"), n_images=3, size=64, subset="val")
    reduced_cli(monkeypatch)
    common = ["evaluate", "--dataset", root, "--model", weights[2], "--eval_batch", "2",
              "--device", "cpu"]
    plain = port_train.main(common)
    sharded = port_train.main(common + ["--data_parallel"])
    assert len(plain.results) > 0 and sharded.results == plain.results
    assert list(sharded.stats) == list(plain.stats)
    for key in plain.stats:
        assert np.array_equal(sharded.stats[key], plain.stats[key]), key


def test_train_device_prep_builds_device_prep_loaders(tmp_path, monkeypatch):
    """``train --device_prep`` hands the trainer a ``DevicePrepLoader`` on
    ``--device``, and builds one for validation (augment off)."""
    root = make_synthetic_dataset(str(tmp_path / "data"), n_images=2, size=64, subset="train")
    make_synthetic_dataset(root, n_images=2, size=64, subset="val")
    seen = []

    class StubTrainer:
        def __init__(self, config, state_dict, device):
            self.step = 0

        def train_stage(self, loader, *args, **kwargs):
            seen.append(loader)

    monkeypatch.setattr(port_train, "Trainer", StubTrainer)
    monkeypatch.setattr(port_train, "init_params",
                        lambda config, seed=0, device="cuda": {"w": torch.zeros(1)})
    built = []

    class Recording(port_train.DevicePrepLoader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(port_train, "DevicePrepLoader", Recording)
    port_train.main(["train", "--dataset", root, "--device_prep", "--device", "cpu",
                     "--stage", "heads", "--model", "random", "--validate_steps", "1",
                     "--logs", str(tmp_path / "logs")])
    assert seen == built[:1]
    assert [(b.augment, b.device.type) for b in built] == [(True, "cpu"), (False, "cpu")]


def test_evaluate_device_prep_runs_as_plain_evaluate(weights, reduced_cli, tmp_path,
                                                     monkeypatch):
    """``evaluate`` does not read ``--device_prep`` (the JAX package's CLI
    reads it only in ``train``): the same results as without it."""
    root = make_synthetic_dataset(str(tmp_path / "data"), n_images=3, size=64, subset="val")
    reduced_cli(monkeypatch)
    argv = ["evaluate", "--dataset", root, "--model", weights[2], "--limit", "1",
            "--device", "cpu"]
    plain = port_train.main(argv)
    with_flag = port_train.main(argv + ["--device_prep"])
    assert with_flag.results == plain.results and len(plain.results) > 0
    assert all(np.array_equal(with_flag.stats[k], plain.stats[k]) for k in plain.stats)


def test_cli_defaults_float32_on_the_card():
    """Both evaluation CLIs default to the card in the ``Config`` dtypes:
    bfloat16 compute, float32 parameters (as the JAX package's CLIs)."""
    args = port_train.build_parser().parse_args(["evaluate", "--dataset", "d"])
    cfg = port_train.eval_config(args)
    assert args.device == "cuda" and args.eval_batch == 8
    assert (cfg.compute_dtype, cfg.param_dtype) == ("bfloat16", "float32")
    assert cfg == Config(name="cocoa", batch_size=1, detection_min_confidence=0.0)
    seen = {}

    def stop_at_init(config, **kw):
        seen["config"] = config
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_test_images, "init_params", stop_at_init)
        with pytest.raises(SystemExit):
            port_test_images.main(["--images", "d"])
    assert (seen["config"].compute_dtype, seen["config"].param_dtype) == ("bfloat16", "float32")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports with jax, flax
    and the JAX package made unimportable."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "sln_amodal_tpu"):
    sys.modules[name] = None
import sln_amodal_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sln_amodal_tpu_torch.__path__,
                                                "sln_amodal_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "flax", "sln_amodal_tpu")
                and sys.modules[n] is not None)
assert not leaked, leaked
for name in ("data.device_prep", "cli.convert_dataset", "parallel.mesh", "parallel.multihost",
             "ops.library", "serve.export", "cli.export_model", "utils.profiling", "viz",
             "cli.run_parity", "cli.parity_check", "cli.train_soak"):
    assert "sln_amodal_tpu_torch." + name in names, name
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 34
