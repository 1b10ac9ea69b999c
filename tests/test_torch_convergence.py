"""Train -> evaluate convergence of the port (the recipe of
``tests/test_convergence.py``, on the port).

The heads-stage recipe scaled down: an 8-image synthetic rectangle set at
64², 150 steps at batch 2 over the ROI heads (``classifier.`` and
``mask.``) with the RPN biased to the anchor tiling and frozen
(``utils/synthetic.py::rpn_biased_variables``), so positives flow from the
first step; the 12-way amodal sweep on 4 validation images before and after.
Training must lift AP@.5 and AR@100, to the JAX test's floors (0.04, 0.15).
Runs on the CPU (``device="cpu"``); ``chip_smoke.py`` runs the same recipe
on the card. Marked slow, like the JAX test.
"""

import numpy as np
import pytest

from fixtures import make_synthetic_dataset
from sln_amodal_tpu_torch.cli import train as cli
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import init_params
from sln_amodal_tpu_torch.data.dataset import AmodalDataset
from sln_amodal_tpu_torch.data.pipeline import TrainLoader
from sln_amodal_tpu_torch.infer import Detector
from sln_amodal_tpu_torch.train.trainer import Trainer
from sln_amodal_tpu_torch.utils.synthetic import rpn_biased_variables

pytestmark = pytest.mark.slow

STEPS = 150


def train_config():
    return Config(image_size=64, glm_input_size=33, batch_size=2, pre_nms_limit=512,
                  post_nms_rois_inference=256, post_nms_rois_training=64,
                  train_rois_per_image=16, detection_max_instances=100, max_gt_instances=8,
                  rpn_train_anchors_per_image=64, compute_dtype="float32",
                  param_dtype="float32", name="cocoa")


def headline(state_dict, dataset, coco, config):
    """(AP@.5, AR@100) of the both/all slice; zeros without detections."""
    detector = Detector(config, state_dict, device="cpu")
    ids = [int(i) for i in dataset.image_ids]
    results = cli.predict(detector, dataset, ids, 1, progress=False)
    stats = cli.score(coco, dataset, ids, results, "COCOA", verbose=False)
    if stats is None:
        return 0.0, 0.0
    return float(stats["both/all"][1]), float(stats["both/all"][5])


@pytest.fixture(scope="module")
def converged(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("conv"))
    make_synthetic_dataset(root, n_images=8, size=64, subset="train")
    make_synthetic_dataset(root, n_images=4, size=64, subset="val", seed=7)
    train_ds = AmodalDataset()
    train_ds.load_amodal(root, "train")
    train_ds.prepare()
    val_ds = AmodalDataset()
    coco = val_ds.load_amodal(root, "val")
    val_ds.prepare()

    cfg = train_config()
    icfg = cfg.replace(batch_size=1, detection_min_confidence=0.0)
    state_dict = rpn_biased_variables(init_params(cfg, seed=0, device="cpu"))
    before = headline(state_dict, val_ds, coco, icfg)
    trainer = Trainer(cfg, state_dict, device="cpu")
    losses = trainer.train_stage(
        TrainLoader(train_ds, cfg, seed=0), lambda name: name.startswith(("classifier.", "mask.")),
        cfg.learning_rate, epochs=1, steps_per_epoch=STEPS)
    after = headline(trainer.model.state_dict(), val_ds, coco, icfg)
    return before, after, losses


def test_training_improves_ap(converged):
    before, after, losses = converged
    print(f"\nconvergence: before={before} after={after} losses={losses}")
    assert all(np.isfinite(v) for v in losses.values())
    assert after[1] > before[1], (before, after)          # AR@100 up
    assert after[0] > before[0], (before, after)          # AP@.5 up
    assert after[1] >= 0.15, (before, after)
    assert after[0] >= 0.04, (before, after)
