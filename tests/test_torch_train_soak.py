"""The port's batch > 1 training soak (``cli/train_soak.py``), the
counterpart of the JAX package's ``scripts/train_soak.py``, on the CPU at
the reduced float64 configuration of ``test_torch_eval_slice.py`` (with the
train slice's ROI counts): ``main`` runs 2 heads steps at batch 2 through
the host loader and through ``DevicePrepLoader`` and prints ``SOAK OK``.
"""

import os

import numpy as np
import pytest

from sln_amodal_tpu_torch.cli import train_soak
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.data.device_prep import DevicePrepLoader
from sln_amodal_tpu_torch.data.pipeline import TrainLoader
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse)

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33,
           pre_nms_limit=400, post_nms_rois_inference=104,
           detection_max_instances=100, mask_pool_size=2,
           compute_dtype="float64", param_dtype="float64",
           post_nms_rois_training=32, train_rois_per_image=8, max_gt_instances=4,
           rpn_train_anchors_per_image=64, mask_shape=(4, 4))


@pytest.fixture(scope="module")
def seeded_init():
    """``init_params`` computed once for the module (the same seeded values
    each call; both runs build the same config)."""
    init, cache = train_soak.init_params, {}

    def cached(config, seed=0, device="cuda"):
        if not cache:
            cache.update(init(config, seed=seed, device=device))
        return {k: v.clone() for k, v in cache.items()}
    return cached


@pytest.mark.parametrize("device_prep", [False, True])
def test_soak_main_two_steps(device_prep, seeded_init, tmp_path, monkeypatch, capsys):
    built = []

    def reduced(image_size, batch_size, name):
        assert (image_size, batch_size, name) == (64, 2, "soak")
        return Config(**CFG, batch_size=batch_size, name=name)

    build = train_soak.build_soak_pipeline

    def recording_build(**kwargs):
        built.append(build(**kwargs))
        return built[-1]

    monkeypatch.setattr(train_soak, "training_config", reduced)
    monkeypatch.setattr(train_soak, "init_params", seeded_init)
    monkeypatch.setattr(train_soak, "build_soak_pipeline", recording_build)
    argv = ["--batch", "2", "--steps", "2", "--size", "64", "--root", str(tmp_path / "ds"),
            "--device", "cpu"] + (["--device_prep"] if device_prep else [])
    out = train_soak.main(argv)
    printed = capsys.readouterr().out
    assert "SOAK OK: batch=2 steps=2 size=64" in printed and "host clock" in printed
    assert np.isfinite(out.last_losses["total"])
    assert len(out.step_ms) == 1 and out.median_step_ms > 0
    trainer, loader, config = built[0]
    assert type(loader) is (DevicePrepLoader if device_prep else TrainLoader)
    assert loader.batch_size == 2 and trainer.device.type == "cpu"
    assert len(os.listdir(tmp_path / "ds" / "train2014")) == 16   # 8 images + 8 .npz


def test_main_needs_a_card_unless_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_soak.main(["--root", str(tmp_path / "ds")])
    assert not os.path.exists(tmp_path / "ds")
