"""A run whose timed path is broken underneath comes out not correct: the
harness driven on the CPU at a small size (past its look for a card),
once per fault an inference cell can have. The float32 program agrees
with the reference to rounding."""

import numpy as np
import pytest
import torch

from h100bench import harness

from .tiny import CELLS, TRAIN, run

ALL = {"samples": 4, "sample_within": 4, "pool": 8}
# a frame large enough that an answer of another image reads as one
WIDER = {"image_size": 128, "glm_input_size": 65, "post_nms_rois_inference": 100,
         "detection_max_instances": 20}


def limits(cell):
    return harness.limits_file(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_float32_program_agrees_with_the_reference(cell):
    # a detect window long enough to reach its sampled requests on a busy CPU
    r = run(cell, cfg={"compute_dtype": "float32"}, traffic=ALL,
            seconds=5.0 if "detect" in cell else 0.5)
    got = {k: v["value"] for k, v in r["checks"].items()}
    assert r["correct"] and r["samples"] >= 2
    assert got["count_diff"] == 0 and got["host_mismatch"] == 0 and got["rank_gap"] == 0
    # both gaps are of logits taken from the program's float32
    # probabilities, which round near 0 and 1 to within 6e-8: a logit of 12
    # reads to within some 0.01, one of 15 to within 0.2
    assert got["box_px_p90"] == 0 and got["logit_gap"] < 0.1 and got["mask_gap"] < 0.1


def shift_boxes(monkeypatch):
    from sln_amodal_tpu_torch.models import sln

    refine = sln.refine_detections

    def shifted(*args, **kwargs):
        dets, valid = refine(*args, **kwargs)
        dets = dets.clone()
        dets[..., :4] = torch.where(valid[..., None], (dets[..., :4] - 20).clamp_min(0),
                                    dets[..., :4])
        return dets, valid
    monkeypatch.setattr(sln, "refine_detections", shifted)


def square_scores(monkeypatch):
    from sln_amodal_tpu_torch.models import sln

    refine = sln.refine_detections

    def squared(*args, **kwargs):
        dets, valid = refine(*args, **kwargs)
        dets = dets.clone()
        dets[..., 5] = dets[..., 5] ** 4
        return dets, valid
    monkeypatch.setattr(sln, "refine_detections", squared)


def lift_masks(monkeypatch):
    from sln_amodal_tpu_torch.models.sln import SLNAmodal

    mask_on = SLNAmodal._mask_on
    monkeypatch.setattr(SLNAmodal, "_mask_on", lambda self, *a: -mask_on(self, *a))


def half_batch(monkeypatch):
    """Half of every batch left out: its images replaced by the others'."""
    from sln_amodal_tpu_torch.utils import image as image_utils

    mold = image_utils.mold_inputs

    def halved(images, config):
        keep = images[: max(1, len(images) // 2)]
        return mold((keep * 2)[: len(images)], config)
    monkeypatch.setattr(image_utils, "mold_inputs", halved)


def empty_rle(monkeypatch):
    """Every detection's RLE string that of an empty mask, where the eval
    loop encodes each image's detections in one call."""
    from sln_amodal_tpu_torch.eval_amodal import rle

    encode = rle.encode_pasted_many
    monkeypatch.setattr(rle, "encode_pasted_many",
                        lambda crops, y1s, x1s, h, w: encode([np.zeros_like(c) for c in crops],
                                                             y1s, x1s, h, w))


def drop_last(monkeypatch):
    from sln_amodal_tpu_torch.utils import image as image_utils

    unmold = image_utils.unmold_detections

    def dropped(*args):
        boxes, ids, scores, masks = unmold(*args)
        return boxes[:-1], ids[:-1], scores[:-1], masks[..., :-1]
    monkeypatch.setattr(image_utils, "unmold_detections", dropped)


FAULTS = {"boxes": shift_boxes, "scores": square_scores, "masks": lift_masks,
          "half_batch": half_batch}


# a batch of one has no half to leave out
CASES = [(cell, fault) for cell in CELLS for fault in sorted(FAULTS)
         if not (fault == "half_batch" and cell.endswith("b1"))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_answer_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert not run(cell, cfg=WIDER, traffic=dict(ALL, sizes=[[96, 128], [128, 96]]))["correct"]


def test_a_broken_drain_is_not_correct(monkeypatch):
    empty_rle(monkeypatch)
    r = run("sln_r101.eval-b8", traffic=ALL)
    assert not r["correct"] and r["checks"]["host_mismatch"]["value"] > 0


def test_a_broken_unmold_is_not_correct(monkeypatch):
    drop_last(monkeypatch)
    r = run("sln_r50.detect-b1", traffic=ALL)
    assert not r["correct"] and r["checks"]["host_mismatch"]["value"] > 0


# ------------------------------------------------------------- training --
# the program in float32 at this size, so that the faults stand out from a
# clean run: the limits are the cell's, set for bfloat16 at full size
F32 = {"compute_dtype": "float32", "backbone": "resnet50"}


def test_float32_training_agrees_with_the_reference():
    r = run(TRAIN, cfg=F32)
    got = {k: v["value"] for k, v in r["checks"].items()}
    assert r["correct"], got
    assert got["loader_faults"] == 0 and got["loss_gap"] < 1e-3 and got["grad_gap"] < 1e-3


def unchanged_state(monkeypatch):
    from sln_amodal_tpu_torch.train.optim import StagedSGD

    monkeypatch.setattr(StagedSGD, "step", lambda self: None)


def half_of_the_batch(monkeypatch):
    """Each step's losses the mean over the first half of the batch."""
    from sln_amodal_tpu_torch.train import trainer

    losses = trainer.batched_losses

    def halved(out, batch):
        half = out.rpn_logits.shape[0] // 2
        cut = type(out)(*(None if v is None else
                          type(v)(*(x[:half] for x in v)) if isinstance(v, tuple)
                          else v[:half] for v in out))
        return losses(cut, {k: v[:half] for k, v in batch.items()})
    monkeypatch.setattr(trainer, "batched_losses", halved)


def altered_loss(monkeypatch):
    from sln_amodal_tpu_torch.train import losses

    total = losses.total_loss

    def altered(**kw):
        out = total(**kw)
        out["total"] = out["total"] + 0.5 * out["layer"]
        return out
    monkeypatch.setattr(losses, "total_loss", altered)


def altered_target(monkeypatch):
    """A loader target altered where it is produced: the GT boxes shifted."""
    from sln_amodal_tpu_torch.data import pipeline

    make = pipeline.make_training_sample

    def shifted(*args, **kwargs):
        s = make(*args, **kwargs)
        if s is not None:
            s["gt_boxes"] = s["gt_boxes"] * 0.9
        return s
    monkeypatch.setattr(pipeline, "make_training_sample", shifted)


TRAIN_FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_of_the_batch,
                "altered_loss": altered_loss, "altered_target": altered_target}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_a_broken_training_step_is_not_correct(fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    r = run(TRAIN, cfg=F32)
    assert not r["correct"], {k: v["value"] for k, v in r["checks"].items()}
