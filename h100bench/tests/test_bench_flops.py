"""The FLOP count from shapes against PyTorch's own counter over the
reference at a small size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import flops, harness
from h100bench.reference.model import Reference

from .tiny import CFG


@pytest.mark.parametrize("config", ["sln_r101", "sln_r50"])
def test_count_matches_flop_counter(config):
    cfg = dict(harness.config_file(config), **dict(CFG, image_size=128, glm_input_size=65))
    ref = Reference(cfg)
    image = torch.randint(0, 255, (1, 128, 128, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter:
        cands, levels, prior = ref.candidates(image)
        boxes = cands.boxes[cands.detections]
        ref.masks_at(levels, prior, boxes)
    want = flops.inference_flops(cfg, rois=int(cands.boxes.shape[0]),
                                 detections=int(boxes.shape[0]))
    assert counter.get_total_flops() == pytest.approx(want["total"], rel=1e-9)


def test_training_count_matches_flop_counter():
    """One image's step of stage 4+: forward, weight and input gradients."""
    from h100bench.reference.train import image_losses, trained

    cfg = dict(harness.config_file("sln_r101"), **dict(CFG, image_size=128, glm_input_size=65))
    ref = Reference(cfg)
    for _, p in trained(ref, "4+"):
        p.requires_grad_(True)
    a = 3 * sum(((128 + s - 1) // s) ** 2 for s in cfg["backbone_strides"])
    gen = torch.Generator().manual_seed(0)
    sample = {"images": torch.randn((128, 128, 3), generator=gen) * 50,
              "rpn_match": torch.randint(-1, 2, (a,), generator=gen),
              "rpn_deltas": torch.randn((a, 4), generator=gen),
              "gt_class_ids": torch.tensor([1, 1] + [0] * 48),
              "gt_boxes": torch.tensor([[0.1, 0.1, 0.6, 0.5], [0.3, 0.4, 0.9, 0.9]] + [[0.0] * 4] * 48),
              "gt_masks": torch.randint(0, 2, (50, 1, 128, 128), generator=gen, dtype=torch.uint8)}
    u = torch.rand((2, cfg["post_nms_rois_training"]), generator=gen)
    with FlopCounterMode(display=False) as counter:
        image_losses(ref, sample, u[0], u[1])["total"].backward()
    assert counter.get_total_flops() == pytest.approx(flops.training_flops(cfg)["total"],
                                                      rel=1e-9)
