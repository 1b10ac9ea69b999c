"""The control of the correctness check at a small size: the reference in
float8 put in the program's place comes out not correct under each cell's
limits, and the reference in float32 in its place comes out correct."""

import pytest
import torch

from h100bench import control, harness, judge

from .tiny import CELLS, CFG, traffic_changes


@pytest.mark.parametrize("cell", CELLS)
def test_float8_control_fails_and_float32_passes(cell):
    limits = harness.limits_file(cell)
    tt = traffic_changes(cell, samples=3)
    low = control.control_numbers(cell, 2 ** 31 + 5, torch.device("cpu"), CFG, tt, "fp8")
    same = control.control_numbers(cell, 2 ** 31 + 5, torch.device("cpu"), CFG, tt, "fp32")
    assert not judge.verdict(low, limits), low
    assert judge.verdict(same, limits), same


def test_training_controls_fail_and_the_float32_reference_passes():
    """At this size the float8 reference and the half-batch fault in the
    program's place fail the limits the training driver's tests use, and
    the float32 reference passes them. (At the cell's size the float8
    control does not yet fail any training number: PERF.md §7.)"""
    from .tiny import TRAIN, TRAIN_LIMITS, bench

    limits = TRAIN_LIMITS
    cfg = dict(CFG, image_size=128, glm_input_size=65, post_nms_rois_training=100,
               train_rois_per_image=20, backbone="resnet50")
    tt = traffic_changes(TRAIN, sizes=[[96, 128], [128, 96]])
    dev = torch.device("cpu")
    low = control.train_control_numbers(TRAIN, 7, dev, cfg, tt, "fp8", bench=bench())
    half = control.train_control_numbers(TRAIN, 7, dev, cfg, tt, "fp32", half=True,
                                         bench=bench())
    same = control.train_control_numbers(TRAIN, 7, dev, cfg, tt, "fp32", bench=bench())
    assert not judge.verdict(low, limits), low
    assert not judge.verdict(half, limits), half
    assert judge.verdict(same, limits), same
