"""The port's six training losses against the JAX package's.

Seeded inputs in float32 and float64 through ``sln_amodal_tpu.train.losses``
and ``sln_amodal_tpu_torch.train.losses``: each term and the total within
1e-6 relative. Both cast the predictions to float32 (``losses.py:46, 61, 70,
86, 102, 115``), so the losses are float32 even from float64 inputs. Plus
the edge cases of ``tests/test_losses_edge.py``: no positive gives exactly 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sln_amodal_tpu.train import losses as jax_losses
from sln_amodal_tpu_torch.train import losses

A, T, C, L, M = 96, 12, 2, 1, 8


def make_inputs(seed, dtype):
    rng = np.random.RandomState(seed)
    match = rng.choice([-1, 0, 1], A, p=[0.5, 0.3, 0.2]).astype(np.int32)
    class_ids = np.where(rng.rand(T) < 0.6, 1, 0).astype(np.int32)
    return dict(
        rpn_match=match,
        rpn_target_deltas=rng.randn(A, 4).astype(np.float32),
        rpn_logits=rng.randn(A, 2).astype(dtype) * 3,
        rpn_pred_deltas=rng.randn(A, 4).astype(dtype) * 1.5,
        target_class_ids=class_ids,
        roi_valid=np.arange(T) < T - 2,
        mrcnn_class_logits=rng.randn(T, C).astype(np.float32) * 2,
        target_deltas=rng.randn(T, 4).astype(dtype),
        mrcnn_pred_deltas=rng.randn(T, C, 4).astype(np.float32),
        target_masks=(rng.rand(T, L, M, M) > 0.5).astype(np.float32),
        mask_logits=rng.randn(T, M, M, C).astype(np.float32) * 4,
    )


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_losses_equal_jax(seed, x64):
    inputs = make_inputs(seed, np.float64 if x64 else np.float32)
    with jax.enable_x64(x64):
        ref = {k: float(v) for k, v in jax_losses.total_loss(
            **{k: jnp.asarray(v) for k, v in inputs.items()}).items()}
    got = losses.total_loss(**{k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()})
    assert list(got) == list(ref) == ["rpn_class", "rpn_bbox", "mrcnn_class", "mrcnn_bbox",
                                      "layer", "amodal", "total"]
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        assert abs(float(v) - ref[k]) <= 1e-6 * abs(ref[k]), (k, float(v), ref[k])
        assert ref[k] > 0


def test_smooth_l1_and_bce_elementwise():
    rng = np.random.RandomState(2)
    a, b = rng.randn(50).astype(np.float32) * 3, rng.randn(50).astype(np.float32)
    t = (rng.rand(50) > 0.5).astype(np.float32)
    np.testing.assert_allclose(losses.smooth_l1(torch.from_numpy(a), torch.from_numpy(b)),
                               jax_losses.smooth_l1(a, b), rtol=1e-6)
    np.testing.assert_allclose(losses.bce_with_logits(torch.from_numpy(a), torch.from_numpy(t)),
                               jax_losses.bce_with_logits(a, t), rtol=1e-6)


def test_rpn_bbox_loss_no_positives_is_zero():
    rng = np.random.RandomState(0)
    match = -torch.ones(64, dtype=torch.int32)
    out = losses.rpn_bbox_loss(torch.from_numpy(rng.randn(64, 4).astype(np.float32)), match,
                               torch.from_numpy(rng.randn(64, 4).astype(np.float32)))
    assert float(out) == 0.0


def test_rpn_class_loss_no_contributing_is_zero():
    logits = torch.from_numpy(np.random.RandomState(3).randn(32, 2).astype(np.float32))
    assert float(losses.rpn_class_loss(torch.zeros(32, dtype=torch.int32), logits)) == 0.0


def test_mrcnn_losses_no_positive_rois_are_zero():
    class_ids = torch.zeros(8, dtype=torch.int32)
    assert float(losses.mrcnn_bbox_loss(torch.ones(8, 4), class_ids, torch.ones(8, 2, 4))) == 0.0
    assert float(losses.layer_loss(torch.ones(8, 1, 4, 4), class_ids, torch.ones(8, 4, 4, 2))) == 0.0
    assert float(losses.amodal_loss(torch.ones(8, 1, 4, 4), class_ids, torch.ones(8, 4, 4, 2))) == 0.0


def test_rpn_bbox_loss_is_the_mean_over_positive_rows():
    rng = np.random.RandomState(2)
    match = np.zeros(128, np.int32)
    match[rng.choice(128, 17, replace=False)] = 1
    target, pred = rng.randn(128, 4).astype(np.float32), rng.randn(128, 4).astype(np.float32)
    out = float(losses.rpn_bbox_loss(torch.from_numpy(target), torch.from_numpy(match),
                                     torch.from_numpy(pred)))
    pos = match == 1
    ref = float(losses.smooth_l1(torch.from_numpy(pred[pos]), torch.from_numpy(target[pos])).mean())
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_gradients_are_float32_through_float64_logits():
    """The casts make the gradient of a float64 graph float32-rounded: the
    gradient into float64 logits is exactly a float32 value."""
    inputs = make_inputs(4, np.float64)
    logits = torch.from_numpy(inputs["rpn_logits"]).requires_grad_()
    losses.rpn_class_loss(torch.from_numpy(inputs["rpn_match"]), logits).backward()
    assert logits.grad.dtype == torch.float64
    assert torch.equal(logits.grad, logits.grad.to(torch.float32).to(torch.float64))
