"""The port's detection-target layer against the JAX package's.

``sln_amodal_tpu_torch.detect.targets.detection_target_layer`` (batched)
against ``sln_amodal_tpu.detect.targets.detection_target_layer`` lifted over
the batch with ``vmap`` and jitted, as the JAX model runs it. The JAX layer
draws its priorities with ``jax.random``; the port is fed those draws (per
image: ``split(rng, B)``, then ``split(key)`` into the positives' and the
negatives' keys, then ``uniform(k, (P,))``). The sampled ROIs, class ids,
validity, positives and GT-mask crops are equal; the deltas agree to 1e-12
relative in float64 and 1e-6 in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sln_amodal_tpu.detect.targets import detection_target_layer as jax_targets
from sln_amodal_tpu_torch.detect.targets import detection_target_layer

B, P, G, L, S = 2, 48, 5, 2, 32
KW = dict(train_rois=16, roi_positive_ratio=0.7, mask_shape=(8, 8),
          bbox_std_dev=(0.1, 0.1, 0.2, 0.2))


def make_inputs(seed, case, dtype):
    """Proposals around the GT boxes (jittered, so IoU crosses 0.5 both
    ways) and elsewhere, some invalid; GT ids with padding, and with a
    crowd box in the "crowd" case; random layer masks."""
    rng = np.random.RandomState(seed)
    gt_boxes = np.zeros((B, G, 4))
    gt_ids = np.zeros((B, G), np.int32)
    for b in range(B):
        for g in range(G - 1):
            y, x = rng.uniform(0.0, 0.6, 2)
            h, w = rng.uniform(0.15, 0.4, 2)
            gt_boxes[b, g] = [y, x, y + h, x + w]
            gt_ids[b, g] = 1
    if case == "crowd":
        gt_ids[:, 1] = -1
    near = gt_boxes[:, rng.randint(0, G - 1, P)] + rng.randn(B, P, 4) * 0.04
    far = rng.uniform(0, 1, (B, P, 2))
    far = np.concatenate([far, far + 0.05], -1)
    use_near = rng.rand(B, P) < (0.0 if case == "no_positive" else 0.6)
    if case == "no_positive":
        gt_boxes[:, :, :2] += 5.0                      # GT far outside the proposals
        gt_boxes[:, :, 2:] += 5.0
    proposals = np.where(use_near[..., None], near, far)
    valid = rng.rand(B, P) > 0.1
    proposals = np.where(valid[..., None], proposals, 0.0)
    masks = (rng.rand(B, G, L, S, S) > 0.5).astype(np.float32)
    return (proposals.astype(dtype), valid, gt_ids, gt_boxes.astype(np.float32), masks)


def run_jax(inputs, seed):
    proposals, valid, gt_ids, gt_boxes, masks = inputs
    keys = jax.random.split(jax.random.PRNGKey(seed), B)

    def one(key, p, v, i, b, m):
        return jax_targets(key, p, v, i, b, m, **KW)

    out = jax.jit(jax.vmap(one))(keys, *map(jnp.asarray, inputs))
    pairs = [jax.random.split(k) for k in keys]
    pos = np.stack([np.asarray(jax.random.uniform(kp, (P,))) for kp, _ in pairs])
    neg = np.stack([np.asarray(jax.random.uniform(kn, (P,))) for _, kn in pairs])
    return {k: np.asarray(v) for k, v in out._asdict().items()}, pos, neg


def run_port(inputs, pos, neg):
    out = detection_target_layer(*map(torch.from_numpy, inputs),
                                 pos_uniform=torch.from_numpy(pos),
                                 neg_uniform=torch.from_numpy(neg), **KW)
    return {k: v.numpy() for k, v in out._asdict().items()}


@pytest.mark.parametrize("case", ["mixed", "crowd", "no_positive"])
@pytest.mark.parametrize("x64", [True, False])
def test_targets_equal_jax(case, x64):
    dtype = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        inputs = make_inputs(3, case, dtype)
        ref, pos, neg = run_jax(inputs, seed=11)
    got = run_port(inputs, pos, neg)
    for k in ("rois", "class_ids", "valid", "positive", "masks"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["rois"].dtype == dtype and got["masks"].dtype == np.float32
    np.testing.assert_allclose(got["deltas"], ref["deltas"], rtol=1e-12 if x64 else 1e-6,
                               atol=1e-12 if x64 else 1e-6)
    n_pos = got["positive"].sum(axis=1)
    if case == "no_positive":
        assert not got["valid"].any() and not got["rois"].any()
    else:
        assert (n_pos > 0).all() and (got["valid"].sum(axis=1) > n_pos).all()
        assert got["masks"][got["positive"]].any()


def test_crowd_overlap_is_never_negative():
    """Proposals on a crowd box are neither positive nor negative."""
    proposals, valid, gt_ids, gt_boxes, masks = make_inputs(4, "crowd", np.float64)
    proposals[:, :8] = gt_boxes[:, 1:2]                # exactly the crowd box
    valid[:, :8] = True
    draws = torch.rand((2, B, P), generator=torch.Generator().manual_seed(0),
                       dtype=torch.float64)
    out = detection_target_layer(*map(torch.from_numpy, (proposals, valid, gt_ids, gt_boxes,
                                                         masks)),
                                 pos_uniform=draws[0], neg_uniform=draws[1], **KW)
    rois = out.rois.numpy()
    crowd = gt_boxes[:, 1]
    for b in range(B):
        picked = rois[b][out.valid[b].numpy()]
        assert not (picked == crowd[b]).all(axis=1).any()


def test_generator_draws_are_the_same_on_every_call():
    inputs = [torch.from_numpy(a) for a in make_inputs(5, "mixed", np.float64)]
    a = detection_target_layer(*inputs, generator=torch.Generator().manual_seed(3), **KW)
    b = detection_target_layer(*inputs, generator=torch.Generator().manual_seed(3), **KW)
    c = detection_target_layer(*inputs, generator=torch.Generator().manual_seed(4), **KW)
    assert torch.equal(a.rois, b.rois) and torch.equal(a.masks, b.masks)
    assert not torch.equal(a.rois, c.rois)
