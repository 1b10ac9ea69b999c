"""The port's NMS against the JAX package's.

The plain PyTorch NMS (what the wrapper runs for CPU tensors) must give keeps
bit-identical to ``ops/nms.py::nms_sorted`` and to the Pallas kernel
``nms_sorted_pallas_batched`` run in interpret mode. The CUDA kernel is held
against the plain version on the card, in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sln_amodal_tpu.detect.proposal import proposal_layer_batched as jax_proposals
from sln_amodal_tpu.ops.nms import nms_sorted
from sln_amodal_tpu.ops.nms_pallas import nms_sorted_pallas_batched
from sln_amodal_tpu_torch.detect.proposal import proposal_layer_batched, top_k_indices
from sln_amodal_tpu_torch.ops import nms_cuda
from sln_amodal_tpu_torch.ops.nms import nms_sorted_batched_plain
from sln_amodal_tpu_torch.ops.nms_cuda import nms_sorted_batched


def random_boxes(rng, n, spread=200.0, size=40.0):
    centers = rng.rand(n, 2) * spread
    sizes = rng.rand(n, 2) * size + 2
    return np.concatenate([centers - sizes / 2, centers + sizes / 2], 1).astype(
        np.float32)


def cluster_boxes(rng, n, base=(50, 50, 90, 90), jitter=6.0):
    """One dense cluster: long suppression chains."""
    b = np.asarray(base, np.float32)[None] + rng.randn(n, 4).astype(np.float32) * jitter
    b[:, 2:] = np.maximum(b[:, 2:], b[:, :2] + 1)
    return b


def jax_keeps(boxes, valid, max_outputs, thr, **kw):
    """Per-image XLA reference keeps, stacked."""
    out = [nms_sorted(jnp.asarray(b), jnp.asarray(v), max_outputs, thr, **kw)
           for b, v in zip(boxes, valid)]
    return (np.stack([np.asarray(k) for k, _ in out]),
            np.stack([np.asarray(v) for _, v in out]))


def torch_keeps(boxes, valid, max_outputs, thr, **kw):
    k, v = nms_sorted_batched(torch.from_numpy(boxes), torch.from_numpy(valid),
                              max_outputs, thr, **kw)
    return k.numpy(), v.numpy()


CASES = {
    # name: (boxes [B, N, 4], valid [B, N], max_outputs, threshold)
    "random_64": lambda rng: (random_boxes(rng, 64)[None], 64, 0.5),
    "random_300": lambda rng: (random_boxes(rng, 300)[None], 300, 0.7),
    "random_513": lambda rng: (random_boxes(rng, 513)[None], 513, 0.3),
    "dense_cluster": lambda rng: (cluster_boxes(rng, 256)[None], 256, 0.5),
    # chains of suppression that cross the kernel's 64-box words
    "cluster_chains_0.7": lambda rng: (np.stack(
        [cluster_boxes(rng, 700, jitter=3.0), cluster_boxes(rng, 700, jitter=9.0)]), 300, 0.7),
    # the proposal shape class: many 64-box words, 1000 keeps
    "multiblock_2500": lambda rng: (
        random_boxes(rng, 2500, spread=400.0, size=60.0)[None], 1000, 0.7),
    "small_n": lambda rng: (random_boxes(rng, 5)[None], 8, 0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_nms_matches_xla_reference(case):
    rng = np.random.RandomState(sorted(CASES).index(case))
    boxes, max_out, thr = CASES[case](rng)
    valid = rng.rand(*boxes.shape[:2]) > 0.15
    k_ref, v_ref = jax_keeps(boxes, valid, max_out, thr)
    k, v = torch_keeps(boxes, valid, max_out, thr)
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(k, k_ref)


@pytest.mark.parametrize("n,max_out,thr", [(513, 100, 0.5), (2500, 1000, 0.7)])
def test_batched_matches_pallas_kernel(n, max_out, thr):
    """Batched keeps equal the TPU kernel's (interpret mode), image by image:
    a dense cluster beside a disjoint field, mixed validity."""
    rng = np.random.RandomState(n)
    boxes = np.stack([cluster_boxes(rng, n, jitter=5.0),
                      random_boxes(rng, n, spread=150.0 * 3)])
    valid = rng.rand(2, n) > 0.2
    valid[1] = True
    k_ref, v_ref = nms_sorted_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(valid), max_outputs=max_out,
        iou_threshold=thr, interpret=True)
    k, v = torch_keeps(boxes, valid, max_out, thr)
    np.testing.assert_array_equal(v, np.asarray(v_ref))
    np.testing.assert_array_equal(k, np.asarray(k_ref))


def test_suppress_at_equal_and_pad_value():
    rng = np.random.RandomState(21)
    # integer boxes: exact IoU ties at the threshold do occur
    boxes = np.round(random_boxes(rng, 200, spread=60.0, size=20.0))[None]
    valid = np.ones((1, 200), bool)
    for at_equal in (False, True):
        k_ref, v_ref = jax_keeps(boxes, valid, 150, 0.5,
                                 suppress_at_equal=at_equal, pad_value=-7)
        k, v = torch_keeps(boxes, valid, 150, 0.5,
                           suppress_at_equal=at_equal, pad_value=-7)
        np.testing.assert_array_equal(v, v_ref)
        np.testing.assert_array_equal(k, k_ref)


def test_float64_boxes_are_cast_to_float32():
    """The reference casts boxes to float32 even in float64 mode."""
    rng = np.random.RandomState(5)
    boxes = random_boxes(rng, 300).astype(np.float64)[None]
    boxes += rng.rand(*boxes.shape) * 1e-9
    valid = np.ones((1, 300), bool)
    with jax.enable_x64(True):
        k_ref, v_ref = jax_keeps(boxes, valid, 100, 0.6)
    k, v = torch_keeps(boxes, valid, 100, 0.6)
    np.testing.assert_array_equal(k, k_ref)
    np.testing.assert_array_equal(v, v_ref)


def test_top_k_tie_order_matches_lax_top_k():
    scores = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.9, 0.0]], np.float32)
    _, ref = jax.lax.top_k(jnp.asarray(scores), 6)
    np.testing.assert_array_equal(
        top_k_indices(torch.from_numpy(scores), 6).numpy(), np.asarray(ref))


def test_proposal_layer_matches_jax():
    """proposal_layer_batched end to end in float64: top-k with ties, box
    deltas, clip, NMS, normalization."""
    rng = np.random.RandomState(9)
    batch, a = 3, 800
    anchors = random_boxes(rng, a, spread=900.0, size=80.0)
    logits = rng.randn(batch, a, 2).astype(np.float32)
    logits[:, 100:140] = logits[:, 100:101]          # exact score ties
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    deltas = rng.randn(batch, a, 4) * 0.2
    kw = dict(proposal_count=60, nms_threshold=0.7, image_size=1024,
              rpn_bbox_std_dev=(0.1, 0.1, 0.2, 0.2), pre_nms_limit=256)
    with jax.enable_x64(True):
        rois_ref, valid_ref = jax_proposals(
            jnp.asarray(probs), jnp.asarray(deltas),
            jnp.asarray(anchors.astype(np.float64)), nms_impl="xla", **kw)
        rois_ref, valid_ref = np.asarray(rois_ref), np.asarray(valid_ref)
    rois, valid = proposal_layer_batched(
        torch.from_numpy(probs), torch.from_numpy(deltas),
        torch.from_numpy(anchors).double(), **kw)
    np.testing.assert_array_equal(valid.numpy(), valid_ref)
    # float64 box math: exp may differ in the last bit between the two
    np.testing.assert_allclose(rois.numpy(), rois_ref, rtol=1e-12, atol=0)


def test_wrapper_uses_plain_version_for_cpu_tensors():
    rng = np.random.RandomState(2)
    boxes = torch.from_numpy(random_boxes(rng, 100))[None]
    valid = torch.ones((1, 100), dtype=torch.bool)
    before = nms_cuda.NMS_KERNEL.launches
    k, v = nms_sorted_batched(boxes, valid, 50, 0.5)
    k_plain, v_plain = nms_sorted_batched_plain(boxes, valid, 50, 0.5)
    assert nms_cuda.NMS_KERNEL.launches == before
    assert torch.equal(k, k_plain) and torch.equal(v, v_plain)
