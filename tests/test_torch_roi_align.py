"""The port's RoIAlign against the JAX package's gather oracle.

The plain PyTorch RoIAlign (what the wrapper runs for CPU tensors) is held
against ``pyramid_roi_align_gather_batched``, the exact oracle of the TPU
kernel, at <= 1e-12 in float64 and <= 1e-6 in float32, and the GLM-prior
``crop_and_resize`` likewise. The JAX functions run jitted, as the model runs
them: the sample geometry (float32 in both modes) is then bit-identical, and
the residue is the lerp's association (XLA fuses a multiply-add there, the
port does not). The CUDA kernel is held against the plain version on the
card, in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sln_amodal_tpu.ops.roi_align import (
    crop_and_resize as jax_crop_and_resize,
    pyramid_roi_align_gather_batched,
    roi_levels as jax_roi_levels,
)
from sln_amodal_tpu_torch.ops import roi_align_cuda
from sln_amodal_tpu_torch.ops.roi_align import (
    crop_and_resize, pyramid_roi_align_plain, roi_levels)
from sln_amodal_tpu_torch.ops.roi_align_cuda import pyramid_roi_align

IMAGE = (256, 256)
TOL = {np.float64: 1e-12, np.float32: 1e-6}


def pyramid(b, c, seed=0, sizes=(64, 32, 16, 8), dtype=np.float64):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, s, c).astype(dtype) for s in sizes]


def hard_boxes(b, n, seed=1):
    """Random boxes plus the cases that stress the geometry: the full
    image, edge-touching, beyond the edge, a tiny corner box, a zero-height
    line, elongated boxes (large span on one axis) and inverted boxes."""
    rng = np.random.RandomState(seed)
    y1 = rng.uniform(-0.1, 0.9, (b, n))
    x1 = rng.uniform(-0.1, 0.9, (b, n))
    h = rng.uniform(0.01, 0.5, (b, n))
    w = rng.uniform(0.01, 0.5, (b, n))
    boxes = np.stack([y1, x1, y1 + h, x1 + w], axis=-1)
    special = [
        [0.0, 0.0, 1.0, 1.0],
        [0.0, 0.3, 0.4, 1.0],
        [-0.2, -0.1, 0.3, 1.2],
        [0.0, 0.0, 0.001, 0.001],
        [0.5, 0.5, 0.5, 0.9],
        [0.05, 0.1, 0.75, 0.12],
        [0.3, 0.0, 0.32, 0.95],
        [0.6, 0.2, 0.2, 0.6],
        [0.2, 0.6, 0.6, 0.2],
    ]
    boxes[:, :len(special)] = special
    return boxes


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pool", [7, 16])
def test_plain_matches_gather_oracle(pool, dtype):
    feats = pyramid(2, 8, dtype=dtype)
    boxes = hard_boxes(2, 40).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jax.jit(lambda f, b: pyramid_roi_align_gather_batched(
            f, b, (pool, pool), IMAGE))([jnp.asarray(f) for f in feats], jnp.asarray(boxes)))
    out = pyramid_roi_align_plain(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
        (pool, pool), IMAGE).numpy()
    assert out.dtype == ref.dtype and out.shape == (2, 40, pool, pool, 8)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype])


def test_single_cell_crop_and_two_levels():
    """crop 1x1 (the center-sample branch) over a 2-level pyramid."""
    feats = pyramid(1, 4, sizes=(32, 16), seed=3)
    boxes = hard_boxes(1, 12, seed=4)
    with jax.enable_x64(True):
        ref = np.asarray(jax.jit(lambda f, b: pyramid_roi_align_gather_batched(
            f, b, (1, 1), (128, 128)))([jnp.asarray(f) for f in feats], jnp.asarray(boxes)))
    out = pyramid_roi_align_plain(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
        (1, 1), (128, 128)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


def test_roi_levels_match():
    boxes = hard_boxes(1, 200, seed=5)[0]
    # boxes exactly on the level boundaries (sqrt(hw) = 224/1024 * 2^k)
    side = 224.0 / 1024.0 * np.array([0.25, 0.5, 1.0, 2.0])
    boxes[:4] = np.stack([np.zeros(4), np.zeros(4), side, side], -1)
    for dtype in (np.float64, np.float32):
        with jax.enable_x64(dtype == np.float64):
            ref = np.asarray(jax.jit(lambda b: jax_roi_levels(b, 1024.0 * 1024.0))(
                jnp.asarray(boxes.astype(dtype))))
        out = roi_levels(torch.from_numpy(boxes.astype(dtype)), 1024.0 * 1024.0)
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_crop_and_resize_matches_jax(dtype):
    """The GLM-prior crop: normalized boxes and the reference's pixel-coords
    quirk (mostly out of range, edge rows sampled)."""
    rng = np.random.RandomState(6)
    image = rng.randn(2, 65, 65, 183).astype(dtype)
    boxes = np.concatenate([hard_boxes(1, 20, seed=7)[0],
                            hard_boxes(1, 10, seed=8)[0] * 1024.0,
                            [[0.0, 0.0, 512.0, 300.0], [0.5, 1.0, 40.0, 90.0]]])
    boxes = boxes.astype(dtype)
    idx = rng.randint(0, 2, len(boxes)).astype(np.int32)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jax.jit(lambda im, b, i: jax_crop_and_resize(im, b, i, (16, 16)))(
            jnp.asarray(image), jnp.asarray(boxes), jnp.asarray(idx)))
    out = crop_and_resize(torch.from_numpy(image), torch.from_numpy(boxes),
                          torch.from_numpy(idx), (16, 16)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype])


def test_wrapper_uses_plain_version_for_cpu_tensors():
    feats = [torch.from_numpy(f) for f in pyramid(1, 4, seed=9)]
    boxes = torch.from_numpy(hard_boxes(1, 10, seed=10))
    before = roi_align_cuda.ROI_ALIGN_KERNEL.launches
    out = pyramid_roi_align(feats, boxes, (7, 7), IMAGE)
    assert roi_align_cuda.ROI_ALIGN_KERNEL.launches == before
    assert torch.equal(out, pyramid_roi_align_plain(feats, boxes, (7, 7), IMAGE))
