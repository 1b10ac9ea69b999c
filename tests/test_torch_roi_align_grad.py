"""The RoIAlign gradient of the port against the JAX package.

- :func:`pyramid_roi_align_backward_plain` against ``jax.vjp`` of the JAX
  package's ``pyramid_roi_align_batched`` (its custom VJP, run on the CPU
  and jitted, as the JAX train step runs it: XLA's arithmetic is the one the
  port's sample geometry reproduces), in float32: each gradient within 1e-6
  of the sum of the magnitudes of its terms (both sum in float32, in other
  orders).
- Against autograd through the port's own plain forward in float64: exact
  (1e-10) where every weight, product and sum is exact in float32 (samples
  on quarter cells, small integer cotangents), and within float32 rounding
  of the cotangent elsewhere (the VJP casts it to float32).
- Through the port's ``torch.autograd.Function`` on the CPU: the plain
  backward, no gradient into the boxes, and nothing recorded under
  ``no_grad``.

The kernel's own checks are card tests (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sln_amodal_tpu.ops.roi_align import pyramid_roi_align_batched
from sln_amodal_tpu_torch.ops.roi_align import (pyramid_roi_align_backward_plain,
                                                pyramid_roi_align_plain)
from sln_amodal_tpu_torch.ops.roi_align_cuda import pyramid_roi_align

IMAGE = (256, 256)


def make_case(seed, b=2, n=12, c=8, sizes=(64, 32, 16, 8), crop=(7, 7), dtype=np.float32):
    """Levels [B, s, s, C], boxes [B, N, 4] spread over the levels (small,
    medium, large; some past the image edge; one inverted), a cotangent."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, s, s, c).astype(dtype) for s in sizes]
    boxes = []
    for i in range(b * n):
        size = (0.06, 0.45, 0.12, 0.9)[i % 4]
        y, x = rng.uniform(-0.1, 1.0 - size * 0.8, 2)
        boxes.append([y, x, y + size, x + size])
    boxes = np.asarray(boxes).reshape(b, n, 4)
    boxes[0, 0] = [0.7, 0.2, 0.3, 0.6]                 # inverted
    boxes[-1, -1] = [1.1, 1.1, 1.4, 1.3]               # outside the image
    grad = rng.randn(b, n, *crop, c).astype(dtype)
    return feats, boxes.astype(dtype), grad


def jax_vjp(feats, boxes, crop):
    """The jitted JAX VJP of ``pyramid_roi_align_batched`` at ``boxes``:
    cotangent -> level gradients (numpy)."""
    @jax.jit
    def bwd(fs, g):
        _, vjp = jax.vjp(lambda fs: pyramid_roi_align_batched(
            fs, jnp.asarray(boxes), crop, IMAGE, impl="blocked"), fs)
        return vjp(g)[0]

    fs = tuple(jnp.asarray(f) for f in feats)
    return lambda g: [np.asarray(r) for r in bwd(fs, jnp.asarray(g))]


@pytest.mark.parametrize("seed,crop,sizes", [
    (0, (7, 7), (64, 32, 16, 8)),
    (1, (16, 16), (64, 32, 16, 8)),
    (2, (5, 3), (64, 32, 16, 8)),
    (3, (1, 1), (64, 32)),
    (4, (7, 7), (48,)),
])
def test_plain_backward_matches_jax_vjp(seed, crop, sizes):
    feats, boxes, grad = make_case(seed, crop=crop, sizes=sizes)
    vjp = jax_vjp(feats, boxes, crop)
    ref, magnitude = vjp(grad), vjp(np.abs(grad))
    got = pyramid_roi_align_backward_plain(
        torch.from_numpy(grad), torch.from_numpy(boxes), [f.shape[1:] for f in feats],
        crop, IMAGE, torch.float32)
    assert max(float(np.abs(r).max()) for r in ref) > 0
    for g, r, m in zip(got, ref, magnitude):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        assert np.all(np.abs(g.numpy() - r) <= 1e-6 * m)


def test_plain_backward_matches_jax_vjp_float64_levels():
    """float64 levels: the cotangent is still summed in float32, and the
    gradient cast to float64 at the end, as the JAX VJP does."""
    feats, boxes, grad = make_case(5, dtype=np.float64)
    with jax.enable_x64(True):
        vjp = jax_vjp(feats, boxes, (7, 7))
        ref, magnitude = vjp(grad), vjp(np.abs(grad))
    got = pyramid_roi_align_backward_plain(
        torch.from_numpy(grad), torch.from_numpy(boxes), [f.shape[1:] for f in feats],
        (7, 7), IMAGE, torch.float64)
    for g, r, m in zip(got, ref, magnitude):
        assert g.dtype == torch.float64 and r.dtype == np.float64
        assert np.all(np.abs(g.numpy() - r) <= 1e-6 * m)


def _autograd_grads(feats, boxes, grad, crop):
    fs = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = pyramid_roi_align_plain(fs, torch.from_numpy(boxes), crop, IMAGE)
    return torch.autograd.grad(out, fs, torch.from_numpy(grad))


def test_plain_backward_is_autograd_of_the_plain_forward_exactly():
    """Samples on quarter cells (a 65-wide level: dim - 1 = 64, pool 5:
    steps of 1/4 of the box; boxes on 1/64 multiples) and small integer
    cotangents: every weight and partial sum is exact in float32, so the
    float32 VJP equals float64 autograd through the gather."""
    rng = np.random.RandomState(6)
    feats = [rng.randn(2, 65, 65, 4)]
    edges = rng.randint(0, 64, (2, 10, 4)) / 64.0
    boxes = np.concatenate([np.minimum(edges[..., :2], edges[..., 2:]),
                            np.maximum(edges[..., :2], edges[..., 2:])], -1)
    grad = rng.randint(-4, 5, (2, 10, 5, 5, 4)).astype(np.float64)
    ref = _autograd_grads(feats, boxes, grad, (5, 5))
    got = pyramid_roi_align_backward_plain(torch.from_numpy(grad), torch.from_numpy(boxes),
                                           [f.shape[1:] for f in feats], (5, 5), IMAGE,
                                           torch.float64)
    assert float(ref[0].abs().max()) > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-10)


def test_plain_backward_is_autograd_of_the_plain_forward_to_float32():
    feats, boxes, grad = make_case(7, dtype=np.float64)
    ref = _autograd_grads(feats, boxes, grad, (7, 7))
    got = pyramid_roi_align_backward_plain(torch.from_numpy(grad), torch.from_numpy(boxes),
                                           [f.shape[1:] for f in feats], (7, 7), IMAGE,
                                           torch.float64)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-6 * scale)


def test_autograd_function_on_cpu_takes_the_plain_backward():
    feats, boxes, grad = make_case(8)
    fs = [torch.from_numpy(f).requires_grad_() for f in feats]
    bx = torch.from_numpy(boxes).requires_grad_()
    out = pyramid_roi_align(fs, bx, (7, 7), IMAGE)
    assert torch.equal(out, pyramid_roi_align_plain([torch.from_numpy(f) for f in feats],
                                                    torch.from_numpy(boxes), (7, 7), IMAGE))
    out.backward(torch.from_numpy(grad))
    ref = pyramid_roi_align_backward_plain(torch.from_numpy(grad), torch.from_numpy(boxes),
                                           [f.shape[1:] for f in feats], (7, 7), IMAGE,
                                           torch.float32)
    for f, r in zip(fs, ref):
        assert torch.equal(f.grad, r)
    assert bx.grad is None                             # the boxes get no gradient
    with torch.no_grad():
        assert pyramid_roi_align(fs, bx, (7, 7), IMAGE).grad_fn is None


def test_jax_vjp_gives_the_boxes_zero():
    """The JAX VJP's box gradient is zeros; the port gives none."""
    feats, boxes, grad = make_case(9)
    _, vjp = jax.vjp(lambda b: pyramid_roi_align_batched(
        tuple(jnp.asarray(f) for f in feats), b, (7, 7), IMAGE, impl="blocked"),
        jnp.asarray(boxes))
    (g_boxes,) = vjp(jnp.asarray(grad))
    assert not np.asarray(g_boxes).any()


def test_no_boxes_gives_zero_gradients():
    feats, _, _ = make_case(10)
    got = pyramid_roi_align_backward_plain(
        torch.zeros((2, 0, 7, 7, 8)), torch.zeros((2, 0, 4)), [f.shape[1:] for f in feats],
        (7, 7), IMAGE, torch.float32)
    assert [tuple(g.shape) for g in got] == [(2, *f.shape[1:]) for f in feats]
    assert all(not g.any() for g in got)
