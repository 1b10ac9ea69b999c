"""The port's model stages against the JAX package's, on shared weights.

One seeded variables tree (numpy, float64) drives the JAX ``SLNAmodal`` and,
through ``params_from_jax``, the port's ``SLNAmodal``; each stage gets the
same inputs on both sides. Both run float64 (the JAX side under
``jax.enable_x64``), at a reduced size: 64² images, ResNet-50, a 33² GLM
input. Tolerances: 1e-9 relative where the reference computes in float64;
float32 stages (the reference casts probabilities, classifier outputs, mask
logits and GLM logits to float32) to a few float32 ulps, since XLA's and
PyTorch's float32 exp differ in the last bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.detect.detection import refine_detections as jax_refine
from sln_amodal_tpu.models import common as jax_common
from sln_amodal_tpu.models.sln import SLNAmodal as JaxSLN, init_params as jax_init
from sln_amodal_tpu.utils import image as jax_image
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import init_params, params_from_jax
from sln_amodal_tpu_torch.detect.detection import refine_detections
from sln_amodal_tpu_torch.models import common
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from sln_amodal_tpu_torch.utils import image as image_utils
from torch_port_helpers import random_variables

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33,
           pre_nms_limit=200, post_nms_rois_inference=32,
           detection_max_instances=6, mask_pool_size=8,
           compute_dtype="float64", param_dtype="float64")


def rel_close(out, ref, rtol):
    """|out - ref| <= rtol * max|ref| (relative to the tensor's scale)."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = JaxConfig(**CFG), Config(**CFG)
    shapes = jax.eval_shape(lambda k: jax_init(jcfg, k), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=0)
    model = SLNAmodal(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return jcfg, JaxSLN(jcfg), variables, model


def run_jax(pair, fn, *args):
    _, jmodel, variables, _ = pair
    with jax.enable_x64(True):
        out = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=fn))(
            variables, *[jnp.asarray(a) for a in args])
        return jax.tree_util.tree_map(np.asarray, out)


def images(seed=0, b=2, size=64):
    return np.random.RandomState(seed).uniform(-120, 130, (b, size, size, 3))


def test_fpn_levels(pair):
    x = images()
    ref = run_jax(pair, lambda m, x: m.fpn(x), x)
    out = pair[3].fpn(torch.from_numpy(x))
    for lvl, (o, r) in enumerate(zip(out, ref)):
        assert o.dtype == torch.float64, f"P{lvl + 2}"
        rel_close(o.numpy(), r, 1e-9)


def test_rpn_all_levels(pair):
    x = images(1)
    ref = run_jax(pair, lambda m, x: m._rpn_all_levels(m.fpn(x)), x)
    with torch.no_grad():
        out = pair[3]._rpn_all_levels(pair[3].fpn(torch.from_numpy(x)))
    rel_close(out[0].numpy(), ref[0], 1e-9)           # logits
    assert out[1].dtype == torch.float32              # probs, as the reference
    np.testing.assert_allclose(out[1].numpy(), ref[1], rtol=1e-6, atol=1e-7)
    rel_close(out[2].numpy(), ref[2], 1e-9)           # deltas


def test_classifier_head(pair):
    crops = np.random.RandomState(2).randn(12, 7, 7, 256)
    ref = run_jax(pair, lambda m, c: m.classifier(c), crops)
    with torch.no_grad():
        out = pair[3].classifier(torch.from_numpy(crops))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-6)


def test_mask_head_glm_channels_first(pair):
    rng = np.random.RandomState(3)
    fpn_crop, glm_crop = rng.randn(5, 8, 8, 256), rng.rand(5, 8, 8, 183)
    ref = run_jax(pair, lambda m, f, g: m.mask(f, g)[0], fpn_crop, glm_crop)
    with torch.no_grad():
        out, feat = pair[3].mask(torch.from_numpy(fpn_crop), torch.from_numpy(glm_crop))
    assert out.shape == (5, 16, 16, 2) and feat.shape == (5, 8, 8, 256)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_glm_prior_deeplab_msc(pair):
    x = images(4)
    ref_logits = run_jax(pair, lambda m, x: m.glm(x), x[:, :33, :33])
    ref_prior, ref_label = run_jax(pair, lambda m, x: m._glm_prior(x), x)
    with torch.no_grad():
        logits = pair[3].GLM_modual(torch.from_numpy(x[:, :33, :33]))
        prior, label = pair[3]._glm_prior(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (2, 5, 5, 182)
    rel_close(logits.numpy(), ref_logits, 1e-6)
    np.testing.assert_allclose(prior.numpy(), ref_prior, rtol=1e-6, atol=1e-7)
    rel_close(label.numpy(), ref_label, 1e-6)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
@pytest.mark.parametrize("size", [(513, 400), (33, 65), (16, 24)])
def test_resize_bilinear(size, dtype, tol):
    """Half-pixel, no antialias, up- and downscale; the 2-D form too."""
    x = np.random.RandomState(5).rand(2, 40, 52, 3).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jax.jit(lambda a: jax_common.resize_bilinear(a, size))(x))
    with jax.enable_x64(True):
        ref2 = np.asarray(jax.jit(lambda a: jax_common.resize_bilinear_2d(a, size))(
            x[..., 0].astype(np.float64)))
    out = common.resize_bilinear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    out2 = common.resize_bilinear_2d(torch.from_numpy(x[..., 0].astype(np.float64)), size)
    np.testing.assert_allclose(out2.numpy(), ref2, rtol=0, atol=1e-12)


@pytest.mark.parametrize("size", [64, 65, 7])
def test_same_pads_pools_and_resamples(size):
    x = np.random.RandomState(size).randn(1, size, size, 4)
    with jax.enable_x64(True):
        ref_pool = np.asarray(jax_common.max_pool_same(jnp.asarray(x), 3, 2))
        ref_up = np.asarray(jax_common.upsample_nearest_2x(jnp.asarray(x)))
        ref_sub = np.asarray(jax_common.subsample_2x(jnp.asarray(x)))
    t = common.nchw(torch.from_numpy(x))
    np.testing.assert_array_equal(common.nhwc(common.max_pool_same(t, 3, 2)).numpy(), ref_pool)
    np.testing.assert_array_equal(common.nhwc(common.upsample_nearest_2x(t)).numpy(), ref_up)
    np.testing.assert_array_equal(common.nhwc(common.subsample_2x(t)).numpy(), ref_sub)
    for k, s in ((3, 1), (3, 2), (7, 2), (1, 2)):
        assert common.same_pad_amounts(size, k, s) == jax_common.same_pad_amounts(size, k, s)


@pytest.mark.parametrize("use_nms", [False, True])
def test_refine_detections(use_nms):
    """Batched refine == the reference's per-image refine (vmapped):
    exact boxes, classes and order, with score ties and invalid ROIs."""
    rng = np.random.RandomState(6)
    b, r, c = 2, 40, 2
    rois = np.sort(rng.rand(b, r, 4), axis=-1)[..., [0, 1, 2, 3]]
    rois[..., 2:] = rois[..., :2] + rng.rand(b, r, 2) * 0.5
    logits = rng.randn(b, r, c).astype(np.float32)
    logits[:, 5:9] = logits[:, 5:6]                          # exact score ties
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    deltas = (rng.randn(b, r, c, 4) * 0.3).astype(np.float32)
    valid = rng.rand(b, r) > 0.2
    windows = np.array([[0, 0, 64, 64], [4, 2, 60, 58]], np.float32)
    kw = dict(image_size=64, bbox_std_dev=(0.1, 0.1, 0.2, 0.2), max_instances=12,
              min_confidence=0.0, use_nms=use_nms, nms_threshold=0.3)
    with jax.enable_x64(True):
        ref = jax.jit(jax.vmap(lambda ro, v, p, d, w: jax_refine(
            ro, v, p, d, (w[0], w[1], w[2], w[3]), **kw)))(
            rois, valid, probs, deltas, windows)
        ref = [np.asarray(a) for a in ref]
    out = refine_detections(*[torch.from_numpy(a) for a in (rois, valid, probs, deltas, windows)],
                            **kw)
    np.testing.assert_array_equal(out[1].numpy(), ref[1])
    np.testing.assert_array_equal(out[0].numpy(), ref[0])


def test_image_utils_match():
    rng = np.random.RandomState(7)
    img = rng.randint(0, 255, (50, 70, 3), np.uint8)
    np.testing.assert_array_equal(image_utils.pil_resize_uint8(img, (64, 64)),
                                  jax_image.pil_resize_uint8(img, (64, 64)))
    mask = rng.randn(16, 16).astype(np.float32)
    np.testing.assert_array_equal(image_utils.bytescale(mask), jax_image.bytescale(mask))
    det = np.zeros((5, 6))
    det[:3] = [[2, 3, 40, 30, 1, 0.9], [10, 10, 12, 50, 1, 0.8], [5, 5, 5, 9, 1, 0.7]]
    masks = rng.rand(5, 16, 16, 2).astype(np.float32)
    window = np.array([0, 0, 64, 64])
    for ours, ref in zip(image_utils.unmold_detections(det, masks, (80, 96, 3), window),
                         jax_image.unmold_detections(det, masks, (80, 96, 3), window)):
        np.testing.assert_array_equal(ours, ref)


def test_seeded_init_matches_the_carried_layout(pair):
    """init_params gives the keys and shapes params_from_jax gives, and
    the same values for the same seed."""
    cfg = Config(**CFG)
    carried = pair[3].state_dict()
    sd = init_params(cfg, seed=3, device="cpu")
    assert sorted(sd) == sorted(carried)
    assert all(sd[k].shape == carried[k].shape for k in sd)
    again = init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(v, again[k]) for k, v in sd.items())
