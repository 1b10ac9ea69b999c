"""The port in bfloat16 (the ``Config`` default) against the JAX package's
bfloat16 graph, on shared float32 weights carried by ``params_from_jax``.

Both sides compute in bfloat16 with float32 parameters; the JAX side is
jitted on the CPU, as its model runs. The two round at the same points
(each convolution and matmul, the frozen BN's product and sum, the residual
adds) but not always the same way (XLA may keep a float32 intermediate
inside a fusion; the summation orders differ), so continuous outputs are
held within a tolerance stated in units of 2^-8 (one bfloat16 rounding) of
the reference's largest magnitude, with the maximum measured when the test
was written beside it. Stages that make a discrete choice (top-k, NMS, the
top-100, argmax) flip under one-ulp differences, so the whole slice is
checked stage by stage, each stage fed the JAX graph's own inputs to it: its
discrete outputs must then be equal. The whole ``Detector.detect`` is held
to the JAX ``Detector`` by a stated agreement criterion.

Module cases run at the reduced size of ``test_torch_models.py`` (64²,
ResNet-50, 33² GLM input); the slice at the tiny 128² configuration of
``tests/test_parity_full_graph.py`` (ResNet-101, 65² GLM input).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.detect.proposal import proposal_layer_batched as jax_proposals
from sln_amodal_tpu.infer import Detector as JaxDetector
from sln_amodal_tpu.models import common as jax_common
from sln_amodal_tpu.models.sln import SLNAmodal as JaxSLN, init_params as jax_init
from sln_amodal_tpu.ops.roi_align import (pyramid_roi_align_batched,
                                          pyramid_roi_align_gather_batched)
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import params_from_jax
from sln_amodal_tpu_torch.detect.detection import refine_detections
from sln_amodal_tpu_torch.detect.proposal import proposal_layer_batched
from sln_amodal_tpu_torch.infer import Detector
from sln_amodal_tpu_torch.models import common
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from sln_amodal_tpu_torch.ops.roi_align import (pyramid_roi_align_backward_plain,
                                                pyramid_roi_align_plain)
from sln_amodal_tpu_torch.serve.export import ServingDetector, export_detector
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse)
from torch_port_helpers import random_variables

BF = torch.bfloat16
CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33,
           pre_nms_limit=200, post_nms_rois_inference=32,
           detection_max_instances=6, mask_pool_size=8,
           compute_dtype="bfloat16", param_dtype="float32")
# tests/test_parity_full_graph.py::tiny_config, in bfloat16
TINY = dict(image_size=128, glm_input_size=65, pre_nms_limit=200, post_nms_rois_training=50,
            post_nms_rois_inference=50, train_rois_per_image=16, detection_max_instances=10,
            max_gt_instances=8, compute_dtype="bfloat16", param_dtype="float32")


def units(out, ref) -> float:
    """max |out - ref| in units of 2^-8 of max |ref|."""
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / (2.0 ** -8 * np.abs(ref).max()))


def to_np(tree):
    """A JAX output tree as numpy, bfloat16 leaves widened to float32."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)


def bf16(a) -> torch.Tensor:
    """A numpy array rounded to bfloat16 (the same values on both sides)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF)


def jnp_bf16(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def make_pair(cfg_kwargs, variables):
    jcfg, cfg = JaxConfig(**cfg_kwargs), Config(**cfg_kwargs)
    model = SLNAmodal(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return JaxSLN(jcfg), variables, model


_JITTED = {}


def run_jax(pair, fn, *args):
    """``fn`` of the pair's JAX model, jitted once per (model, method): pairs
    that share a model (other weights, same shapes) share the compile."""
    jmodel, variables, _ = pair
    key = (id(jmodel), fn)
    if key not in _JITTED:
        _JITTED[key] = jmodel, jax.jit(lambda v, *a: jmodel.apply(v, *a, method=fn))
    return to_np(_JITTED[key][1](variables, *args))


@pytest.fixture(scope="module")
def pair():
    shapes = jax.eval_shape(lambda k: jax_init(JaxConfig(**CFG), k), jax.random.PRNGKey(0))
    return make_pair(CFG, random_variables(shapes, seed=0, dtype=np.float32))


def images(seed, b=2, size=64):
    return np.random.RandomState(seed).uniform(-120, 130, (b, size, size, 3)).astype(np.float32)


# ------------------------------------------------------------ modules --

def test_parameters_float32_compute_bfloat16(pair):
    model = pair[2]
    assert model.compute_dtype == BF
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())


def test_backbone_fpn(pair):
    x = images(0)
    ref = run_jax(pair, lambda m, x: m.fpn(x), x)
    with torch.no_grad():
        out = pair[2].fpn(torch.from_numpy(x).to(BF))
    for o, r in zip(out, ref):
        assert o.dtype == BF
        assert units(o, r) <= 8        # measured 3.28


def test_rpn_head(pair):
    p = bf16(np.random.RandomState(1).randn(2, 16, 16, 256))
    ref = run_jax(pair, lambda m, p: m.rpn(p), jnp_bf16(p))
    with torch.no_grad():
        logits, probs, deltas = pair[2].rpn(p)
    assert (logits.dtype, probs.dtype, deltas.dtype) == (BF, torch.float32, BF)
    assert units(logits, ref[0]) <= 4  # measured 0.85
    assert units(probs, ref[1]) <= 4   # measured 1.04
    assert units(deltas, ref[2]) <= 4  # measured 1.33


def test_deeplab_aspp_msc(pair):
    """The GLM trunk, the ASPP's float32 accumulator and the MSC fusion."""
    x = bf16(images(2, size=33))
    ref = run_jax(pair, lambda m, x: m.glm(x), jnp_bf16(x))
    with torch.no_grad():
        out = pair[2].GLM_modual(x)
    assert out.dtype == torch.float32 and out.shape == (2, 5, 5, 182)
    assert units(out, ref) <= 8        # measured 2.67


@pytest.mark.parametrize("shape,size", [((2, 64, 64, 3), (33, 33)),
                                        ((2, 33, 33, 182), (65, 65)),
                                        ((1, 16, 12, 5), (7, 24))])
def test_resize_bilinear_matches_jax_bit_for_bit(shape, size):
    """Both resizes in bfloat16: the JAX package's two matmuls with
    bfloat16 weights, equal bit for bit (measured 0)."""
    x = bf16(np.random.RandomState(3).randn(*shape))
    ref = to_np(jax.jit(lambda a: jax_common.resize_bilinear(a, size))(jnp_bf16(x)))
    ref2 = to_np(jax.jit(lambda a: jax_common.resize_bilinear_2d(a, size))(jnp_bf16(x[..., 0])))
    out, out2 = common.resize_bilinear(x, size), common.resize_bilinear_2d(x[..., 0], size)
    assert out.dtype == out2.dtype == BF
    np.testing.assert_array_equal(out.float().numpy(), ref)
    np.testing.assert_array_equal(out2.float().numpy(), ref2)


def test_classifier_head(pair):
    crops = bf16(np.random.RandomState(4).randn(12, 7, 7, 256))
    ref = run_jax(pair, lambda m, c: m.classifier(c), jnp_bf16(crops))
    with torch.no_grad():
        out = pair[2].classifier(crops)
    for o, r, measured in zip(out, ref, (1.80, 0.75, 1.33)):
        assert o.dtype == torch.float32
        assert units(o, r) <= 4, measured


def test_mask_head(pair):
    rng = np.random.RandomState(5)
    fpn_crop, glm_crop = bf16(rng.randn(5, 8, 8, 256)), rng.rand(5, 8, 8, 183).astype(np.float32)
    ref = run_jax(pair, lambda m, f, g: m.mask(f, g), jnp_bf16(fpn_crop), glm_crop)
    with torch.no_grad():
        logits, feat = pair[2].mask(fpn_crop, torch.from_numpy(glm_crop))
    assert (logits.dtype, feat.dtype) == (torch.float32, BF)
    assert units(logits, ref[0]) <= 6  # measured 2.38
    assert units(feat, ref[1]) <= 6    # measured 2.49


def roi_case(seed, crop):
    """bfloat16 levels, float32 boxes (some past the edge, one inverted),
    a bfloat16 cotangent."""
    rng = np.random.RandomState(seed)
    feats = [bf16(rng.randn(2, s, s, 8)) for s in (64, 32, 16, 8)]
    boxes = []
    for i in range(24):
        size = (0.06, 0.45, 0.12, 0.9)[i % 4]
        y, x = rng.uniform(-0.1, 1.0 - size * 0.8, 2)
        boxes.append([y, x, y + size, x + size])
    boxes = np.asarray(boxes, np.float32).reshape(2, 12, 4)
    boxes[0, 0] = [0.7, 0.2, 0.3, 0.6]
    return feats, boxes, bf16(rng.randn(2, 12, *crop, 8))


@pytest.mark.parametrize("crop,measured", [((7, 7), 2.27), ((16, 16), 2.55)])
def test_roi_align_forward(crop, measured):
    """The plain forward (float32 interpolation, one rounding: the kernel's
    arithmetic) against the JAX gather, which rounds each op to bfloat16."""
    feats, boxes, _ = roi_case(0, crop)
    ref = to_np(jax.jit(lambda fs: pyramid_roi_align_gather_batched(
        fs, jnp.asarray(boxes), crop, (256, 256)))([jnp_bf16(f) for f in feats]))
    out = pyramid_roi_align_plain(feats, torch.from_numpy(boxes), crop, (256, 256))
    assert out.dtype == BF
    assert units(out, ref) <= 4, measured


@pytest.mark.parametrize("crop", [(7, 7), (16, 16)])
def test_roi_align_backward(crop):
    """The plain backward (float32 sums, one rounding) against the JAX
    custom VJP: within 1 unit (measured 0.0003)."""
    feats, boxes, grad = roi_case(1, crop)

    @jax.jit
    def vjp(fs, g):
        _, f = jax.vjp(lambda fs: pyramid_roi_align_batched(
            fs, jnp.asarray(boxes), crop, (256, 256), impl="blocked"), fs)
        return f(g)[0]

    ref = to_np(vjp([jnp_bf16(f) for f in feats], jnp_bf16(grad)))
    out = pyramid_roi_align_backward_plain(grad, torch.from_numpy(boxes),
                                           [tuple(f.shape[1:]) for f in feats], crop,
                                           (256, 256), BF)
    scale = max(np.abs(r).max() for r in ref)
    for o, r in zip(out, ref):
        assert o.dtype == BF
        assert float(np.abs(o.float().numpy() - r).max()) <= 2.0 ** -8 * scale


def test_rpn_score_ties_take_the_lower_index():
    """bfloat16 logits give exact ties in the RPN scores: the proposal
    layer keeps them in index order, as ``lax.top_k`` does, and equals the
    JAX layer on the same inputs."""
    rng = np.random.RandomState(6)
    a = 300
    logits = bf16(rng.choice([-0.5, 0.0, 0.25, 0.5], size=(2, a, 2)))
    probs = torch.softmax(logits.float(), dim=-1)
    deltas = bf16(rng.randn(2, a, 4) * 0.1)
    y, x = rng.uniform(0, 100, (2, a))
    anchors = np.stack([y, x, y + rng.uniform(8, 28, a), x + rng.uniform(8, 28, a)],
                       -1).astype(np.float32)
    kw = dict(proposal_count=40, nms_threshold=0.7, image_size=128,
              rpn_bbox_std_dev=(0.1, 0.1, 0.2, 0.2), pre_nms_limit=120)
    assert len(np.unique(probs[..., 1].numpy())) <= 9         # 600 scores, 9 values
    ref = to_np(jax.jit(lambda p, d: jax_proposals(p, d, jnp.asarray(anchors), **kw))(
        probs.numpy(), jnp_bf16(deltas)))
    rois, valid = proposal_layer_batched(probs, deltas, torch.from_numpy(anchors), **kw)
    np.testing.assert_array_equal(valid.numpy(), ref[1])
    np.testing.assert_allclose(rois.numpy(), ref[0], rtol=0, atol=1e-6)


# -------------------------------------------------------------- slice --

def detecting_variables(cfg_kwargs):
    """Seeded float32 variables with the heads scaled so the model detects
    (``test_torch_slice.py``'s recipe)."""
    shapes = jax.eval_shape(lambda k: jax_init(JaxConfig(**cfg_kwargs), k),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=1, dtype=np.float32)
    p = variables["params"]
    for head, key, scale in (("rpn", "conv_class", 0.01), ("rpn", "conv_bbox", 0.001),
                             ("classifier", "linear_bbox", 0.01),
                             ("classifier", "linear_class", 0.02)):
        p[head][key]["kernel"] = p[head][key]["kernel"] * scale
    p["classifier"]["linear_class"]["bias"] += np.array([0.0, 0.5], np.float32)
    return variables


def jax_stages(m, images, windows):
    """The JAX bfloat16 graph's stage outputs (``SLNAmodal._infer_impl``'s
    detect-only path), each stage's inputs included."""
    c = m.config
    feats = m.fpn(images)
    _, probs, deltas = m._rpn_all_levels(feats)
    glm_in = jax_common.resize_bilinear(images.astype(jnp.bfloat16), (c.glm_input_size,) * 2)
    prior, _ = m._glm_prior(images, need_label=False)
    rois, valid = m._proposals(probs, deltas, c.post_nms_rois_inference)
    class_logits, class_probs, class_deltas = m._classifier_on(feats[:4], rois)
    out = m.infer_detect_only(images, windows)
    boxes_px = jnp.clip(out.detections[..., :4], 0.0, float(c.image_size))
    mask_logits = m._mask_on(feats[:4], boxes_px / float(c.image_size), prior, boxes_px)
    return dict(feats=feats, probs=probs, deltas=deltas, glm_logits=m.glm(glm_in), prior=prior,
                rois=rois, valid=valid, class_logits=class_logits, class_probs=class_probs,
                class_deltas=class_deltas, detections=out.detections,
                det_valid=out.det_valid, mask_logits=mask_logits, masks=out.masks)


@pytest.fixture(scope="module")
def tiny():
    pair = make_pair(TINY, detecting_variables(TINY))
    rng = np.random.RandomState(0)
    x = rng.uniform(-120, 130, (2, 128, 128, 3)).astype(np.float32)
    windows = np.array([[0, 0, 128, 128], [10, 0, 118, 128]], np.float32)
    return pair, x, windows, run_jax(pair, jax_stages, x, windows)


def t(a, dtype=None):
    out = torch.from_numpy(np.asarray(a))
    return out if dtype is None else out.to(dtype)


def test_slice_backbone_and_rpn(tiny):
    (_, _, model), x, _, ref = tiny
    with torch.no_grad():
        feats = model.fpn(t(x, BF))
        _, probs, deltas = model._rpn_all_levels([t(f, BF) for f in ref["feats"]])
    assert max(units(o, r) for o, r in zip(feats, ref["feats"])) <= 8   # measured 3.51
    assert units(probs, ref["probs"]) <= 6                               # measured 3.20
    assert units(deltas, ref["deltas"]) <= 6                             # measured 1.79


def test_slice_proposals(tiny):
    """On the JAX RPN outputs: the same ROIs kept (validity equal), boxes
    within float32 rounding (XLA's and PyTorch's exp differ in the last
    bit; measured 6e-8)."""
    (_, _, model), _, _, ref = tiny
    rois, valid = model._proposals(t(ref["probs"]), t(ref["deltas"], BF),
                                   model.config.post_nms_rois_inference)
    np.testing.assert_array_equal(valid.numpy(), ref["valid"])
    np.testing.assert_allclose(rois.numpy(), ref["rois"], rtol=0, atol=1e-6)


def test_slice_classifier(tiny):
    """On the JAX levels and ROIs: the RoIAlign (another bfloat16 rounding
    form) and the classifier."""
    (_, _, model), _, _, ref = tiny
    levels = [t(f, BF).contiguous() for f in ref["feats"][:4]]
    with torch.no_grad():
        logits, _, deltas = model._classifier_on(levels, t(ref["rois"]))
    assert units(logits, ref["class_logits"]) <= 8   # measured 4.06
    assert units(deltas, ref["class_deltas"]) <= 6   # measured 2.27


def test_slice_refine_detections(tiny):
    """On the JAX classifier outputs: the same top detections, equal."""
    (_, _, model), _, windows, ref = tiny
    cfg = model.config
    det, det_valid = refine_detections(
        t(ref["rois"]), t(ref["valid"]), t(ref["class_probs"]), t(ref["class_deltas"]),
        t(windows), image_size=cfg.image_size, bbox_std_dev=cfg.rpn_bbox_std_dev,
        max_instances=cfg.detection_max_instances,
        min_confidence=cfg.detection_min_confidence, use_nms=cfg.use_nms,
        nms_threshold=cfg.detection_nms_threshold)
    assert bool(det_valid.all())
    np.testing.assert_array_equal(det_valid.numpy(), ref["det_valid"])
    np.testing.assert_array_equal(det.numpy(), ref["detections"])


def test_slice_glm_prior(tiny, monkeypatch):
    """The GLM logits within tolerance; on the JAX logits, the prior (its
    softmax and argmax label channel) equal to the JAX prior."""
    (_, _, model), x, _, ref = tiny
    with torch.no_grad():
        logits = model.GLM_modual(common.resize_bilinear(t(x, BF), (65, 65)))
        assert units(logits, ref["glm_logits"]) <= 8      # measured 3.10
        monkeypatch.setattr(model.GLM_modual, "forward", lambda _: t(ref["glm_logits"]))
        prior, _ = model._glm_prior(t(x), need_label=False)
    np.testing.assert_array_equal(np.rint(prior[..., -1].numpy() * 255),
                                  np.rint(ref["prior"][..., -1] * 255))
    np.testing.assert_allclose(prior.numpy(), ref["prior"], rtol=0, atol=1e-6)


def test_slice_mask_head(tiny):
    """On the JAX levels, detections and prior: the 16x16 RoIAlign and the
    mask head."""
    (_, _, model), _, _, ref = tiny
    levels = [t(f, BF).contiguous() for f in ref["feats"][:4]]
    boxes_px = torch.clamp(t(ref["detections"])[..., :4], 0.0, 128.0)
    with torch.no_grad():
        logits = model._mask_on(levels, boxes_px / 128.0, t(ref["prior"]), boxes_px)
    assert logits.dtype == torch.float32
    assert units(logits, ref["mask_logits"]) <= 8    # measured 3.39


def box_iou(a, b):
    """IoU matrix of pixel boxes [N, 4] and [M, 4] (y1, x1, y2, x2)."""
    a, b = a[:, None].astype(np.float64), b[None].astype(np.float64)
    inter = (np.clip(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0, None)
             * np.clip(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0,
                       None))
    area = lambda z: (z[..., 2] - z[..., 0]) * (z[..., 3] - z[..., 1])  # noqa: E731
    return inter / (area(a) + area(b) - inter)


def test_detect_agrees_with_jax_detector(tiny):
    """The whole ``Detector.detect`` in bfloat16 against the JAX
    ``Detector``. Agreement criterion, per image: the same number of
    detections; at least 60% of the JAX boxes matched by a port box at IoU
    >= 0.9 (measured 70% in both images: the seeded classifier's scores lie
    within bfloat16 noise of each other, so the top 10 reorder), each with
    the same class and a score within 1e-4 (measured 3.8e-5); the pasted
    masks of matched pairs equal on at least 85% of the image each
    (measured 89.7% at the least) and 93% on average (measured 95.8% and
    98.4%)."""
    (_, variables, _), _, _, _ = tiny
    rng = np.random.RandomState(7)
    imgs = [rng.randint(0, 256, (128, 128, 3), np.uint8) for _ in range(2)]
    ref = JaxDetector(JaxConfig(**TINY), variables).detect(imgs)
    out = Detector(Config(**TINY), params_from_jax(variables), device="cpu").detect(imgs)
    for r, o in zip(ref, out):
        assert len(o["scores"]) == len(r["scores"]) > 0
        iou = box_iou(r["rois"], o["rois"])
        best = iou.argmax(1)
        matched = iou.max(1) >= 0.9
        assert matched.mean() >= 0.6, iou.max(1)
        agree = []
        for i in np.nonzero(matched)[0]:
            j = best[i]
            assert o["class_ids"][j] == r["class_ids"][i]
            assert abs(o["scores"][j] - r["scores"][i]) <= 1e-4
            agree.append((o["masks"][..., j] == r["masks"][..., i]).mean())
        assert min(agree) >= 0.85 and np.mean(agree) >= 0.93, agree


def exact_rpn_variables():
    """``detecting_variables(TINY)`` with the RPN made exact: zero class and
    box kernels and a (bg, fg) = (0, 1) class bias for every anchor, so
    every anchor scores the same on both sides and the proposals are the
    anchors in stable order, refined by zero deltas."""
    variables = detecting_variables(TINY)
    rpn = variables["params"]["rpn"]
    for key in ("conv_class", "conv_bbox"):
        rpn[key] = {k: np.zeros_like(v) for k, v in rpn[key].items()}
    rpn["conv_class"]["bias"][1::2] = 1.0
    return variables


@pytest.fixture(scope="module")
def exact_rpn(tiny):
    """The tiny fixture's JAX model (its compile reused) with the exact-RPN
    weights, on its inputs."""
    (jmodel, _, _), x, windows, _ = tiny
    _, variables, model = make_pair(TINY, exact_rpn_variables())
    pair = jmodel, variables, model
    return pair, x, windows, run_jax(pair, jax_stages, x, windows)


def test_slice_on_own_inputs_with_exact_proposals(exact_rpn):
    """The port's detect-only graph end to end on its own stage outputs
    (the slice tests above feed each stage the JAX graph's), with proposals
    that no rounding can move (:func:`exact_rpn_variables`): the ROIs equal
    the JAX graph's bit for bit, and the FPN levels and the classifier
    logits stay within the slice tests' bounds (measured 4.02 and 5.94
    units: the classifier's own 2.45 on the JAX levels, grown by the
    levels' differences).

    This bounds what a stricter ``Detector.detect`` case can ask (ROADMAP
    F1). The logits move by about 2% of their magnitude (0.28 of a logit,
    the largest being 12.1), and the class probabilities by up to 0.049.
    A score s moves by s(1 - s) times its logit's move, so holding scores
    within 1e-3 keeps every logit within a few tenths of zero; the spread
    of N detections' logits, and the gap between adjacent scores, shrink
    with it. Scores within 1e-3 and 8 bfloat16 units apart then leave room
    for about three detections, not the ten of this size."""
    (_, _, model), x, _, ref = exact_rpn
    with torch.no_grad():
        feats = model.fpn(t(x, BF))
        _, probs, deltas = model._rpn_all_levels(feats)
        rois, valid = model._proposals(probs, deltas, model.config.post_nms_rois_inference)
        logits, _, _ = model._classifier_on([f.contiguous() for f in feats[:4]], rois)
    assert max(units(o, r) for o, r in zip(feats, ref["feats"])) <= 8   # measured 4.02
    np.testing.assert_array_equal(probs.numpy(), ref["probs"])
    np.testing.assert_array_equal(valid.numpy(), ref["valid"])
    np.testing.assert_array_equal(rois.numpy(), ref["rois"])
    assert units(logits, ref["class_logits"]) <= 8                       # measured 5.94


def test_export_and_serving_equal_the_detector(tmp_path):
    """A bfloat16 artifact: the manifest records the dtype, and the served
    ``detect`` equals the bfloat16 ``Detector``'s bit for bit."""
    cfg = Config(**dict(CFG, glm_scales=(0.5,)))
    sd = params_from_jax(detecting_variables(CFG))
    rng = np.random.RandomState(8)
    imgs = [rng.randint(0, 256, (64, 64, 3), np.uint8) for _ in range(2)]
    want = Detector(cfg, sd, device="cpu").detect(imgs)
    art = export_detector(cfg, sd, str(tmp_path / "art"), batch=2, device="cpu")
    with open(tmp_path / "art" / "manifest.json") as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    got = ServingDetector.load(art).detect(imgs)
    for g, w in zip(got, want):
        for k in ("rois", "class_ids", "scores", "masks"):
            np.testing.assert_array_equal(g[k], w[k])
