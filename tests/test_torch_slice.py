"""The whole slice: the port's ``Detector.detect`` against the JAX
``Detector``, on shared weights carried by ``params_from_jax``.

Reduced configuration (64² images, ResNet-50, a 33² GLM input, few
proposals and detections), float64 on both sides, on the synthetic
COCOA-style images of ``tests/fixtures.py``. Boxes, class ids and the pasted
binary masks must be equal; scores (float32 probabilities in the reference)
agree to float32 rounding, since XLA's and PyTorch's float32 exp differ in
the last bit.
"""

import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from fixtures import make_synthetic_dataset
from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.infer import Detector as JaxDetector
from sln_amodal_tpu.models.sln import init_params as jax_init
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import init_params, params_from_jax
from sln_amodal_tpu_torch.infer import Detector
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from torch_port_helpers import random_variables

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33,
           pre_nms_limit=200, post_nms_rois_inference=32,
           detection_max_instances=6, mask_pool_size=8,
           compute_dtype="float64", param_dtype="float64")


def detecting_variables():
    """Seeded JAX variables of ``CFG``'s model, the random heads scaled so
    the model emits real detections: RPN scores spread over (0, 1), small
    box deltas, foreground-leaning classifier scores that are well apart."""
    shapes = jax.eval_shape(lambda k: jax_init(JaxConfig(**CFG), k), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=1)
    p = variables["params"]
    for head, key, scale in (("rpn", "conv_class", 0.01), ("rpn", "conv_bbox", 0.001),
                             ("classifier", "linear_bbox", 0.01),
                             ("classifier", "linear_class", 0.02)):
        p[head][key]["kernel"] = p[head][key]["kernel"] * scale
    p["classifier"]["linear_class"]["bias"] += np.array([0.0, 0.5])
    return variables


@pytest.fixture(scope="module")
def detections(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    make_synthetic_dataset(root, n_images=2, size=64, subset="val")
    images = [np.asarray(Image.open(p).convert("RGB"))
              for p in sorted(glob.glob(os.path.join(root, "val2014", "*.jpg")))]
    # one image off the model's size: the PIL squash resize in mold_inputs
    images[1] = np.asarray(Image.fromarray(images[1]).resize((80, 56)))

    jcfg = JaxConfig(**CFG)
    variables = detecting_variables()
    with jax.enable_x64(True):
        ref_det = JaxDetector(jcfg, variables)
        pending = ref_det.dispatch(images)
        ref = ref_det.collect(pending)
        ref_out = jax.tree_util.tree_map(np.asarray, pending.out)
    port = Detector(Config(**CFG), params_from_jax(variables), device="cpu")
    pending = port.dispatch(images)
    out = port.collect(pending)
    return images, ref, out, ref_out, port._fetch(pending)


def test_detect_matches_jax_detector(detections):
    images, ref, out, _, _ = detections
    assert sum(len(r["scores"]) for r in ref) > 0
    for i, (r, o) in enumerate(zip(ref, out)):
        assert o["masks"].shape == images[i].shape[:2] + (len(r["scores"]),)
        np.testing.assert_array_equal(o["rois"], r["rois"], err_msg=f"image {i}")
        np.testing.assert_array_equal(o["class_ids"], r["class_ids"])
        np.testing.assert_allclose(o["scores"], r["scores"], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(o["masks"], r["masks"])


def test_raw_outputs_match(detections):
    """The device outputs before unmolding: detection rows (boxes, class
    ids exact), validity, and mask logits (float32 in the reference)."""
    _, _, _, ref_out, (det, masks) = detections
    np.testing.assert_array_equal(det[..., :5], ref_out.detections[..., :5])
    np.testing.assert_allclose(det[..., 5], ref_out.detections[..., 5], rtol=1e-6)
    assert masks.dtype == np.float32 and masks.shape == ref_out.masks.shape
    np.testing.assert_allclose(masks, ref_out.masks, rtol=1e-5, atol=1e-6)


def test_entry_points_default_to_the_card():
    """No card and no device="cpu": the entry points raise, they do not
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = Config(**CFG)
    from sln_amodal_tpu_torch.convert import init_params
    from sln_amodal_tpu_torch.models.sln import SLNAmodal

    for make in (lambda: SLNAmodal(cfg), lambda: init_params(cfg, seed=0),
                 lambda: Detector(cfg, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_bfloat16_compute_is_refused():
    """An unknown dtype is refused; bfloat16 compute builds, with float32
    parameters (bfloat16 parameters are refused)."""
    with pytest.raises(ValueError, match="not supported"):
        Detector(Config(**dict(CFG, compute_dtype="float16")), {}, device="cpu")
    with pytest.raises(ValueError, match="param_dtype"):
        SLNAmodal(Config(**dict(CFG, compute_dtype="bfloat16", param_dtype="bfloat16")),
                  device="cpu")
    cfg = Config(**dict(CFG, compute_dtype="bfloat16", param_dtype="float32"))
    det = Detector(cfg, init_params(cfg, seed=0, device="cpu"), device="cpu")
    assert det.model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in det.model.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in det.model.buffers()} == {torch.float32}
    model = SLNAmodal(cfg, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
