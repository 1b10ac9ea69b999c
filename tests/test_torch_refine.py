"""The refine head (``Config.use_refine_head``, the reference's dormant
``amodal_refine`` seam) against the JAX package's.

- ``tests/test_refine_and_dispatch.py::test_refine_head_train_outputs`` in
  the port: the training graph's ``refined`` output on shared weights,
  seeded images and the JAX step's target-layer draws, held against the
  JAX outputs (not only their shapes), in float64 on both sides (as the
  other whole-graph tests: the sampled ROIs are a discrete choice). The
  reference casts the mask logits and the refine output to float32, so
  they agree to float32 rounding.
- The head alone in bfloat16 against the JAX ``RefineHead`` in bfloat16,
  within a tolerance in units of 2^-8 of the reference's largest magnitude.
- Its weights: ``params_from_jax`` carries them under the names
  ``amodal_refine.conv{1..5}``, ``.bn{1..4}``, ``.deconv``; ``init_params``
  seeds them; a reference ``.pth`` (which never holds them) leaves them at
  the model's own values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.models.heads import RefineHead as JaxRefineHead
from sln_amodal_tpu.models.sln import SLNAmodal as JaxSLN, init_params as jax_init
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import init_params, mask_layers, params_from_jax
from sln_amodal_tpu_torch.models.heads import RefineHead
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from sln_amodal_tpu_torch.train import checkpoint as ckpt
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse)
from torch_port_helpers import random_variables

# the JAX test's configuration, in float64
CFG = dict(image_size=64, glm_input_size=33, pre_nms_limit=64, post_nms_rois_training=16,
           post_nms_rois_inference=16, train_rois_per_image=8, detection_max_instances=4,
           max_gt_instances=4, compute_dtype="float64", param_dtype="float64",
           use_refine_head=True)


@pytest.fixture(scope="module")
def shared():
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda k: jax_init(JaxConfig(**CFG), k), jax.random.PRNGKey(0))
    return random_variables(shapes, seed=3)


def gt_batch(cfg):
    """The JAX test's ground truth (one box, one layer mask), seeded images."""
    b, g, layers = 1, cfg.max_gt_instances, cfg.num_layers
    images = np.random.RandomState(4).uniform(-120, 130, (b, 64, 64, 3))
    ids = np.zeros((b, g), np.int32)
    ids[:, 0] = 1
    boxes = np.zeros((b, g, 4))
    boxes[0, 0] = [0.2, 0.2, 0.8, 0.8]
    masks = np.zeros((b, g, layers, 64, 64))
    masks[0, 0, 0, 16:48, 16:48] = 1.0
    return images, ids, boxes, masks


def test_refine_head_train_outputs(shared):
    cfg = Config(**CFG)
    images, ids, boxes, masks = gt_batch(cfg)
    rng = jax.random.PRNGKey(1)
    with jax.enable_x64(True):
        model = JaxSLN(JaxConfig(**CFG))
        ref = jax.jit(lambda v, k: model.apply(
            v, k, images, ids, boxes.astype(np.float32), masks.astype(np.float32),
            method=JaxSLN.train_step_outputs))(shared, rng)
        ref = jax.tree_util.tree_map(np.asarray, ref)
        p = cfg.post_nms_rois_training
        keys = [jax.random.split(k) for k in jax.random.split(rng, 1)]
        pos, neg = (torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k[j], (p,)))
                                               for k in keys])) for j in (0, 1))

    port = SLNAmodal(cfg, device="cpu")
    port.load_state_dict(params_from_jax(shared), strict=True)
    with torch.no_grad():
        out = port.train_step_outputs(
            torch.from_numpy(images), torch.from_numpy(ids),
            torch.from_numpy(boxes).float(), torch.from_numpy(masks).float(),
            pos_uniform=pos, neg_uniform=neg)
    t, mh = cfg.train_rois_per_image, cfg.mask_shape[0]
    assert out.refined.shape == (1, t, 2 * mh, 2 * mh, cfg.num_classes)
    assert out.refined.dtype == torch.float32
    assert np.isfinite(out.refined.numpy()).all()
    np.testing.assert_array_equal(out.targets.rois.numpy(), ref.targets.rois)
    np.testing.assert_allclose(out.mask_logits.numpy(), ref.mask_logits, rtol=1e-5,
                               atol=1e-5 * np.abs(ref.mask_logits).max())
    np.testing.assert_allclose(out.refined.numpy(), ref.refined, rtol=1e-5,
                               atol=1e-5 * np.abs(ref.refined).max())
    assert np.abs(ref.refined).max() > 0


def test_refine_head_off_by_default():
    cfg = Config(**dict(CFG, use_refine_head=False))
    model = SLNAmodal(cfg, device="cpu")
    assert not hasattr(model, "amodal_refine")
    assert not any(k.startswith("amodal_refine.") for k in init_params(cfg, device="cpu"))


def test_refine_head_bfloat16():
    """The head in bfloat16 (float32 weights, bfloat16 input) against the
    JAX head: within 4 units of 2^-8 of the largest |logit| (measured
    2.13)."""
    n_classes, cin = 2, 8
    head = JaxRefineHead(n_classes, dtype=jnp.bfloat16)
    x = np.random.RandomState(5).randn(6, 7, 7, cin).astype(np.float32)
    shapes = jax.eval_shape(head.init, jax.random.PRNGKey(0), x)
    variables = random_variables(shapes, seed=6, dtype=np.float32)
    ref = np.asarray(jax.jit(head.apply)(variables, x))
    sd = {}
    mask_layers(sd, variables["params"], "")
    port = RefineHead(n_classes, cin)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (6, 14, 14, n_classes)
    err = np.abs(out.numpy() - ref).max() / (2.0 ** -8 * np.abs(ref).max())
    assert err <= 4, err


def test_weights_carried_seeded_and_kept_on_pth_load(shared, tmp_path):
    cfg = Config(**CFG)
    carried = params_from_jax(shared)
    names = {k for k in carried if k.startswith("amodal_refine.")}
    want = ({f"amodal_refine.conv{i}.{p}" for i in range(1, 6) for p in ("weight", "bias")}
            | {f"amodal_refine.bn{i}.{p}" for i in range(1, 5)
               for p in ("weight", "bias", "running_mean", "running_var")}
            | {"amodal_refine.deconv.weight", "amodal_refine.deconv.bias"})
    assert names == want
    np.testing.assert_array_equal(
        carried["amodal_refine.conv1.weight"].numpy(),
        np.transpose(shared["params"]["amodal_refine"]["conv1"]["kernel"], (3, 2, 0, 1)))
    seeded = init_params(cfg, seed=0, device="cpu")
    assert names <= set(seeded) and float(seeded["amodal_refine.conv1.weight"].abs().max()) > 0
    # a reference .pth has no refine head: loading one keeps the template's
    path = str(tmp_path / "ref.pth")
    torch.save({k: v for k, v in carried.items() if k not in names}, path)
    loaded = ckpt.load_weights(path, seeded)
    assert all(torch.equal(loaded[k], seeded[k]) for k in names)
    assert torch.equal(loaded["mask.conv1.weight"], carried["mask.conv1.weight"])
