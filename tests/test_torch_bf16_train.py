"""One training step of the port in bfloat16 (the ``Config`` default:
bfloat16 compute, float32 parameters, gradients and optimizer state)
against the JAX package's bfloat16 step.

The setting of ``test_torch_train_slice.py`` (64² images, ResNet-50, the
RPN-biased weights, ``profile_train.make_batch``'s batch of 2, the JAX
step's target-layer draws fed in) with float32 weights and bfloat16
compute on both sides. The RPN-biased recipe makes every RPN score equal,
so the proposals, and with the JAX draws the sampled ROIs, are the same
discrete choice in both packages: the sampled class ids must be equal. The
losses (float32 in both) and the float32 parameters after the step are
held within tolerances stated in units of 2^-8 (one bfloat16 rounding):
losses relative to themselves, parameters relative to the largest element
of the JAX step's update, with the maxima measured when the test was
written beside them.
"""

import numpy as np
import pytest
import torch

from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from sln_amodal_tpu_torch.profile_train import make_batch
from sln_amodal_tpu_torch.train.optim import StagedSGD
from sln_amodal_tpu_torch.train.trainer import to_device, train_step
from test_torch_train_slice import CFG as F64_CFG, LR, jax_reference_step, shared_weights
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse)

CFG = dict(F64_CFG, compute_dtype="bfloat16", param_dtype="float32")
UNIT = 2.0 ** -8


@pytest.fixture(scope="module")
def shared():
    variables, port_sd = shared_weights(CFG)
    batch = make_batch(Config(**CFG), 2, 0)
    return variables, port_sd, batch, jax_reference_step(variables, batch, cfg_kwargs=CFG)


# measured: losses 0.64 units at the most (mrcnn_class), parameters 1.41
@pytest.mark.parametrize("stage,loss_tol,param_tol", [("heads", 2, 4), ("all", 2, 4)])
def test_train_step_bfloat16_equals_jax(shared, stage, loss_tol, param_tol):
    _, port_sd, batch, (ref_losses, updated, draws, ref_class_ids) = shared
    model = SLNAmodal(Config(**CFG), device="cpu")
    model.load_state_dict(port_sd)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    opt = StagedSGD(model, stage, LR)
    seen = {}
    original = model.train_step_outputs

    def keep(*args, **kw):
        seen["out"] = original(*args, **kw)
        return seen["out"]

    model.train_step_outputs = keep
    losses = train_step(model, opt, to_device(batch, "cpu"), uniforms=draws)
    out = seen["out"]
    assert out.rpn_logits.dtype == out.rpn_deltas.dtype == torch.bfloat16
    assert out.class_logits.dtype == out.mask_logits.dtype == torch.float32
    np.testing.assert_array_equal(out.targets.class_ids.numpy(), ref_class_ids)
    assert int(out.targets.positive.sum()) > 0
    for k, v in losses.items():
        assert v.dtype == torch.float32
        err = abs(float(v) - ref_losses[k]) / (UNIT * abs(ref_losses[k]))
        assert err <= loss_tol, (k, float(v), ref_losses[k])
    got = dict(model.named_parameters())
    update = max(float((updated[stage][k] - port_sd[k]).abs().max()) for k in got)
    assert update > 0
    worst = max(float((got[k].detach() - updated[stage][k]).abs().max()) for k in got) / (UNIT * update)
    assert all(v.dtype == torch.float32 for v in got.values())
    assert worst <= param_tol, worst
    moved = {k for k in got if not torch.equal(got[k].detach(), port_sd[k])}
    assert ("fpn.C4.0.conv1.weight" in moved) == (stage == "all")
    assert "GLM_modual.base.aspp.c0.weight" not in moved
