"""The port's staged SGD against the JAX package's optax chain.

- Stage masks: ``trainable_mask`` of the JAX package over its parameter
  tree, carried to the port's names through ``convert.params_from_jax``,
  equals the port's ``trainable_mask`` over its parameters, for every stage
  and for the three-stage schedule with and without ``sticky_freeze``.
- One update (two steps, so the momentum trace is used) of the JAX
  package's ``make_optimizer`` chain (zero the frozen grads, clip by global norm 5,
  + wd * p, momentum 0.9, -lr) against the port's ``StagedSGD``, with the
  clip triggered and not, in float64: within 1e-12.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.models.sln import init_params as jax_init
from sln_amodal_tpu.train import optim as jax_optim
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import params_from_jax
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from sln_amodal_tpu_torch.train import optim

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33,
           compute_dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def trees():
    """(JAX parameter shapes, the port's parameter and buffer names)."""
    shapes = jax.eval_shape(lambda k: jax_init(JaxConfig(**CFG), k), jax.random.PRNGKey(0))
    with torch.device("meta"):
        model = SLNAmodal(Config(**CFG), device="meta")
    return shapes, model


def carried(mask_tree, shapes):
    """A JAX boolean mask tree as {port name: bool}, through the weight
    mapping (each leaf a small array of its rank holding its mask value)."""
    filled = jax.tree_util.tree_map(lambda m, s: np.full((2,) * len(s.shape), float(m)),
                                    mask_tree, shapes)
    out = {}
    for name, t in params_from_jax({"params": filled}).items():
        values = set(t.reshape(-1).tolist())
        assert len(values) == 1, name
        out[name] = bool(values.pop())
    return out


@pytest.mark.parametrize("stage", sorted(optim.STAGES))
def test_stage_masks_equal_jax(trees, stage):
    shapes, model = trees
    ref = carried(jax_optim.trainable_mask(shapes, stage)["params"], shapes["params"])
    got = optim.trainable_mask(model, stage)
    params = set(got)
    assert params <= set(ref)
    assert {k: ref[k] for k in params} == got
    # what the port holds as buffers (frozen batch norm) is never trained in JAX
    assert not any(ref[k] for k in set(ref) - params)
    assert any(got.values())


@pytest.mark.parametrize("sticky", [False, True])
def test_schedule_masks_equal_jax(trees, sticky):
    shapes, model = trees
    jax_sched = jax_optim.StageSchedule(1e-3, sticky_freeze=sticky)
    port_sched = optim.StageSchedule(1e-3, sticky_freeze=sticky)
    assert port_sched.stages == jax_sched.stages
    for idx in range(3):
        ref = carried(jax_sched.stage_mask(shapes, idx)["params"], shapes["params"])
        got = port_sched.stage_mask(model, idx)
        assert {k: ref[k] for k in got} == got
    # sticky: the later stages train only what the heads stage trains
    if sticky:
        assert port_sched.stage_mask(model, 2) == optim.trainable_mask(model, "heads")


class Tiny(nn.Module):
    """Parameters named like the model's: trunk stage 4, an FPN lateral,
    the RPN, the classifier, the GLM."""

    def __init__(self):
        super().__init__()
        self.fpn = nn.ModuleDict({"C4": nn.Linear(3, 4), "P3_conv1": nn.Linear(4, 2)})
        self.rpn = nn.ModuleDict({"conv_class": nn.Linear(2, 5)})
        self.classifier = nn.ModuleDict({"linear_class": nn.Linear(5, 2)})
        self.GLM_modual = nn.ModuleDict({"aspp": nn.Linear(2, 2)})


JAX_NAMES = {"fpn.C4": ("fpn", "layer4"), "fpn.P3_conv1": ("fpn", "p3_lateral"),
             "rpn.conv_class": ("rpn", "conv_class"),
             "classifier.linear_class": ("classifier", "linear_class"),
             "GLM_modual.aspp": ("glm", "aspp")}


def jax_tree(named):
    """{'params': nested dict} of the JAX names, from {port name: array}."""
    tree = {}
    for port, (a, b) in JAX_NAMES.items():
        for part in ("weight", "bias"):
            tree.setdefault(a, {}).setdefault(b, {})[part] = named[f"{port}.{part}"]
    # frozen batch norm is a parameter in JAX and a buffer in the port
    tree["classifier"]["frozen_bn1"] = {"scale": jnp.ones(3, jnp.float64)}
    return {"params": tree}


def flat(tree):
    return {f"{port}.{part}": np.asarray(tree["params"][a][b][part])
            for port, (a, b) in JAX_NAMES.items() for part in ("weight", "bias")}


@pytest.mark.parametrize("stage", ["heads", "4+", "all"])
@pytest.mark.parametrize("grad_scale", [0.05, 40.0])     # clip not triggered / triggered
def test_update_equals_optax_chain(stage, grad_scale):
    torch.manual_seed(0)
    model = Tiny().double()
    rng = np.random.RandomState(1)
    init = {k: v.detach().numpy().copy() for k, v in model.named_parameters()}
    grads = [{k: rng.randn(*v.shape) * grad_scale for k, v in init.items()} for _ in range(2)]
    lr = 0.01

    def jax_stage(path):          # the stage predicate over the JAX names
        return jax_optim.STAGES[stage](path)

    with jax.enable_x64(True):
        params = jax_tree({k: jnp.asarray(v) for k, v in init.items()})
        tx = jax_optim.make_optimizer(params, jax_stage, lr)
        state = tx.init(params)
        norms = []
        for g in grads:
            g_tree = jax_tree({k: jnp.asarray(v) for k, v in g.items()})
            t_mask = jax_optim.trainable_mask(params, jax_stage)
            live = [np.asarray(x) for x, m in zip(jax.tree_util.tree_leaves(g_tree),
                                                 jax.tree_util.tree_leaves(t_mask)) if m]
            norms.append(float(np.sqrt(sum((x * x).sum() for x in live))))
            updates, state = tx.update(g_tree, state, params)
            params = optax.apply_updates(params, updates)
        ref = flat(params)

    opt = optim.StagedSGD(model, stage, lr)
    for g in grads:
        opt.zero_grad()
        for k, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(g[k])
        opt.step()
    if grad_scale > 1:
        assert min(norms) > 5.0
    else:
        assert max(norms) < 5.0
    got = {k: v.detach().numpy() for k, v in model.named_parameters()}
    mask = optim.trainable_mask(model, stage)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12, err_msg=k)
        assert np.array_equal(got[k], init[k]) == (not mask[k]), k


def test_clip_has_no_epsilon():
    """Exactly g / norm * max_norm at and above the norm, untouched below."""
    g = [torch.tensor([3.0, 4.0], dtype=torch.float64)]
    norm = optim.clip_by_global_norm_(g, 5.0)
    assert float(norm) == 5.0 and torch.equal(g[0], torch.tensor([3.0, 4.0], dtype=torch.float64) / 5.0 * 5.0)
    g = [torch.tensor([6.0, 8.0], dtype=torch.float64)]
    optim.clip_by_global_norm_(g, 5.0)
    assert torch.equal(g[0], torch.tensor([6.0, 8.0], dtype=torch.float64) / 10.0 * 5.0)
    g = [torch.tensor([0.3, 0.4], dtype=torch.float64)]
    optim.clip_by_global_norm_(g, 5.0)
    assert torch.equal(g[0], torch.tensor([0.3, 0.4], dtype=torch.float64))
