"""The port's staged SGD against the JAX package's optax chain.

- Stage masks: ``trainable_mask`` of the JAX package over its parameter
  tree, carried to the port's names through ``convert.params_from_jax``,
  equals the port's ``trainable_mask`` over its parameters, for every stage
  and for the three-stage schedule with and without ``sticky_freeze``.
- One update (two steps, so the momentum trace is used) of the JAX
  package's ``make_optimizer`` chain (zero the frozen grads, clip by global norm 5,
  + wd * p, momentum 0.9, -lr) against the port's ``StagedSGD``, with the
  clip triggered and not, in float64: within 1e-12; the same chain in
  ``optax.MultiSteps`` against ``accumulate_steps=2``.
- A ``.state`` of the layout before accumulation still loads.
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


def optax_and_port(stage, grads, lr, accumulate_steps=1):
    """``grads`` (one {name: array} per step) through the JAX package's
    ``make_optimizer`` (in ``optax.MultiSteps`` when ``accumulate_steps >
    1``) and the port's ``StagedSGD`` on a ``Tiny`` model: (initial, JAX
    and port parameters after each step as {name: array}, the global norms
    of the gradients each optimizer clipped: JAX's of what reached the
    inner chain, the port's as ``step`` returns them)."""
    torch.manual_seed(0)
    model = Tiny().double()
    init = {k: v.detach().numpy().copy() for k, v in model.named_parameters()}

    def jax_stage(path):          # the stage predicate over the JAX names
        return jax_optim.STAGES[stage](path)

    with jax.enable_x64(True):
        params = jax_tree({k: jnp.asarray(v) for k, v in init.items()})
        t_mask = jax_optim.trainable_mask(params, jax_stage)
        tx = jax_optim.make_optimizer(params, jax_stage, lr)
        if accumulate_steps > 1:
            tx = optax.MultiSteps(tx, every_k_schedule=accumulate_steps)
        state = tx.init(params)
        ref, norms, acc = [], [], []
        for g in grads:
            g_tree = jax_tree({k: jnp.asarray(v) for k, v in g.items()})
            acc.append([np.asarray(x) for x, m in zip(jax.tree_util.tree_leaves(g_tree),
                                                     jax.tree_util.tree_leaves(t_mask)) if m])
            if len(acc) == accumulate_steps:
                mean = [sum(xs) / len(acc) for xs in zip(*acc)]
                norms.append(float(np.sqrt(sum((x * x).sum() for x in mean))))
                acc = []
            updates, state = tx.update(g_tree, state, params)
            params = optax.apply_updates(params, updates)
            ref.append(flat(params))

    opt = optim.StagedSGD(model, stage, lr, accumulate_steps=accumulate_steps)
    got, port_norms = [], []
    for g in grads:
        opt.zero_grad()
        for k, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(g[k])
        norm = opt.step()
        if norm is not None:
            port_norms.append(float(norm))
        got.append({k: v.detach().numpy().copy() for k, v in model.named_parameters()})
    return model, init, ref, got, norms, port_norms


def random_grads(steps, grad_scale):
    torch.manual_seed(0)
    shapes = {k: v.shape for k, v in Tiny().named_parameters()}
    rng = np.random.RandomState(1)
    return [{k: rng.randn(*s) * grad_scale for k, s in shapes.items()} for _ in range(steps)]


@pytest.mark.parametrize("stage", ["heads", "4+", "all"])
@pytest.mark.parametrize("grad_scale", [0.05, 40.0])     # clip not triggered / triggered
def test_update_equals_optax_chain(stage, grad_scale):
    model, init, ref, got, norms, _ = optax_and_port(stage, random_grads(2, grad_scale), 0.01)
    if grad_scale > 1:
        assert min(norms) > 5.0
    else:
        assert max(norms) < 5.0
    mask = optim.trainable_mask(model, stage)
    for k in ref[-1]:
        np.testing.assert_allclose(got[-1][k], ref[-1][k], rtol=0, atol=1e-12, err_msg=k)
        assert np.array_equal(got[-1][k], init[k]) == (not mask[k]), k


@pytest.mark.parametrize("grad_scale", [0.05, 40.0])     # clip not triggered / triggered
def test_accumulation_equals_optax_multisteps(grad_scale):
    """``accumulate_steps=2`` against ``optax.MultiSteps(make_optimizer(...),
    2)`` over 4 micro-steps (two updates, so the momentum is used): every
    parameter bit-unchanged on the micro-steps that do not update, within
    1e-12 on those that do, and the clipped norm that of the mean gradient.
    Where the clip does not bind, a summed accumulator would double the
    update and fail."""
    model, init, ref, got, norms, port_norms = optax_and_port(
        "all", random_grads(4, grad_scale), 0.01, accumulate_steps=2)
    if grad_scale > 1:
        assert min(norms) > 5.0
    else:
        assert max(norms) < 5.0
    np.testing.assert_allclose(port_norms, norms, rtol=1e-12)
    previous = init
    for i, (r, g) in enumerate(zip(ref, got)):
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=1e-12, err_msg=(i, k))
        moved = any(not np.array_equal(g[k], previous[k]) for k in g)
        assert moved == (i % 2 == 1), i
        previous = g


def test_state_without_accumulator_loads():
    """A ``.state`` written before accumulation holds the bare SGD state:
    it restores the momentum, at micro-step 0 with an empty accumulator."""
    torch.manual_seed(0)
    model = Tiny().double()
    opt = optim.StagedSGD(model, "all", 0.01)
    for p in opt.params:
        p.grad = torch.ones_like(p)
    opt.step()
    bare = opt.sgd.state_dict()
    for k in (1, 2):
        again = optim.StagedSGD(model, "all", 0.01, accumulate_steps=k)
        again.load_state_dict(bare)
        assert again.mini_step == 0
        assert all(torch.equal(again.sgd.state[p]["momentum_buffer"],
                               opt.sgd.state[p]["momentum_buffer"]) for p in opt.params)
        assert k == 1 or all(float(a.abs().max()) == 0.0 for a in again.accumulated)


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
