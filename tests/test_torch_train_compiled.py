"""The captured train step (``sln_amodal_tpu_torch/train/compiled_step.py``)
and validation's captured program on the CPU, where there is no graph.

The capture class is replaced by a stand-in: running a key's first call
eagerly is calling the step, a capture records nothing, and every replay
runs the step again on the key's static buffers, as a CUDA graph's replay
runs its kernels again on them. Everything else is the card's protocol:
the keys (accumulation phase and input shapes), the static buffers, the
first call eager, the capture at the second call followed by a replay, the
losses copied out, the graphs dropped with their stage. The tests run at
the training slice's reduced float64 configuration
(``test_torch_train_slice.py``) and hold the stand-in's steps bit for bit
to the plain ``train_step`` (losses, parameters, momentum, accumulator),
and its first three steps to the JAX package's jitted step chain within
the slice's 1e-6. The graph itself is held on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase ``train_graph``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.models.sln import SLNAmodal as JaxModel
from sln_amodal_tpu.train import optim as jax_optim
from sln_amodal_tpu.train.trainer import TrainState, make_train_step
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import params_from_jax
from sln_amodal_tpu_torch.train import compiled_step
from sln_amodal_tpu_torch.train import trainer as trainer_mod
from sln_amodal_tpu_torch.train.trainer import Trainer, epoch_generator, step_uniforms
from test_torch_compiled import StandInGraphs
from test_torch_train_slice import CFG, LR, jax_step_draws
from torch_port_helpers import Batches, lockstep
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse fixture)
from torch_port_helpers import shared  # noqa: F401  (fixture)

JAX_STEPS = 3


class StandInStepGraphs:
    """Captures on any device. ``calls`` records what ran: "eager" (a
    key's first call, on the side stream), "capture" (records nothing) and
    "replay" (the step run again on the static buffers)."""

    instances = []

    def __init__(self):
        self.calls = []
        StandInStepGraphs.instances.append(self)

    @staticmethod
    def captures_on(device):
        return True

    def run_side(self, fn, device):
        self.calls.append("eager")
        return fn()

    def capture_only(self, fn, device, inputs=()):
        self.calls.append("capture")

        def replay():
            self.calls.append("replay")
            fn(*inputs)

        return replay, None


@pytest.fixture
def stand_in(monkeypatch):
    StandInStepGraphs.instances = []
    monkeypatch.setattr(compiled_step, "CudaGraphs", StandInStepGraphs)
    return StandInStepGraphs


def jax_chain(variables, batch, steps):
    """The JAX package's jitted step (``make_train_step`` with the heads
    optimizer chain) ``steps`` times from ``variables`` on ``batch``: each
    step's losses and draws, and the parameters after the last step (as a
    reference state_dict)."""
    with jax.enable_x64(True):
        cfg = JaxConfig(**CFG)
        tx = jax_optim.make_optimizer(variables, "heads", LR)
        step = jax.jit(make_train_step(JaxModel(cfg), cfg, tx,
                                       trainable=jax_optim.trainable_mask(variables, "heads")))
        state = TrainState(variables, tx.init(variables), jnp.zeros((), jnp.int32))
        rng = jax.random.PRNGKey(11)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        losses, draws = [], []
        for _ in range(steps):
            rng, sub = jax.random.split(rng)
            state, step_losses = step(state, sub, jbatch)
            losses.append({k: float(v) for k, v in step_losses.items()})
            draws.append(jax_step_draws(sub, cfg.post_nms_rois_training))
        return losses, draws, params_from_jax(state.params)


@pytest.fixture(scope="module")
def heads_run(shared):
    """Four heads steps on the stand-in in lockstep with the plain step,
    the first three fed the JAX chain's draws; records the trainer's losses
    and parameters after step 3 and the JAX chain's numbers."""
    variables, sd, batch = shared
    ref_losses, jax_draws, jax_params = jax_chain(variables, batch, JAX_STEPS)
    # a fourth step, in the JAX draws' dtype (another dtype is another key)
    extra = step_uniforms(epoch_generator(0, 3), 2, CFG["post_nms_rois_training"])
    draws = [*jax_draws, tuple(u.to(jax_draws[0][0].dtype) for u in extra)]
    losses, at_3 = [], {}
    with pytest.MonkeyPatch.context() as mp:
        StandInStepGraphs.instances = []
        mp.setattr(compiled_step, "CudaGraphs", StandInStepGraphs)

        def on_step(epoch, trainer, step_losses):
            losses.append({k: float(v) for k, v in step_losses.items()})
            if epoch == JAX_STEPS:
                at_3.update({k: v.detach().clone() for k, v in trainer.model.named_parameters()
                             if v.requires_grad})

        trainer, program = lockstep(Config(**CFG), sd, [batch], draws, "heads", LR,
                                    on_step=on_step)
        graphs = StandInStepGraphs.instances[-1]
    return dict(trainer=trainer, program=program, calls=graphs.calls, losses=losses,
                params_at_3=at_3, jax_losses=ref_losses, jax_params=jax_params, start=sd)


def test_graphed_heads_steps_equal_plain_steps(heads_run):
    """(Checked in lockstep by the fixture, bit for bit.) The protocol: the
    first call eager, a capture and its replay at the second call, replays
    after it; one capture for the one key; the graphs dropped with the
    stage."""
    assert heads_run["calls"] == ["eager", "capture", "replay", "replay", "replay"]
    program = heads_run["program"]
    assert program.captures == 1 and len(program.keys()) == 1
    phase, shapes = program.keys()[0]
    assert phase == 0 and dict((k, s) for k, s, _ in shapes[:6])["images"] == (2, 64, 64, 3)
    assert heads_run["trainer"].step_program is None
    assert all(np.isfinite(v) for step in heads_run["losses"] for v in step.values())


def test_graphed_heads_steps_equal_the_jax_step_chain(heads_run):
    """The stand-in's first three steps against the JAX package's jitted
    step chain fed its draws: losses within 1e-6 relative at every step,
    parameters within 1e-6 of the update's size after the third."""
    for got, want in zip(heads_run["losses"], heads_run["jax_losses"]):
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-6 * abs(v), (k, got[k], v)
    got, ref, start = heads_run["params_at_3"], heads_run["jax_params"], heads_run["start"]
    update = max(float((ref[k] - start[k]).abs().max()) for k in got)
    assert update > 0
    for k, v in got.items():
        assert float((v - ref[k]).abs().max()) <= 1e-6 * update, k


def test_graphed_accumulation_equals_plain_micro_steps(shared, stand_in):
    """``accumulate_steps=2`` over micro-batches of one image (the rows of
    the slice's batch): two keys (phases 0 and 1), each with its first
    micro-step eager and its second captured and replayed; four micro-steps
    bit-equal to the plain ones (parameters unchanged after the first)."""
    _, sd, batch = shared
    rows = [{k: v[i:i + 1] for k, v in batch.items()} for i in (0, 1)]
    draws = [step_uniforms(epoch_generator(0, e), 1, CFG["post_nms_rois_training"])
             for e in range(4)]

    def unchanged_after_odd(epoch, trainer, losses):
        if epoch == 1:
            got = dict(trainer.model.named_parameters())
            assert all(torch.equal(got[k].detach(), sd[k]) for k in sd if k in got)

    trainer, program = lockstep(Config(**CFG), sd, rows, draws, "heads", LR,
                                accumulate_steps=2, on_step=unchanged_after_odd)
    assert stand_in.instances[-1].calls == ["eager", "eager", "capture", "replay",
                                            "capture", "replay"]
    assert program.captures == 2 and [k[0] for k in program.keys()] == [0, 1]
    assert trainer.optimizer.mini_step == 0


class FakeModelStep:
    """A cheap stand-in for ``train_step``: one loss, one update."""

    def __init__(self):
        self.calls = 0

    def __call__(self, model, optimizer, batch, generator=None, uniforms=None):
        self.calls += 1
        loss = batch["images"].double().mean() + uniforms[0].double().mean()
        return {"total": loss.detach()}


def test_keys_stages_cpu_and_a_failed_capture(shared, monkeypatch):
    """One capture per key; a new stage makes a new captured step and the
    previous stage's goes when its stage ends; with the real capture class
    a CPU ``Trainer`` never captures; a failing capture raises naming its
    key."""
    _, sd, batch = shared
    cfg = Config(**CFG)
    fake = FakeModelStep()
    monkeypatch.setattr(trainer_mod, "train_step", fake)
    trainer = Trainer(cfg, sd, device="cpu")
    programs = []

    def record(epoch):
        programs.append(trainer.step_program)

    trainer.train_stage(Batches(batch), "heads", LR, epochs=1, steps_per_epoch=2,
                        on_epoch_end=record)
    assert programs == [None] and trainer.step_program is None and fake.calls == 2

    monkeypatch.setattr(compiled_step, "CudaGraphs", StandInStepGraphs)
    smaller = {k: v[:1] for k, v in batch.items()}
    for stage in ("heads", "mask"):
        trainer.train_stage(Batches(batch, batch, smaller, smaller, batch), stage, LR,
                            epochs=1, steps_per_epoch=5, on_epoch_end=record)
    first, second = programs[1:]
    assert first is not second and trainer.step_program is None
    for program in (first, second):
        # two shapes: batch 2 (eager, capture) and batch 1 (eager, capture)
        assert program.captures == 2 and [k[1][0][1][0] for k in program.keys()] == [2, 1]
    # each stage: 2 eager calls, 2 captures and their replays, 1 replay
    assert fake.calls == 2 + 2 * 5

    class Failing(StandInStepGraphs):
        def capture_only(self, fn, device, inputs=()):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(compiled_step, "CudaGraphs", Failing)
    with pytest.raises(RuntimeError, match=r"train step for key \(0, .*'images', \(2, 64, 64, "
                                           r"3\).*not permitted"):
        trainer.train_stage(Batches(batch), "heads", LR, epochs=1, steps_per_epoch=2)
    assert trainer.step_program is None


def test_graphed_validate_equals_eager(shared, monkeypatch):
    """``validate`` through a captured program on the stand-in (the first
    batch warms it up and captures it, each batch replays it) equals the
    eager ``validate``; a CPU trainer's ``validate`` never captures. One
    image per batch, each row of the slice's batch in turn."""
    _, sd, batch = shared
    rows = [{k: v[i:i + 1] for k, v in batch.items()} for i in (0, 1)]
    trainer = Trainer(Config(**CFG), sd, device="cpu")
    eager = trainer.validate(Batches(*rows), steps=2)
    assert trainer._validation is None
    monkeypatch.setattr(trainer_mod, "CudaGraphs", StandInGraphs)
    graphed = trainer.validate(Batches(*rows), steps=2)
    assert trainer._validation.captures == 1
    assert graphed == eager and set(eager) >= {"total", "layer", "rpn_class"}
