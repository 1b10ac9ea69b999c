"""The training slice: one step of the port against the JAX package's, the
``train`` command, kill-and-resume, and the import rule.

Reduced configuration (64² images, ResNet-50, a 17² GLM input, 32
proposals, 8 sampled ROIs, 4x4 mask pooling), float64 on both sides, weights shared through
``params_from_jax``: seeded numpy variables with the JAX package's
``rpn_biased_variables`` recipe (the port's recipe on its state_dict equals
it). The batch is ``profile_train.make_batch``'s: the ground truth on the
biased RPN's first proposals, so positive ROIs reach the heads, and RPN
targets from the (shared) host pipeline.

The JAX side is the loss function of ``train/trainer.py::make_train_step``
(``train_step_outputs`` -> ``batched_losses``) under one ``jax.jit`` of
``value_and_grad``, and the optax chain of ``make_optimizer`` for each stage
(the step itself compiles once per chain; the loss and the gradients are
the same). The port gets the JAX step's target-layer draws. Losses agree to
1e-6 relative and the updated parameters to 1e-6 of the update's size: the
losses are float32 in both packages (their casts), which bounds the
gradients' agreement.
"""

import copy
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fixtures import make_synthetic_dataset
from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.models.sln import SLNAmodal as JaxModel
from sln_amodal_tpu.models.sln import init_params as jax_init
from sln_amodal_tpu.train import optim as jax_optim
from sln_amodal_tpu.train.trainer import batched_losses as jax_batched_losses
from sln_amodal_tpu.utils import synthetic as jax_synthetic
from sln_amodal_tpu_torch.cli import export_model
from sln_amodal_tpu_torch.cli import train as cli
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import params_from_jax
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from sln_amodal_tpu_torch.profile_train import make_batch
from sln_amodal_tpu_torch.train import checkpoint as ckpt
from sln_amodal_tpu_torch.train.optim import StagedSGD
from sln_amodal_tpu_torch.train.trainer import Trainer, to_device, train_step
from sln_amodal_tpu_torch.utils.synthetic import rpn_biased_variables
from torch_port_helpers import random_variables
from torch_port_helpers import shared  # noqa: F401  (fixture)

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=17, pre_nms_limit=400,
           post_nms_rois_training=32, post_nms_rois_inference=32, train_rois_per_image=8,
           mask_pool_size=4, mask_shape=(8, 8),
           detection_max_instances=16, max_gt_instances=4, rpn_train_anchors_per_image=64,
           batch_size=2, compute_dtype="float64", param_dtype="float64")
LR = 1e-3


def shared_weights(cfg_kwargs=CFG):
    """(JAX variables, the port's state_dict of the same weights): seeded
    numpy variables under the RPN-biased recipe of each package, in the
    parameter dtype of ``cfg_kwargs``."""
    with jax.enable_x64(cfg_kwargs["param_dtype"] == "float64"):
        cfg = JaxConfig(**cfg_kwargs)
        shapes = jax.eval_shape(lambda k: jax_init(cfg, k), jax.random.PRNGKey(0))
        variables = random_variables(shapes, seed=1, dtype=np.dtype(cfg_kwargs["param_dtype"]))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_synthetic, "init_params", lambda c, r: copy.deepcopy(variables))
            biased = jax_synthetic.rpn_biased_variables(cfg)
    return biased, rpn_biased_variables(params_from_jax(variables))


def jax_step_draws(rng, rois):
    """The target layer's uniforms (pos, neg) [2, rois] that the JAX step
    draws from its key ``rng`` for a batch of two, as torch tensors."""
    pairs = [jax.random.split(k) for k in jax.random.split(rng, 2)]
    return tuple(torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k[j], (rois,)))
                                            for k in pairs])) for j in (0, 1))


def jax_reference_step(variables, batch, stages=("heads", "all"), cfg_kwargs=CFG):
    """The JAX step on ``batch`` (numpy): its losses, its updated parameters
    for each of ``stages`` (as reference state_dicts), its target-layer
    draws and its sampled class ids."""
    rng = jax.random.PRNGKey(7)
    with jax.enable_x64(cfg_kwargs["param_dtype"] == "float64"):
        cfg = JaxConfig(**cfg_kwargs)
        model = JaxModel(cfg)

        def loss_fn(params, rng, batch):      # make_train_step's loss_fn
            out = model.apply(params, rng, batch["images"], batch["gt_class_ids"],
                              batch["gt_boxes"].astype(jnp.float32),
                              batch["gt_masks"].astype(jnp.float32),
                              method=JaxModel.train_step_outputs)
            losses = jax_batched_losses(cfg, out, batch)
            return losses["total"], (losses, out.targets.class_ids)

        (_, (losses, class_ids)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables, rng, {k: jnp.asarray(v) for k, v in batch.items()})
        updated = {}
        for stage in stages:
            tx = jax_optim.make_optimizer(variables, stage, LR)

            @jax.jit
            def update(grads, params):
                updates, _ = tx.update(grads, tx.init(params), params)
                return optax.apply_updates(params, updates)

            updated[stage] = params_from_jax(update(grads, variables))
        draws = jax_step_draws(rng, cfg.post_nms_rois_training)
    return ({k: float(v) for k, v in losses.items()}, updated, draws,
            np.asarray(class_ids))


@pytest.fixture(scope="module")
def jax_step(shared):
    return jax_reference_step(shared[0], shared[2])


def assert_step_equals_jax(model, start, losses, ref_losses, updated):
    """Losses within 1e-6 relative of the JAX step's, and every parameter
    within 1e-6 of the update's size of the JAX step's update from
    ``start``."""
    assert set(losses) == set(ref_losses)
    for k, v in losses.items():
        assert abs(float(v) - ref_losses[k]) <= 1e-6 * abs(ref_losses[k]), (k, float(v), ref_losses[k])
    got = dict(model.named_parameters())
    update = max(float((updated[k] - start[k]).abs().max()) for k in got)
    assert update > 0
    for k, v in got.items():
        err = float((v.detach() - updated[k]).abs().max())
        assert err <= 1e-6 * update, (k, err, update)


def test_rpn_biased_recipe_equals_jax(shared):
    variables, port_sd, _ = shared
    ref = params_from_jax(variables)
    assert set(ref) == set(port_sd)
    for k in ref:
        assert torch.equal(port_sd[k], ref[k]), k


@pytest.mark.parametrize("stage", ["heads", "all"])
def test_train_step_equals_jax(shared, jax_step, stage):
    _, port_sd, batch = shared
    ref_losses, updated, draws, ref_class_ids = jax_step
    model = SLNAmodal(Config(**CFG), device="cpu")
    model.load_state_dict(port_sd)
    opt = StagedSGD(model, stage, LR)
    out = {}
    original = model.train_step_outputs

    def keep(*args, **kw):
        outputs = original(*args, **kw)
        out["targets"] = outputs.targets
        return outputs

    model.train_step_outputs = keep
    losses = train_step(model, opt, to_device(batch, "cpu"), uniforms=draws)
    np.testing.assert_array_equal(out["targets"].class_ids.numpy(), ref_class_ids)
    assert int(out["targets"].positive.sum()) > 0
    assert ref_losses["mrcnn_class"] > 0 and ref_losses["layer"] > 0
    assert_step_equals_jax(model, port_sd, losses, ref_losses, updated[stage])
    got = dict(model.named_parameters())
    moved = {k for k in got if not torch.equal(got[k].detach(), port_sd[k])}
    assert ("fpn.C4.0.conv1.weight" in moved) == (stage == "all")
    assert "fpn.P2_conv2.1.weight" in moved and "GLM_modual.base.aspp.c0.weight" not in moved


# --------------------------------------------------------- the train CLI --

SMALL = dict(CFG, compute_dtype="float32", param_dtype="float32")


@pytest.fixture()
def small_cli(shared, monkeypatch):
    """The CLI on the reduced config in float32, its seeded template the
    shared weights."""
    sd32 = {k: v.to(torch.float32) for k, v in shared[1].items()}
    monkeypatch.setattr(cli, "train_config", lambda args: Config(
        **dict(SMALL, name=args.data_type.lower(), batch_size=args.batch_size,
               steps_per_epoch=args.steps_per_epoch)))
    monkeypatch.setattr(cli, "eval_config", lambda args: Config(
        **dict(SMALL, name=args.data_type.lower(), batch_size=1)))
    monkeypatch.setattr(cli, "init_params", lambda config, seed=0, device="cuda": {
        k: v.clone().to(device) for k, v in sd32.items()})
    return sd32


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    make_synthetic_dataset(root, n_images=4, size=64, subset="train")
    make_synthetic_dataset(root, n_images=2, size=64, subset="val", seed=3)
    return root


@pytest.fixture()
def logs(tmp_path):
    """A checkpoint directory, deleted after the test: each checkpoint of
    the reduced model holds the full GLM trunk (~0.4 GB with its .state)."""
    path = tmp_path / "logs"
    yield str(path)
    shutil.rmtree(path, ignore_errors=True)


def test_train_cli_writes_checkpoints_evaluate_loads(small_cli, dataset_root, logs, capsys):
    common = ["--dataset", dataset_root, "--logs", logs, "--device", "cpu", "--batch_size", "2"]
    out = cli.main(["train", "--stage", "heads", "--epochs", "1", "--steps_per_epoch", "2",
                    "--model", "random", "--validate_steps", "1", *common])
    printed = capsys.readouterr().out
    assert "step 2/2" in printed and "  val " in printed and "total number of parameters" in printed
    path = ckpt.checkpoint_path(logs, "cocoa", 1)
    assert out.checkpoints == [path] and os.path.exists(path + ".state")
    assert out.trainer.step == 2
    sd = torch.load(path, weights_only=True)
    assert set(sd) == set(small_cli)
    assert not torch.equal(sd["mask.conv5.weight"], small_cli["mask.conv5.weight"])
    assert torch.equal(sd["fpn.C4.0.conv1.weight"], small_cli["fpn.C4.0.conv1.weight"])
    ev = cli.main(["evaluate", "--dataset", dataset_root, "--model", "last", "--logs", logs,
                   "--device", "cpu", "--eval_batch", "2"])
    assert "Loading weights" in capsys.readouterr().out
    assert ev.seconds > 0

    # --resume: nothing left at --epochs 1; from the .state at --epochs 2
    assert cli.main(["train", "--stage", "heads", "--epochs", "1", "--steps_per_epoch", "2",
                     "--resume", *common]).trainer is None
    assert "nothing left to train" in capsys.readouterr().out
    out = cli.main(["train", "--stage", "heads", "--epochs", "2", "--steps_per_epoch", "2",
                    "--resume", *common])
    assert out.checkpoints == [ckpt.checkpoint_path(logs, "cocoa", 2)]
    assert out.trainer.step == 4 and out.trainer.epoch == 2


class OneBatch:
    """A loader that yields the same batch forever."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        while True:
            yield self.batch


def test_kill_and_resume_equals_an_uninterrupted_run(shared, logs):
    """Cut after epoch 1 of 3 (its checkpoint and .state written), resumed
    from them: the parameters equal an uninterrupted run's."""
    sd32 = {k: v.to(torch.float32) for k, v in shared[1].items()}
    loader = OneBatch(make_batch(Config(**SMALL), 2, 1))
    cfg = Config(**SMALL)

    def run(kill_after=None, resume=None):
        trainer = Trainer(cfg, resume[0] if resume else sd32, device="cpu")
        trainer.epoch = 1 if resume else 0

        def cut(epoch):
            if epoch == kill_after:
                ckpt.save(trainer.model.state_dict(), logs, "run", epoch)
                ckpt.save_train_state(trainer.model, trainer.optimizer, trainer.step, logs,
                                      "run", epoch)
                raise KeyboardInterrupt

        trainer.train_stage(loader, "heads", 1e-3, epochs=3, steps_per_epoch=2, seed=5,
                            on_epoch_end=cut, resume_state_path=resume and resume[1],
                            start_epoch=1 if resume else 0)
        return trainer

    full = run()
    with pytest.raises(KeyboardInterrupt):
        run(kill_after=1)
    path = ckpt.checkpoint_path(logs, "run", 1)
    resumed = run(resume=(ckpt.load_weights(path, sd32), path + ".state"))
    assert resumed.step == full.step == 6 and resumed.epoch == full.epoch == 3
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mask.conv5.weight"], sd32["mask.conv5.weight"])


def test_accumulation_cut_between_micro_steps_resumes_equal(shared, logs):
    """Two micro-batches per update, one epoch each: the first micro-step
    leaves the parameters bit-unchanged; a run cut after it (checkpoint and
    .state with the accumulator written) and resumed equals an
    uninterrupted run, whose second micro-step moved the parameters."""
    sd32 = {k: v.to(torch.float32) for k, v in shared[1].items()}
    loader = OneBatch(make_batch(Config(**SMALL), 2, 1))
    cfg = Config(**SMALL)
    seen = {}

    def run(kill_after=None, resume=None):
        trainer = Trainer(cfg, resume[0] if resume else sd32, device="cpu")
        trainer.epoch = 1 if resume else 0

        def end(epoch):
            seen[epoch] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            if epoch == kill_after:
                ckpt.save(trainer.model.state_dict(), logs, "acc", epoch)
                ckpt.save_train_state(trainer.model, trainer.optimizer, trainer.step, logs,
                                      "acc", epoch)
                raise KeyboardInterrupt

        trainer.train_stage(loader, "heads", 1e-3, epochs=2, steps_per_epoch=1, seed=5,
                            on_epoch_end=end, accumulate_steps=2,
                            resume_state_path=resume and resume[1],
                            start_epoch=1 if resume else 0)
        return trainer

    full = run()
    assert all(torch.equal(seen[1][k], sd32[k]) for k in sd32)
    assert full.optimizer.mini_step == 0 and full.step == 2
    with pytest.raises(KeyboardInterrupt):
        run(kill_after=1)
    path = ckpt.checkpoint_path(logs, "acc", 1)
    resumed = run(resume=(ckpt.load_weights(path, sd32), path + ".state"))
    assert resumed.step == full.step
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mask.conv5.weight"], sd32["mask.conv5.weight"])


def test_train_defaults_to_the_card_in_float32():
    """``train`` and ``export_model`` default to the card in the ``Config``
    dtypes: bfloat16 compute, float32 parameters (the float32 master
    weights the optimizer updates)."""
    args = cli.build_parser().parse_args(["train", "--dataset", "d"])
    cfg = cli.train_config(args)
    assert args.device == "cuda" and (cfg.compute_dtype, cfg.param_dtype) == ("bfloat16", "float32")
    assert cfg == Config(name="cocoa", batch_size=1, steps_per_epoch=2500)
    seen = {}

    def stop_at_init(config, **kw):
        seen["config"], seen["device"] = config, kw["device"]
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(export_model, "init_params", stop_at_init)
        with pytest.raises(SystemExit):
            export_model.main(["--model", "random", "--out", "d"])
    assert (seen["config"].compute_dtype, seen["config"].param_dtype) == ("bfloat16", "float32")
    assert seen["device"] == "cuda"


def test_training_modules_import_no_jax():
    """The training modules import with jax, flax, optax and the JAX
    package made unimportable (the whole port: test_torch_eval_slice.py)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import importlib, sys
for name in ("jax", "jaxlib", "flax", "optax", "sln_amodal_tpu"):
    sys.modules[name] = None
for name in ("detect.targets", "train.losses", "train.optim", "train.trainer",
             "train.compiled_step", "compiled", "train.checkpoint", "data.pipeline", "utils.synthetic", "cli.train",
             "ops.roi_align_cuda", "parallel.mesh", "parallel.multihost"):
    importlib.import_module("sln_amodal_tpu_torch." + name)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
