"""Data parallelism and gradient accumulation of the port (``parallel/``, the
optimizer's all-reduce, ``accumulate_steps``, ``Detector(mesh=...)``, the
multi-process loaders and the CLI's flags) against the JAX package.

- ``partition_ids`` and the loaders' slices equal the JAX functions'.
- The whole slice: two processes over gloo, each on one row of the float64
  batch of ``test_torch_train_slice.py`` with the JAX step's draws of its
  row, take one heads and one all step. Their losses are within 1e-6
  relative of the JAX batch-2 step's, their parameters within 1e-6 of the
  update's size, and equal to each other bit for bit.
- Accumulation: two micro-batches of one row against
  ``optax.MultiSteps(make_optimizer(...), 2)``, same tolerances; the first
  micro-step leaves the parameters bit-unchanged.
- ``Detector(mesh=(cpu, cpu))`` on a ragged batch of 3 against the JAX
  ``Detector`` without a mesh (``tests/test_sharded_infer.py`` holds the
  JAX sharded one equal to that), as ``test_torch_slice.py`` compares.
- ``cli.train train --num_processes 2`` over gloo, two processes on the CPU.

Every process group lives in a subprocess of its own (a group left in the
test process would break the next test there); each subprocess has a
timeout, so a hang fails instead of stalling the suite.
"""

import glob
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from fixtures import make_synthetic_dataset
from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.infer import Detector as JaxDetector
from sln_amodal_tpu.models.sln import SLNAmodal as JaxModel
from sln_amodal_tpu.parallel import multihost as jax_multihost
from sln_amodal_tpu.train import optim as jax_optim
from sln_amodal_tpu.train.trainer import batched_losses as jax_batched_losses
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import init_params, params_from_jax
from sln_amodal_tpu_torch.data.dataset import AmodalDataset
from sln_amodal_tpu_torch.data import device_prep
from sln_amodal_tpu_torch.data.device_prep import DevicePrepLoader, encode_sample
from sln_amodal_tpu_torch.infer import Detector
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from sln_amodal_tpu_torch.parallel import multihost
from sln_amodal_tpu_torch.parallel.mesh import make_mesh, shard_batch
from sln_amodal_tpu_torch.profile_train import make_batch
from sln_amodal_tpu_torch.train.optim import StagedSGD, trainable_mask
from sln_amodal_tpu_torch.train.trainer import step_uniforms, to_device, train_step
from sln_amodal_tpu_torch.utils.synthetic import rpn_biased_variables
from test_torch_slice import CFG as SLICE_CFG
from test_torch_slice import detecting_variables
from test_torch_train_slice import (CFG, LR, SMALL, assert_step_equals_jax, jax_reference_step,
                                    shared_weights)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_processes(tmp_path, source, *args):
    """Runs ``source`` as two processes (argv: rank, a free port, ``args``)
    and returns their output; each must exit 0 within ``TIMEOUT`` s."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(source))
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), port, *map(str, args)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out}"
    return outs


# ------------------------------------------------------------ partitions --

@pytest.mark.parametrize("n,count,index", [(12, 4, None), (10, 4, None), (7, 1, 0), (4, 2, 2)],
                         ids=["even_split", "wraps_like_distributed_sampler",
                              "single_process", "bad_rank"])
def test_partition_ids_equal_jax(n, count, index):
    """The cases of ``tests/test_multihost.py``: equal ceil(N/P) slices
    covering the ids, the tail wrapped to the front, identity for one
    process, and a rank out of range refused, as the JAX function does."""
    ids = np.arange(n)
    if index is not None and not 0 <= index < count:
        for fn in (multihost.partition_ids, jax_multihost.partition_ids):
            with pytest.raises(ValueError):
                fn(ids, index, count)
        return
    ranks = range(count) if index is None else [index]
    shards = [multihost.partition_ids(ids, i, count) for i in ranks]
    for i, shard in zip(ranks, shards):
        np.testing.assert_array_equal(shard, jax_multihost.partition_ids(ids, i, count))
    assert len({len(s) for s in shards}) == 1
    flat = np.concatenate(shards).tolist()
    assert flat[:n] == list(range(n)) and flat[n:] == list(range(len(flat) - n))


def test_initialize_single_process_is_noop():
    multihost.initialize(num_processes=1)
    multihost.initialize(num_processes=None)
    assert not multihost.is_distributed()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    with pytest.raises(ValueError, match="--coordinator"):
        multihost.initialize(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="--process_id"):
        multihost.initialize("localhost:1", 2, None, device="cpu")
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend("cuda:0") == "nccl"


def test_step_uniforms_are_rows_of_the_global_draw(monkeypatch):
    """Every process draws the global batch's uniforms and keeps its rows;
    one process draws what the target layer draws itself."""
    ref = torch.rand((2, 4, 8), generator=torch.Generator().manual_seed(3))
    pos, neg = step_uniforms(torch.Generator().manual_seed(3), 4, 8)
    assert torch.equal(pos, ref[0]) and torch.equal(neg, ref[1])
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    for rank in (0, 1):
        monkeypatch.setattr(multihost, "process_index", lambda: rank)
        pos, neg = step_uniforms(torch.Generator().manual_seed(3), 2, 8)
        rows = slice(2 * rank, 2 * rank + 2)
        assert torch.equal(pos, ref[0, rows]) and torch.equal(neg, ref[1, rows])


def test_mesh_splits_rows_in_blocks():
    mesh = make_mesh(["cpu", "cpu"])
    assert mesh == (torch.device("cpu"), torch.device("cpu"))
    x, w = torch.arange(8).reshape(4, 2), torch.arange(4)
    (x0, w0), (x1, w1) = shard_batch((x, w), mesh)
    assert torch.equal(x0, x[:2]) and torch.equal(x1, x[2:]) and torch.equal(w1, w[2:])
    with pytest.raises(ValueError, match="split evenly"):
        shard_batch((x[:3],), mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()


# ------------------------------------------------------------- loaders --

@pytest.fixture(scope="module")
def prep_data(tmp_path_factory):
    root = make_synthetic_dataset(str(tmp_path_factory.mktemp("dp_prep")), n_images=4,
                                  size=64, subset="train")
    ds = AmodalDataset()
    ds.load_amodal(root, "train")
    ds.prepare()
    return ds, Config(image_size=64, name="dp", batch_size=1)


def test_device_prep_loader_per_process(prep_data, monkeypatch):
    """Each process's ``DevicePrepLoader`` streams its slice, folds its
    index into its draws, and skips (and counts) a sample over the RLE
    budget."""
    ds, cfg = prep_data

    def loader(index, count=2):
        return DevicePrepLoader(ds, cfg, seed=0, workers=1, device="cpu",
                                process_index=index, process_count=count)

    loaders = [loader(0), loader(1)]
    for i, ld in enumerate(loaders):
        np.testing.assert_array_equal(ld.local_ids, multihost.partition_ids(ds.image_ids, i, 2))
    a, b, again = loaders[0]._draws(1), loaders[1]._draws(1), loader(1)._draws(1)
    assert not torch.equal(a.pos, b.pos) and torch.equal(b.pos, again.pos)

    # one image of the slice over the budget (the synthetic maps have few runs)
    ld = loaders[1]
    over = int(ld.local_ids[0])

    def encode(dataset, config, image_id, dense_planes=True):
        enc = encode_sample(dataset, config, image_id, dense_planes)
        if image_id == over:
            enc["n_runs"] = np.int32(ld._rle_budget + 1)
        return enc

    monkeypatch.setattr(device_prep, "encode_sample", encode)
    stream = ld._sample_stream()
    kept = [next(stream) for _ in range(2 * len(ld.local_ids))]
    assert ld.overflow_count >= 2 and ld.error_count == 0
    assert all(int(s["n_runs"]) <= ld._rle_budget for s in kept)


# ------------------------------------------------- the whole slice, DP --

STEP_WORKER = """
    import sys
    import torch
    from sln_amodal_tpu_torch.config import Config
    from sln_amodal_tpu_torch.models.sln import SLNAmodal
    from sln_amodal_tpu_torch.parallel import multihost
    from sln_amodal_tpu_torch.train.optim import StagedSGD
    from sln_amodal_tpu_torch.train.trainer import to_device, train_step

    rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(2)
    data = torch.load(path + "/in.pt", weights_only=False)
    multihost.initialize(f"localhost:{port}", 2, rank, device="cpu")
    try:
        assert multihost.process_index() == rank and multihost.process_count() == 2
        model = SLNAmodal(Config(**data["config"]), device="cpu")
        row = to_device({k: v[rank:rank + 1] for k, v in data["batch"].items()}, "cpu")
        draws = tuple(d[rank:rank + 1] for d in data["draws"])
        out = {}
        for stage in ("heads", "all"):
            model.load_state_dict(data["state_dict"])
            opt, norms = StagedSGD(model, stage, data["lr"]), []
            step = opt.step
            opt.step = lambda: norms.append(float(step()))
            losses = train_step(model, opt, row, uniforms=draws)
            # the frozen parameters are checked here, the trained ones written
            params = dict(model.named_parameters())
            assert all(torch.equal(p, data["state_dict"][k]) for k, p in params.items()
                       if not p.requires_grad)
            out[stage] = ({k: float(v) for k, v in losses.items()}, list(params),
                          {k: p.detach().clone() for k, p in params.items() if p.requires_grad},
                          norms[0])
        torch.save(out, f"{path}/out{rank}.pt")
    finally:
        multihost.shutdown()
"""


def as_model(params):
    """What ``assert_step_equals_jax`` reads of a model: its parameters."""
    return types.SimpleNamespace(named_parameters=lambda: params.items())


@pytest.fixture(scope="module")
def shared():
    """(JAX variables, the port's state_dict of the same weights, batch of
    2) of ``test_torch_train_slice.py``."""
    return (*shared_weights(), make_batch(Config(**CFG), 2, 0))


@pytest.fixture()
def scratch(tmp_path):
    """A directory for the processes' files, deleted after the test: the
    reduced model's float64 weights are ~0.6 GB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def clipped_norm(sd, batch, stage, draws):
    """The global norm that ``StagedSGD.step`` clips in one step of one
    process on ``batch``."""
    model = SLNAmodal(Config(**CFG), device="cpu")
    model.load_state_dict(sd)
    opt, norms = StagedSGD(model, stage, LR), []
    step = opt.step
    opt.step = lambda: norms.append(float(step()))
    train_step(model, opt, to_device(batch, "cpu"), uniforms=draws)
    return norms[0]


def test_two_process_steps_equal_jax_batch_step(shared, scratch):
    """Two gloo processes, one row each with its JAX draws: the heads and
    the all step of the JAX package on the batch of both rows (the frozen
    parameters are checked unchanged in the processes). The norm they clip
    is the one-process batch-2 step's (where the clip binds, a sum of the
    processes' gradients in place of their mean shows only in it)."""
    variables, port_sd, batch = shared
    ref_losses, updated, draws, _ = jax_reference_step(variables, batch)
    torch.save({"config": CFG, "lr": LR, "state_dict": port_sd, "draws": draws,
                "batch": {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}},
               scratch / "in.pt")
    run_processes(scratch, STEP_WORKER, scratch)
    outs = [torch.load(scratch / f"out{r}.pt", weights_only=False) for r in (0, 1)]
    for stage in ("heads", "all"):
        (losses0, names, trained0, norm0), (losses1, _, trained1, norm1) = outs[0][stage], \
            outs[1][stage]
        assert losses0 == losses1 and 0 < len(trained0) < len(names)
        one = clipped_norm(port_sd, batch, stage, draws)
        assert norm0 == norm1 and abs(norm0 - one) <= 1e-9 * one, (stage, norm0, one)
        assert all(torch.equal(trained0[k], trained1[k]) for k in trained0)
        params = {k: trained0.get(k, port_sd[k]) for k in names}
        assert_step_equals_jax(as_model(params), port_sd, losses0, ref_losses, updated[stage])


# --------------------------------------------------------- accumulation --

def jax_row_steps(variables, rows, stage):
    """The JAX loss and gradients of each row (a batch of one) with its own
    key, and ``optax.MultiSteps(make_optimizer(...), 2)`` over them: (each
    row's losses, its target-layer draws, the parameters after each
    micro-step as reference state_dicts), and the global norm of the mean
    of the rows' trained gradients."""
    with jax.enable_x64(True):
        cfg = JaxConfig(**CFG)
        model = JaxModel(cfg)

        def loss_fn(params, rng, batch):      # make_train_step's loss_fn
            out = model.apply(params, rng, batch["images"], batch["gt_class_ids"],
                              batch["gt_boxes"].astype(jnp.float32),
                              batch["gt_masks"].astype(jnp.float32),
                              method=JaxModel.train_step_outputs)
            losses = jax_batched_losses(cfg, out, batch)
            return losses["total"], losses

        value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        tx = optax.MultiSteps(jax_optim.make_optimizer(variables, stage, LR), every_k_schedule=2)
        update = jax.jit(tx.update)
        state, params = tx.init(variables), variables
        p = CFG["post_nms_rois_training"]
        out, trained = [], []
        mask = jax.tree_util.tree_leaves(jax_optim.trainable_mask(variables, stage))
        for i, row in enumerate(rows):
            rng = jax.random.PRNGKey(20 + i)
            (_, losses), grads = value_and_grad(params, rng, {k: jnp.asarray(v)
                                                              for k, v in row.items()})
            trained.append([np.asarray(g) for g, m in zip(jax.tree_util.tree_leaves(grads), mask)
                            if m])
            updates, state = update(grads, state, params)
            params = optax.apply_updates(params, updates)
            keys = jax.random.split(jax.random.split(rng, 1)[0])
            draws = tuple(torch.from_numpy(np.asarray(jax.random.uniform(keys[j], (p,)))[None])
                          for j in (0, 1))
            out.append(({k: float(v) for k, v in losses.items()}, draws,
                        params_from_jax(params)))
        mean = [sum(gs) / len(gs) for gs in zip(*trained)]
    return out, float(np.sqrt(sum((g * g).sum() for g in mean)))


def test_accumulation_equals_optax_multisteps(shared):
    """Two micro-batches of one row each through ``StagedSGD(...,
    accumulate_steps=2)`` against ``optax.MultiSteps``: the first leaves
    every parameter as it was, the second steps on the mean gradient, whose
    norm is the one clipped."""
    variables, port_sd, batch = shared
    rows = [{k: v[i:i + 1] for k, v in batch.items()} for i in (0, 1)]
    ref, ref_norm = jax_row_steps(variables, rows, "all")
    assert all(torch.equal(ref[0][2][k], port_sd[k]) for k in port_sd)

    model = SLNAmodal(Config(**CFG), device="cpu")
    model.load_state_dict(port_sd)
    opt = StagedSGD(model, "all", LR, accumulate_steps=2)
    step, norms = opt.step, []
    opt.step = lambda: norms.append(step())
    mask = trainable_mask(model, "all")
    assert len(opt.accumulated) == sum(mask.values()) < len(mask)
    for i, (ref_losses, draws, ref_params) in enumerate(ref):
        losses = train_step(model, opt, to_device(rows[i], "cpu"), uniforms=draws)
        if i == 0:
            for k, v in losses.items():
                assert abs(float(v) - ref_losses[k]) <= 1e-6 * abs(ref_losses[k]), k
            assert opt.mini_step == 1
            assert all(torch.equal(v.detach(), port_sd[k]) for k, v in model.named_parameters())
        else:
            assert opt.mini_step == 0
            assert all(float(a.abs().max()) == 0.0 for a in opt.accumulated)
            assert_step_equals_jax(model, port_sd, losses, ref_losses, ref_params)
    assert norms[0] is None and abs(float(norms[1]) - ref_norm) <= 1e-6 * ref_norm
    heads = StagedSGD(model, "heads", LR, accumulate_steps=2)
    assert len(heads.accumulated) == sum(trainable_mask(model, "heads").values()) \
        < len(opt.accumulated)


# -------------------------------------------------------------- serving --

def test_mesh_detector_equals_jax_detector(tmp_path):
    """``Detector(mesh=(cpu, cpu))`` on a ragged batch of 3 (padded to 4):
    boxes, class ids and pasted masks equal the JAX ``Detector``'s without
    a mesh, scores to float32 rounding; ``collect_crops`` walks the real
    images only."""
    root = make_synthetic_dataset(str(tmp_path), n_images=3, size=64, subset="val")
    images = [np.asarray(Image.open(p).convert("RGB"))
              for p in sorted(glob.glob(os.path.join(root, "val2014", "*.jpg")))]
    images[1] = np.asarray(Image.fromarray(images[1]).resize((80, 56)))
    variables = detecting_variables()
    with jax.enable_x64(True):
        ref = JaxDetector(JaxConfig(**SLICE_CFG), variables).detect(images)
    det = Detector(Config(**SLICE_CFG), params_from_jax(variables), mesh=("cpu", "cpu"))
    pending = det.dispatch(images)
    assert len(pending.out) == 2 and pending.windows.shape[0] == 4
    out = det.collect(pending)
    assert len(out) == 3 and sum(len(r["scores"]) for r in ref) > 0
    for i, (r, o) in enumerate(zip(ref, out)):
        np.testing.assert_array_equal(o["rois"], r["rois"], err_msg=f"image {i}")
        np.testing.assert_array_equal(o["class_ids"], r["class_ids"])
        np.testing.assert_allclose(o["scores"], r["scores"], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(o["masks"], r["masks"])
    crops = det.collect_crops(det.dispatch(images))
    assert len(crops) == 3
    for r, c in zip(ref, crops):
        np.testing.assert_array_equal(c["rois"], r["rois"])
        assert len(c["crops"]) == len(r["scores"])


# ------------------------------------------------------------------ CLI --

CLI_WORKER = """
    import sys
    import torch
    from sln_amodal_tpu_torch.cli import train as cli
    from sln_amodal_tpu_torch.config import Config

    rank, port, path, root = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    torch.set_num_threads(2)
    data = torch.load(path + "/in.pt", weights_only=False)
    cli.train_config = lambda args: Config(**dict(
        data["config"], name=args.data_type.lower(), batch_size=args.batch_size,
        steps_per_epoch=args.steps_per_epoch))
    cli.init_params = lambda config, seed=0, device="cuda": {
        k: v.clone().to(device) for k, v in data["state_dict"].items()}
    out = cli.main(["train", "--dataset", root, "--logs", path + "/logs", "--device", "cpu",
                    "--model", "random", "--stage", "heads", "--epochs", "1",
                    "--steps_per_epoch", "2", "--batch_size", "1", "--validate_steps", "1",
                    "--coordinator", f"localhost:{port}", "--num_processes", "2",
                    "--process_id", str(rank)])
    assert not torch.distributed.is_initialized()
    torch.save({"checkpoints": out.checkpoints, "step": out.trainer.step,
                "params": {k: v.detach() for k, v in out.trainer.model.named_parameters()
                           if v.requires_grad}},
               f"{path}/out{rank}.pt")
"""


def test_train_cli_two_processes(scratch):
    """``train --coordinator --num_processes 2 --process_id i`` on the CPU:
    both processes start from process 0's weights, train on their slices
    in step (equal parameters and logged losses at the end), process 0
    writes the checkpoint and its .state, and both leave the group."""
    root = make_synthetic_dataset(str(scratch / "data"), n_images=4, size=64, subset="train")
    make_synthetic_dataset(root, n_images=2, size=64, subset="val", seed=3)
    sd = rpn_biased_variables(init_params(Config(**SMALL), seed=0, device="cpu"))
    torch.save({"config": SMALL, "state_dict": sd}, scratch / "in.pt")
    logs = run_processes(scratch, CLI_WORKER, scratch, root)
    outs = [torch.load(scratch / f"out{r}.pt", weights_only=False) for r in (0, 1)]
    path = str(scratch / "logs" / "cocoa" / "sln_amodal_cocoa_0001.pth")
    assert outs[0]["checkpoints"] == outs[1]["checkpoints"] == [path]
    assert os.path.exists(path) and os.path.exists(path + ".state")
    assert outs[0]["step"] == outs[1]["step"] == 2
    assert outs[0]["params"] and outs[0]["params"].keys() == outs[1]["params"].keys()
    assert all(torch.equal(v, outs[1]["params"][k]) for k, v in outs[0]["params"].items())
    assert sum("checkpoint:" in log for log in logs) == 1
    lines = [[ln for ln in log.splitlines() if "step 2/2" in ln or " val " in ln]
             for log in logs]
    assert len(lines[0]) == 2 and [ln.split(" (")[0] for ln in lines[0]] == \
        [ln.split(" (")[0] for ln in lines[1]]
