"""Shared pieces of the PyTorch port's tests (``test_torch_*.py``)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m cuda "
                    "tests/test_torch_*.py` on the card")
    return torch.device("cuda")


def random_variables(shapes, seed=0, dtype=np.float64):
    """A flax variables tree of the given ``jax.eval_shape`` structure with
    seeded numpy values: weights N(0, 1/fan_in) (so activations stay O(1)
    through the deep trunks), biases N(0, 0.02^2), frozen BN statistics near
    the identity."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "var":
            return (rng.rand(*leaf.shape) * 0.5 + 0.75).astype(dtype)
        if name == "scale":
            return (1.0 + rng.randn(*leaf.shape) * 0.05).astype(dtype)
        if name == "mean":
            return (rng.randn(*leaf.shape) * 0.05).astype(dtype)
        if len(leaf.shape) >= 2:           # HWIO conv or [in, out] dense kernel
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(dtype)
        return (rng.randn(*leaf.shape) * 0.02).astype(dtype)

    import jax

    return jax.tree_util.tree_map_with_path(draw, shapes)


def library_op_samples(device, seed=0):
    """{op name: [(args, kwargs), ...]}: inputs of each custom op of
    ``ops/library.py`` on ``device`` for ``torch.library.opcheck`` (small
    shapes; RoIAlign levels that require a gradient, float32, float64 and
    bfloat16; window attention on shifted and unshifted grids, float32 and
    bfloat16: the dtypes its CUDA kernel takes; the squash resize on frames
    packed on ``device`` with their table on the host, up and down)."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)

    def boxes_px(b, n):
        y, x = rng.uniform(0, 200, (2, b, n))
        h, w = rng.uniform(4, 60, (2, b, n))
        return torch.from_numpy(np.stack([y, x, y + h, x + w], -1).astype(np.float32))

    def boxes_norm(b, n, dtype):
        y, x = rng.uniform(-0.05, 0.9, (2, b, n))
        h, w = rng.uniform(0.02, 0.5, (2, b, n))
        return torch.from_numpy(np.stack([y, x, y + h, x + w], -1)).to(device, dtype)

    def levels(b, c, dtype, grad):
        return [torch.randn((b, s, s, c), generator=gen, dtype=dtype).to(device)
                .requires_grad_(grad) for s in (32, 16, 8, 4)]

    nms = [((boxes_px(2, 300).to(device), torch.from_numpy(rng.rand(2, 300) > 0.1).to(device),
             50, 0.5, False, -1), {}),
           ((boxes_px(1, 70).double().to(device), torch.ones((1, 70), dtype=torch.bool,
                                                             device=device),
             80, 0.3, True, -1), {})]
    def roi_case(dtype, box_dtype):
        return ((levels(2, 8, dtype, True), boxes_norm(2, 12, box_dtype), [5, 5], [128, 128],
                 0.0), {})

    def backward_case(dtype, box_dtype):
        return ((torch.randn((2, 12, 5, 5, 8), generator=gen, dtype=dtype).to(device),
                 boxes_norm(2, 12, box_dtype), [32, 16, 8, 4], [32, 16, 8, 4], [5, 5],
                 [128, 128], dtype), {})

    roi = [roi_case(dtype, dtype) for dtype in (torch.float32, torch.float64)]
    backward = [backward_case(dtype, dtype) for dtype in (torch.float32, torch.float64)]
    # bfloat16 levels with float32 boxes (the model's)
    roi.append(roi_case(torch.bfloat16, torch.float32))
    backward.append(backward_case(torch.bfloat16, torch.float32))

    def attention_case(dtype, b, hp, wp, heads, shift):
        qkv = torch.randn((b, hp, wp, 3 * heads * 32), generator=gen).to(device, dtype)
        table = torch.randn((169, heads), generator=gen).to(device)
        return ((qkv, table, heads, 7, shift), {})

    attention = [attention_case(torch.float32, 1, 14, 7, 2, 3),
                 attention_case(torch.bfloat16, 2, 7, 14, 1, 0)]
    def resize_case(sizes, size):
        frames = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in sizes]
        nbytes = np.array([f.size for f in frames])
        table = np.stack([np.cumsum(nbytes) - nbytes, [h for h, _ in sizes],
                          [w for _, w in sizes]], 1)
        packed = np.concatenate([f.reshape(-1) for f in frames])
        return ((torch.from_numpy(packed).to(device), torch.from_numpy(table.astype(np.int64)),
                 size), {})

    resize = [resize_case([(12, 20), (30, 9)], 16), resize_case([(16, 16)], 16)]
    return {"nms_sorted_batched": nms, "roi_align": roi, "roi_align_backward": backward,
            "window_attention": attention, "resize_bilinear_u8": resize}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One ATen/OpenMP thread for the importing module's tests, restored
    after them: their small CPU graphs gain little from threads, and under
    the parallel test run eight spinning OpenMP threads per worker slow
    every worker's small ops down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shared():
    """(JAX variables, the port's state_dict of the same weights, batch) of
    the training slice (``test_torch_train_slice.py``): its reduced float64
    configuration, its seeded RPN-biased weights and ``make_batch``'s batch
    of two."""
    from sln_amodal_tpu_torch.config import Config
    from sln_amodal_tpu_torch.profile_train import make_batch
    from test_torch_train_slice import CFG, shared_weights

    return (*shared_weights(), make_batch(Config(**CFG), 2, 0))


class Batches:
    """A loader that yields ``batches`` in turn, forever."""

    def __init__(self, *batches):
        self.batches = batches

    def __iter__(self):
        while True:
            yield from self.batches


def momentum(opt):
    """A ``StagedSGD``'s momentum buffers (None before its first update)."""
    return [opt.sgd.state[p].get("momentum_buffer") for p in opt.params]


def assert_same_state(trainer, model, opt):
    """The trainer's parameters, momentum and accumulator equal those of
    the plain run (``model``, ``opt``) bit for bit."""
    got, want = dict(trainer.model.named_parameters()), dict(model.named_parameters())
    for k in want:
        assert torch.equal(got[k].detach(), want[k].detach()), k
    for a, b in zip(momentum(trainer.optimizer), momentum(opt)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert trainer.optimizer.mini_step == opt.mini_step
    if opt.accumulated is not None:
        assert all(torch.equal(a, b) for a, b in
                   zip(trainer.optimizer.accumulated, opt.accumulated))


def lockstep(cfg, sd, batches, draws, stage, lr, device="cpu", accumulate_steps=1,
             on_step=None):
    """``Trainer.train_stage`` on ``device`` from ``sd``, one step per epoch
    over ``batches`` in turn with each step's ``draws`` (the target layer's
    uniforms), and after every step the plain ``train_step`` on a second
    model from ``sd`` with the same batch and draws: losses, parameters,
    momentum and accumulator bit-equal. ``on_step(epoch, trainer, losses)``
    runs after each step's check. Returns (the trainer, the last step's
    captured step: ``trainer.step_program`` during the stage)."""
    from sln_amodal_tpu_torch.models.sln import SLNAmodal
    from sln_amodal_tpu_torch.train import trainer as trainer_mod
    from sln_amodal_tpu_torch.train.optim import StagedSGD

    model = SLNAmodal(cfg, device=device)
    model.load_state_dict(sd)
    opt = StagedSGD(model, stage, lr, accumulate_steps=accumulate_steps)
    trainer = trainer_mod.Trainer(cfg, sd, device=device)
    seen = {"steps": 0}
    run_step = trainer.run_step

    def recorded(batch, uniforms):
        seen["program"] = trainer.step_program
        seen["losses"] = run_step(batch, uniforms)
        return seen["losses"]

    def end(epoch):
        i = epoch - 1
        want = trainer_mod.train_step(
            model, opt, trainer_mod.to_device(batches[i % len(batches)], device),
            uniforms=draws[i])
        assert set(seen["losses"]) == set(want)
        for k in want:
            assert torch.equal(seen["losses"][k], want[k]), (epoch, k)
        assert_same_state(trainer, model, opt)
        seen["steps"] += 1
        if on_step is not None:
            on_step(epoch, trainer, seen["losses"])

    trainer.run_step = recorded
    with pytest.MonkeyPatch.context() as mp:
        it = iter(draws)
        mp.setattr(trainer_mod, "step_uniforms", lambda generator, b, rois: next(it))
        trainer.train_stage(Batches(*batches), stage, lr, epochs=len(draws),
                            steps_per_epoch=1, on_epoch_end=end,
                            accumulate_steps=accumulate_steps)
    assert seen["steps"] == len(draws)
    return trainer, seen["program"]
