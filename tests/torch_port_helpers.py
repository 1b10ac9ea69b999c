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
    shapes; RoIAlign levels that require a gradient, float32 and float64)."""
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
    roi = [((levels(2, 8, dtype, True), boxes_norm(2, 12, dtype), [5, 5], [128, 128], 0.0), {})
           for dtype in (torch.float32, torch.float64)]
    backward = [((torch.randn((2, 12, 5, 5, 8), generator=gen, dtype=dtype).to(device),
                  boxes_norm(2, 12, dtype), [32, 16, 8, 4], [32, 16, 8, 4], [5, 5], [128, 128],
                  dtype), {})
                for dtype in (torch.float32, torch.float64)]
    return {"nms_sorted_batched": nms, "roi_align": roi, "roi_align_backward": backward}


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
