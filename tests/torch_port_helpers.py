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
