"""The lower-precision control of the reference.

The configurations state bfloat16 compute; the control computes each
convolution's and matrix product's operands in the next precision below,
float8 (e4m3, one scale per tensor, as an fp8 path would), in training the
gradients that reach them too, and everything else as the reference does.
:func:`quantize` is the identity unless :func:`precision` switched the
control on.
"""

from __future__ import annotations

import contextlib

import torch

_MODE = {"fp8": False}
E4M3_MAX = 448.0


def _round(t):
    amax = t.detach().abs().amax().to(torch.float32).clamp_min(1e-30)
    scale = amax / E4M3_MAX
    return ((t.to(torch.float32) / scale).to(torch.float8_e4m3fn).to(torch.float32)
            * scale).to(t.dtype)


class _Float8(torch.autograd.Function):
    """Rounds a product's operand through float8, and in the backward the
    gradient that reaches it, each with a scale of its own."""

    @staticmethod
    def forward(ctx, t):
        return _round(t)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad)


def quantize(t):
    """``t`` rounded through float8 e4m3 with a per-tensor scale (its
    gradient too), back in its dtype, while the control is on; ``t``
    itself otherwise."""
    if t is None or not _MODE["fp8"]:
        return t
    return _Float8.apply(t)


@contextlib.contextmanager
def precision(name: str):
    """Run the reference's products in ``name`` ("fp8" or "fp32")."""
    if name not in ("fp8", "fp32"):
        raise ValueError(f"unknown precision {name!r}")
    before = _MODE["fp8"]
    _MODE["fp8"] = name == "fp8"
    try:
        yield
    finally:
        _MODE["fp8"] = before
