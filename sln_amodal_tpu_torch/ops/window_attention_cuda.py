"""Shifted-window attention: the CUDA kernel's launch and the wrapper the
Swin trunk calls.

:func:`window_attention` calls the custom op ``sln_amodal::window_attention``
(``ops/library.py``): a CUDA tensor goes to :func:`launch_window_attention`,
the hand-written kernel ``csrc/window_attention.cu`` (one launch per Swin
block); a CPU tensor goes to the plain version
:func:`.window_attention.window_attention_plain`. There is no fallback
from one to the other.
"""

from __future__ import annotations

import torch

from ..cuda_build import FLOAT, INT, VOIDP, CudaKernel

WINDOW_ATTENTION_KERNEL = CudaKernel("window_attention.cu", {
    "window_attention": (VOIDP, VOIDP, VOIDP, INT, INT, INT, INT, INT, INT, INT, FLOAT,
                         INT, VOIDP),
})

# what the kernel is built for: Swin's window and head size
KERNEL_WINDOW = 7
KERNEL_HEAD_DIM = 32
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int, window: int,
                     shift: int) -> torch.Tensor:
    """qkv [B, Hp, Wp, 3 * heads * d] -> [B, Hp, Wp, heads * d]
    (``ops/window_attention.py`` defines what it computes)."""
    return torch.ops.sln_amodal.window_attention.default(qkv, table, int(heads), int(window),
                                                         int(shift))


def launch_window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                            window: int, shift: int) -> torch.Tensor:
    """The kernel on CUDA tensors (the op's CUDA implementation): checks,
    the output, one launch."""
    if qkv.device.type != "cuda" or table.device != qkv.device:
        raise ValueError(f"qkv and table must be on one CUDA device, got {qkv.device} "
                         f"and {table.device}")
    if qkv.dtype not in DTYPE_CODES:
        raise ValueError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 4:
        raise ValueError(f"qkv must be [B, Hp, Wp, 3 * heads * d], got {tuple(qkv.shape)}")
    b, hp, wp, c3 = qkv.shape
    if window != KERNEL_WINDOW or c3 != 3 * heads * KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel is built for window {KERNEL_WINDOW} and head size "
                         f"{KERNEL_HEAD_DIM}; got window {window}, {c3} channels, {heads} heads")
    if hp % window or wp % window or not 0 <= shift < window:
        raise ValueError(f"grid {hp}x{wp} must be whole windows of {window}, "
                         f"0 <= shift < window (shift {shift})")
    if tuple(table.shape) != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"table must be [{(2 * window - 1) ** 2}, {heads}], "
                         f"got {tuple(table.shape)}")
    qkv = qkv.contiguous()
    table = table.to(torch.float32).contiguous()
    out = torch.empty((b, hp, wp, heads * KERNEL_HEAD_DIM), dtype=qkv.dtype, device=qkv.device)
    # the kernel moves tokens as 16-byte vectors
    if qkv.data_ptr() % 16:
        qkv = qkv.clone()
    if b * hp * wp == 0:
        return out
    WINDOW_ATTENTION_KERNEL.launch(
        "window_attention", qkv.device, qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
        b, hp, wp, heads, KERNEL_HEAD_DIM, window, shift, float(KERNEL_HEAD_DIM ** -0.5),
        DTYPE_CODES[qkv.dtype])
    WINDOW_ATTENTION_KERNEL.launches += 1
    return out
