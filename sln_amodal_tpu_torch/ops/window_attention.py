"""Shifted-window multi-head self-attention (Swin): the plain PyTorch version.

The op ``sln_amodal::window_attention`` takes a block's qkv on the padded
token grid, ``qkv [B, Hp, Wp, 3 * heads * d]`` in Swin's (3, heads, d)
channel order with Hp and Wp multiples of the window, the relative-position
bias table ``[(2 * window - 1) ** 2, heads]``, ``heads``, ``window`` and
``shift``, and returns ``[B, Hp, Wp, heads * d]``, each token at its own
grid position. For each batch row, window of the rolled grid and head:

- rolled token (y', x') is source token ((y' + s) mod Hp, (x' + s) mod Wp);
- S_ij = (q_i * d^-1/2) . k_j + table[(yi - yj + w - 1) * (2w - 1) + (xi - xj + w - 1), h]
  + M_ij, with window coordinates (yi, xi), and M_ij = -100 where s > 0 and
  the shift regions of i and j differ (region = 3 * band_y + band_x, the
  bands [0, Hp - w), [Hp - w, Hp - s), [Hp - s, Hp) of the rolled grid in
  each axis), else 0;
- O = softmax(S) V, written back at the source positions.

This is that computation written literally, as Swin's own code does it
(roll, partition, gathered bias, mask, softmax, reverse, roll back), in
float32 (float64 for float64 inputs) with the output rounded once to the
input's dtype. It is the version the CUDA kernel
(``csrc/window_attention.cu``) is held against, and the op's CPU
implementation.
"""

from __future__ import annotations

import torch


def relative_position_index(window: int, device=None) -> torch.Tensor:
    """[w*w, w*w] index into the bias table, Swin's ``relative_position_index``."""
    coords = torch.stack(torch.meshgrid(torch.arange(window, device=device),
                                        torch.arange(window, device=device), indexing="ij"))
    coords = coords.flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def shift_mask(hp: int, wp: int, window: int, shift: int, device=None) -> torch.Tensor:
    """[nW, w*w, w*w] float32: -100 between tokens of a window that the
    cyclic shift brought from different regions, else 0 (Swin's
    ``attn_mask``)."""
    img = torch.zeros((hp, wp), device=device)
    bands = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    region = 0
    for hs in bands:
        for ws in bands:
            img[hs, ws] = region
            region += 1
    windows = partition(img[None, :, :, None], window).reshape(-1, window * window)
    diff = windows[:, None, :] - windows[:, :, None]
    return torch.zeros_like(diff).masked_fill(diff != 0, -100.0)


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, w, w, C], windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)


def reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`partition`."""
    b = windows.shape[0] // ((h // window) * (w // window))
    x = windows.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                           window: int, shift: int) -> torch.Tensor:
    """See the module docstring."""
    b, hp, wp, c3 = qkv.shape
    d = c3 // (3 * heads)
    n = window * window
    acc = torch.float64 if qkv.dtype == torch.float64 else torch.float32
    x = qkv.to(acc)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    x = partition(x, window).reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = x[0] * d ** -0.5, x[1], x[2]
    scores = q @ k.transpose(-2, -1)                                  # [B*nW, heads, n, n]
    index = relative_position_index(window, qkv.device)
    bias = table.to(acc)[index.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)
    scores = scores + bias[None]
    if shift:
        mask = shift_mask(hp, wp, window, shift, qkv.device).to(acc)
        nw = mask.shape[0]
        scores = (scores.reshape(b, nw, heads, n, n) + mask[None, :, None]).reshape(-1, heads, n, n)
    out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(-1, window, window, heads * d)
    out = reverse(out, window, hp, wp)
    if shift:
        out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
    return out.to(qkv.dtype)
