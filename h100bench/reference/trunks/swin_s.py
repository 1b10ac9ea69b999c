"""Swin-S (Liu et al., arXiv:2103.14030) as Swin-Transformer-Object-Detection's
Mask R-CNN builds it (``mask_rcnn_swin_small_patch4_window7_mstrain_480-800_adamw_3x_coco.py``):
patch 4, embed 96, depths (2, 2, 18, 2), heads (3, 6, 12, 24), window 7
with a shift of 3 on every odd block, MLP ratio 4 with exact GELU, qkv
bias, LayerNorm eps 1e-5, patch merging between stages, a LayerNorm on each
stage output, on the FPN neck with in-channels (96, 192, 384, 768).

The forward is Swin-OD's, written literally (``window_partition``,
``torch.roll``, the ``img_mask`` of -100, ``relative_position_index``,
``window_reverse``, padding to the window), under the program's module
names, which the state_dict both share: ``C1`` the patch embedding,
``C{k}`` the stage of output stride 2^k with the merge that opens it
(``C{k}.merge``), its ``blocks`` and its output ``norm``. Every linear,
convolution, QK^T and PV product takes its operands through
``lowp.quantize``, so the float8 control covers attention. Departures from
Swin-OD: no drop path (inference), and no input std: the images are molded
by the mean alone and the std is folded into ``C1.proj``'s weights (the
seeded weights stand for weights so folded).

Besides the trunk file's interface (``trunks/__init__.py``) it counts the
window-attention kernel's bytes and operations per image
(:func:`window_attention_bound_s`), the bound of ``window_attn_roofline``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from h100bench.flops import HBM_BYTES_PER_S, PEAK_BF16_FLOPS, Layer, conv_flops
from h100bench.reference import lowp
from h100bench.reference.model import Conv2d, Linear, nchw
from h100bench.reference.trunks._fpn import FPN, PART, neck_layers

PATCH, EMBED, WINDOW, SHIFT, MLP_RATIO = 4, 96, 7, 3, 4
DEPTHS = (2, 2, 18, 2)
HEADS = (3, 6, 12, 24)
HEAD_DIM = 32
EPS = 1e-5
BIAS_TABLE_STD = 0.02
KERNEL = "swin_window_attention_kernel"     # the program's kernel, as the profiler names it


def window_partition(x, window_size):
    B, H, W, C = x.shape
    x = x.view(B, H // window_size, window_size, W // window_size, window_size, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)


def window_reverse(windows, window_size, H, W):
    B = int(windows.shape[0] / (H * W / window_size / window_size))
    x = windows.view(B, H // window_size, W // window_size, window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, H, W, -1)


def attention_mask(Hp, Wp, window_size, shift_size, device):
    """Swin-OD's ``attn_mask`` [nW, w*w, w*w] of a padded grid."""
    img_mask = torch.zeros((1, Hp, Wp, 1), device=device)
    slices = (slice(0, -window_size), slice(-window_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, window_size).view(-1, window_size * window_size)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 2, heads))
        coords = torch.stack(torch.meshgrid([torch.arange(WINDOW), torch.arange(WINDOW)],
                                            indexing="ij")).flatten(1)
        rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
        rel[:, :, 0] += WINDOW - 1
        rel[:, :, 1] += WINDOW - 1
        rel[:, :, 0] *= 2 * WINDOW - 1
        self.register_buffer("relative_position_index", rel.sum(-1), persistent=False)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        qkv = self.qkv(x).reshape(B_, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = lowp.quantize(q) @ lowp.quantize(k).transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        attn = attn + bias.view(N, N, -1).permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(B_ // nW, nW, self.heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, N, N)
        attn = torch.softmax(attn, dim=-1)
        x = (lowp.quantize(attn) @ lowp.quantize(v)).transpose(1, 2).reshape(B_, N, C)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, shift):
        super().__init__()
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, MLP_RATIO * dim)

    def forward(self, x, H, W, mask):
        """x [B, H*W, C]."""
        B, L, C = x.shape
        shortcut = x
        x = self.norm1(x).view(B, H, W, C)
        pad_r = (WINDOW - W % WINDOW) % WINDOW
        pad_b = (WINDOW - H % WINDOW) % WINDOW
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        _, Hp, Wp, _ = x.shape
        if self.shift > 0:
            shifted_x = torch.roll(x, shifts=(-self.shift, -self.shift), dims=(1, 2))
        else:
            shifted_x, mask = x, None
        x_windows = window_partition(shifted_x, WINDOW).view(-1, WINDOW * WINDOW, C)
        attn_windows = self.attn(x_windows, mask=mask).view(-1, WINDOW, WINDOW, C)
        shifted_x = window_reverse(attn_windows, WINDOW, Hp, Wp)
        if self.shift > 0:
            x = torch.roll(shifted_x, shifts=(self.shift, self.shift), dims=(1, 2))
        else:
            x = shifted_x
        x = x[:, :H, :W, :].contiguous().view(B, H * W, C)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H, W):
        B, L, C = x.shape
        x = x.view(B, H, W, C)
        if H % 2 == 1 or W % 2 == 1:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :], x[:, 0::2, 1::2, :],
                       x[:, 1::2, 1::2, :]], -1)
        return self.reduction(self.norm(x.view(B, -1, 4 * C)))


class PatchEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = Conv2d(3, EMBED, PATCH, stride=PATCH)
        self.norm = nn.LayerNorm(EMBED, eps=EPS)

    def forward(self, x):
        _, _, H, W = x.size()
        if W % PATCH != 0:
            x = F.pad(x, (0, PATCH - W % PATCH))
        if H % PATCH != 0:
            x = F.pad(x, (0, 0, 0, PATCH - H % PATCH))
        x = self.proj(x)
        Wh, Ww = x.size(2), x.size(3)
        return self.norm(x.flatten(2).transpose(1, 2)), Wh, Ww


class Stage(nn.Module):
    """Swin-OD's ``BasicLayer``, with the merge that opens the stage."""

    def __init__(self, dim, depth, heads, merge):
        super().__init__()
        self.merge = PatchMerging(dim // 2) if merge else None
        self.blocks = nn.ModuleList(Block(dim, heads, 0 if i % 2 == 0 else SHIFT)
                                    for i in range(depth))
        self.norm = nn.LayerNorm(dim, eps=EPS)

    def forward(self, x, H, W):
        if self.merge is not None:
            x = self.merge(x, H, W)
            H, W = (H + 1) // 2, (W + 1) // 2
        Hp, Wp = math.ceil(H / WINDOW) * WINDOW, math.ceil(W / WINDOW) * WINDOW
        mask = attention_mask(Hp, Wp, WINDOW, SHIFT, x.device)
        for blk in self.blocks:
            x = blk(x, H, W, mask)
        return x, H, W


class SwinFPN(FPN):
    def __init__(self, out):
        super().__init__()
        self.C1 = PatchEmbed()
        for k in range(4):
            setattr(self, f"C{k + 2}", Stage(EMBED * 2 ** k, DEPTHS[k], HEADS[k], k > 0))
        self.add_neck([EMBED * 2 ** k for k in range(4)], out)

    def forward(self, x):
        x, H, W = self.C1(nchw(x))
        outs = []
        for k in range(2, 6):
            stage = getattr(self, f"C{k}")
            x, H, W = stage(x, H, W)
            outs.append(stage.norm(x).view(-1, H, W, x.shape[-1]).permute(0, 3, 1, 2))
        return self.neck(*outs)


def network(cfg):
    return SwinFPN(cfg["fpn_channels"])


def grids(image_size: int) -> List[Tuple[int, int, int, int]]:
    """(grid side, padded side, channels, blocks) of each stage."""
    n = math.ceil(image_size / PATCH)
    out = []
    for k in range(4):
        if k:
            n = math.ceil(n / 2)
        out.append((n, math.ceil(n / WINDOW) * WINDOW, EMBED * 2 ** k, DEPTHS[k]))
    return out


def flop_layers(cfg: Dict, trained_levels=()):
    """Patch embedding; per block qkv and proj on the padded grid, QK^T and
    AV over each padded token's 49 keys, fc1 and fc2 on the grid; the
    merges; the neck."""
    n0 = math.ceil(cfg["image_size"] / PATCH)
    layers = [Layer(conv_flops(n0, n0, 3, EMBED, PATCH), PART)]
    sizes, grad = [], False
    for k, (n, p, c, depth) in enumerate(grids(cfg["image_size"]), start=2):
        train = k in trained_levels
        stage = []
        if k > 2:
            stage.append(2.0 * n * n * (2 * c) * c)                     # merge 4(c/2) -> c
        for _ in range(depth):
            stage += [2.0 * p * p * c * 3 * c, 2.0 * p * p * WINDOW ** 2 * c,
                      2.0 * p * p * WINDOW ** 2 * c, 2.0 * p * p * c * c,
                      2.0 * n * n * c * MLP_RATIO * c, 2.0 * n * n * MLP_RATIO * c * c]
        layers += [Layer(f, PART, train, grad or (train and i > 0)) for i, f in enumerate(stage)]
        grad = grad or train
        sizes.append((n, c, grad))
    neck, levels = neck_layers(sizes, cfg["fpn_channels"], bool(trained_levels))
    return layers + neck, levels


def trained_pattern(levels) -> str:
    """Stage ``C{k}`` with the merge that opens it: levels 4 and 5 are Swin's
    stages 3 and 4."""
    return "|".join(rf"C{k}\." for k in levels)


def start(fpn, sd, gen) -> None:
    """LayerNorm weights one (biases stay zero), relative-position bias
    tables normal with std 0.02 (Swin's init), drawn from ``gen`` in module
    order."""
    for name, mod in fpn.named_modules():
        if isinstance(mod, nn.LayerNorm):
            sd[f"{name}.weight"].fill_(1.0)
        elif isinstance(mod, WindowAttention):
            key = f"{name}.relative_position_bias_table"
            sd[key] = torch.randn(sd[key].shape, generator=gen, device=sd[key].device,
                                  dtype=sd[key].dtype) * BIAS_TABLE_STD


def branches(fpn):
    """Each block's attention projection and second MLP layer."""
    return [k for k in fpn.state_dict()
            if k.endswith(".attn.proj.weight") or k.endswith(".mlp.fc2.weight")]


def calibrated(fpn):
    return []


def blocks() -> int:
    """Window-attention launches per image: one per block."""
    return sum(DEPTHS)


def window_attention_bound_s(cfg: Dict) -> Tuple[float, str]:
    """The least time of one image's window attention (seconds, all blocks)
    and what bounds it: each block's qkv [Hp, Wp, 3C] read once and its
    output [Hp, Wp, C] written once in the compute dtype, the bias table
    once (float32); QK^T and PV (2 x 2 x 49 x C operations a padded token)
    at the dense bfloat16 peak."""
    elem = 4 if cfg["compute_dtype"] == "float32" else 2
    nbytes = flops = 0.0
    for _, p, c, depth in grids(cfg["image_size"]):
        heads = c // HEAD_DIM
        nbytes += depth * (p * p * 4 * c * elem + (2 * WINDOW - 1) ** 2 * heads * 4)
        flops += depth * 4.0 * p * p * WINDOW ** 2 * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
