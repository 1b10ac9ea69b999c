"""The Swin Transformer trunk with an FPN neck in plain float32 PyTorch: the
reference the port's Swin trunk is held against in the tests.

Written after Swin-Transformer-Object-Detection's
``mmdet/models/backbones/swin_transformer.py`` (``window_partition``,
``window_reverse``, ``WindowAttention`` with its
``relative_position_index``, ``SwinTransformerBlock`` with its padding to
the window and ``torch.roll``, ``BasicLayer`` with its ``img_mask`` of
-100, ``PatchMerging``, ``PatchEmbed``, the stage norms ``norm{i}``),
under its module names; :func:`port_key` maps them to the port's. It
imports neither the port nor JAX. Departures from Swin-OD:

- no drop path and no dropout (inference: both are the identity);
- no input std: SLN-Amodal molds images by subtracting the mean only, and
  the ImageNet std is folded into ``patch_embed.proj``'s weights (each
  input channel's weights divided by its std), the same function;
- the outputs of all four stages, each through its ``norm{i}``, feed an
  FPN neck as the port's (a lateral 1x1 conv per level, the nearest 2x
  top-down path, a 3x3 smooth conv, P6 a stride-2 subsample of P5), named
  as the port's neck (``P{l}_conv1``, ``P{l}_conv2.1``);
- NHWC image in, NHWC P2..P6 out.

Run it with TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``)
where it runs on a card.
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class SwinSize(NamedTuple):
    patch: int
    embed: int
    depths: Tuple[int, ...]
    heads: Tuple[int, ...]
    window: int
    mlp_ratio: int


SWIN_S = SwinSize(4, 96, (2, 2, 18, 2), (3, 6, 12, 24), 7, 4)


def window_partition(x, window_size):
    B, H, W, C = x.shape
    x = x.view(B, H // window_size, window_size, W // window_size, window_size, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)


def window_reverse(windows, window_size, H, W):
    B = int(windows.shape[0] / (H * W / window_size / window_size))
    x = windows.view(B, H // window_size, W // window_size, window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, H, W, -1)


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class WindowAttention(nn.Module):
    def __init__(self, dim, window_size, num_heads):
        super().__init__()
        self.dim = dim
        self.window_size = window_size            # (Wh, Ww)
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size[0] - 1) * (2 * window_size[1] - 1), num_heads))
        coords_h = torch.arange(self.window_size[0])
        coords_w = torch.arange(self.window_size[1])
        coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
        coords_flatten = torch.flatten(coords, 1)
        relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
        relative_coords = relative_coords.permute(1, 2, 0).contiguous()
        relative_coords[:, :, 0] += self.window_size[0] - 1
        relative_coords[:, :, 1] += self.window_size[1] - 1
        relative_coords[:, :, 0] *= 2 * self.window_size[1] - 1
        relative_position_index = relative_coords.sum(-1)
        # not persistent: the port computes it from coordinates
        self.register_buffer("relative_position_index", relative_position_index,
                             persistent=False)
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)
        self.softmax = nn.Softmax(dim=-1)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        qkv = self.qkv(x).reshape(B_, N, 3, self.num_heads, C // self.num_heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        relative_position_bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(
            self.window_size[0] * self.window_size[1],
            self.window_size[0] * self.window_size[1], -1)
        relative_position_bias = relative_position_bias.permute(2, 0, 1).contiguous()
        attn = attn + relative_position_bias.unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(B_ // nW, nW, self.num_heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, N, N)
        attn = self.softmax(attn)
        x = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(x)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size=7, shift_size=0, mlp_ratio=4.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size=(window_size, window_size),
                                    num_heads=num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.H = None
        self.W = None

    def attention(self, x, mask_matrix):
        """The block's attention branch on x [B, H*W, C] after ``norm1``:
        pad, roll, partition, attention, reverse, roll back, crop."""
        B, L, C = x.shape
        H, W = self.H, self.W
        x = x.view(B, H, W, C)
        pad_l = pad_t = 0
        pad_r = (self.window_size - W % self.window_size) % self.window_size
        pad_b = (self.window_size - H % self.window_size) % self.window_size
        x = F.pad(x, (0, 0, pad_l, pad_r, pad_t, pad_b))
        _, Hp, Wp, _ = x.shape
        if self.shift_size > 0:
            shifted_x = torch.roll(x, shifts=(-self.shift_size, -self.shift_size), dims=(1, 2))
            attn_mask = mask_matrix
        else:
            shifted_x = x
            attn_mask = None
        x_windows = window_partition(shifted_x, self.window_size)
        x_windows = x_windows.view(-1, self.window_size * self.window_size, C)
        attn_windows = self.attn(x_windows, mask=attn_mask)
        attn_windows = attn_windows.view(-1, self.window_size, self.window_size, C)
        shifted_x = window_reverse(attn_windows, self.window_size, Hp, Wp)
        if self.shift_size > 0:
            x = torch.roll(shifted_x, shifts=(self.shift_size, self.shift_size), dims=(1, 2))
        else:
            x = shifted_x
        if pad_r > 0 or pad_b > 0:
            x = x[:, :H, :W, :].contiguous()
        return x.view(B, H * W, C)

    def forward(self, x, mask_matrix):
        shortcut = x
        x = shortcut + self.attention(self.norm1(x), mask_matrix)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x, H, W):
        B, L, C = x.shape
        x = x.view(B, H, W, C)
        pad_input = (H % 2 == 1) or (W % 2 == 1)
        if pad_input:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x0 = x[:, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, :]
        x3 = x[:, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3], -1)
        x = x.view(B, -1, 4 * C)
        x = self.norm(x)
        return self.reduction(x)


def attention_mask(H, W, window_size, shift_size, device=None):
    """BasicLayer's ``attn_mask`` [nW, w*w, w*w] for the padded grid."""
    Hp = int(math.ceil(H / window_size)) * window_size
    Wp = int(math.ceil(W / window_size)) * window_size
    img_mask = torch.zeros((1, Hp, Wp, 1), device=device)
    h_slices = (slice(0, -window_size), slice(-window_size, -shift_size),
                slice(-shift_size, None))
    w_slices = (slice(0, -window_size), slice(-window_size, -shift_size),
                slice(-shift_size, None))
    cnt = 0
    for h in h_slices:
        for w in w_slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, window_size)
    mask_windows = mask_windows.view(-1, window_size * window_size)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
        attn_mask == 0, float(0.0))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size=7, mlp_ratio=4.0, downsample=None):
        super().__init__()
        self.window_size = window_size
        self.shift_size = window_size // 2
        self.depth = depth
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim=dim, num_heads=num_heads, window_size=window_size,
                                 shift_size=0 if (i % 2 == 0) else window_size // 2,
                                 mlp_ratio=mlp_ratio)
            for i in range(depth)])
        self.downsample = downsample(dim=dim) if downsample is not None else None

    def forward(self, x, H, W):
        attn_mask = attention_mask(H, W, self.window_size, self.shift_size, x.device)
        for blk in self.blocks:
            blk.H, blk.W = H, W
            x = blk(x, attn_mask)
        if self.downsample is not None:
            x_down = self.downsample(x, H, W)
            Wh, Ww = (H + 1) // 2, (W + 1) // 2
            return x, H, W, x_down, Wh, Ww
        return x, H, W, x, H, W


class PatchEmbed(nn.Module):
    def __init__(self, patch_size=4, in_chans=3, embed_dim=96):
        super().__init__()
        self.patch_size = (patch_size, patch_size)
        self.embed_dim = embed_dim
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x):
        _, _, H, W = x.size()
        if W % self.patch_size[1] != 0:
            x = F.pad(x, (0, self.patch_size[1] - W % self.patch_size[1]))
        if H % self.patch_size[0] != 0:
            x = F.pad(x, (0, 0, 0, self.patch_size[0] - H % self.patch_size[0]))
        x = self.proj(x)
        Wh, Ww = x.size(2), x.size(3)
        x = x.flatten(2).transpose(1, 2)
        x = self.norm(x)
        return x.transpose(1, 2).view(-1, self.embed_dim, Wh, Ww)


class SwinFPN(nn.Module):
    """Swin-OD's ``SwinTransformer`` (out_indices 0..3, patch_norm, no
    absolute position embedding) and the FPN neck; NHWC image [B, H, W, 3]
    in, NHWC P2..P6 out."""

    def __init__(self, size: SwinSize = SWIN_S, out_channels: int = 256):
        super().__init__()
        self.num_layers = len(size.depths)
        self.patch_embed = PatchEmbed(size.patch, 3, size.embed)
        self.layers = nn.ModuleList()
        for i_layer in range(self.num_layers):
            self.layers.append(BasicLayer(
                dim=int(size.embed * 2 ** i_layer), depth=size.depths[i_layer],
                num_heads=size.heads[i_layer], window_size=size.window,
                mlp_ratio=size.mlp_ratio,
                downsample=PatchMerging if (i_layer < self.num_layers - 1) else None))
        self.num_features = [int(size.embed * 2 ** i) for i in range(self.num_layers)]
        for i_layer in range(self.num_layers):
            self.add_module(f"norm{i_layer}", nn.LayerNorm(self.num_features[i_layer]))
        for lvl, cin in zip(range(2, 6), self.num_features):
            setattr(self, f"P{lvl}_conv1", nn.Conv2d(cin, out_channels, 1))
            setattr(self, f"P{lvl}_conv2", nn.Sequential(
                nn.Identity(), nn.Conv2d(out_channels, out_channels, 3, padding=1)))

    def trunk(self, x):
        """NCHW image -> the four stage outputs, NCHW (Swin-OD's forward)."""
        x = self.patch_embed(x)
        Wh, Ww = x.size(2), x.size(3)
        x = x.flatten(2).transpose(1, 2)
        outs = []
        for i in range(self.num_layers):
            layer = self.layers[i]
            x_out, H, W, x, Wh, Ww = layer(x, Wh, Ww)
            x_out = getattr(self, f"norm{i}")(x_out)
            outs.append(x_out.view(-1, H, W, self.num_features[i]).permute(0, 3, 1, 2))
        return outs

    def forward(self, x):
        c2, c3, c4, c5 = self.trunk(x.permute(0, 3, 1, 2))
        p5 = self.P5_conv1(c5)
        p4 = self.P4_conv1(c4) + F.interpolate(p5, scale_factor=2, mode="nearest")
        p3 = self.P3_conv1(c3) + F.interpolate(p4, scale_factor=2, mode="nearest")
        p2 = self.P2_conv1(c2) + F.interpolate(p3, scale_factor=2, mode="nearest")
        outs = [self.P2_conv2(p2), self.P3_conv2(p3), self.P4_conv2(p4), self.P5_conv2(p5)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return [p.permute(0, 2, 3, 1) for p in outs]


def port_key(key: str) -> str:
    """A Swin-OD state-dict key (with this file's neck) -> the port's key
    under ``fpn.``: ``patch_embed`` is ``C1``, ``layers.{i}`` and
    ``norm{i}`` are ``C{i+2}.blocks`` and ``C{i+2}.norm``, and
    ``layers.{i}.downsample`` is the merge that opens ``C{i+3}``."""
    key = re.sub(r"^patch_embed\.", "C1.", key)
    key = re.sub(r"^layers\.(\d+)\.downsample\.",
                 lambda m: f"C{int(m.group(1)) + 3}.merge.", key)
    key = re.sub(r"^layers\.(\d+)\.blocks\.", lambda m: f"C{int(m.group(1)) + 2}.blocks.", key)
    key = re.sub(r"^norm(\d+)\.", lambda m: f"C{int(m.group(1)) + 2}.norm.", key)
    return key
