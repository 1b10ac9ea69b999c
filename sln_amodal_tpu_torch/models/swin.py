"""The Swin Transformer trunk (Liu et al., arXiv:2103.14030) on the shared
FPN neck, as Swin-Transformer-Object-Detection's Mask R-CNN builds it.

NHWC images [B, H, W, 3] -> NHWC (P2, P3, P4, P5, P6). The graph:

- ``C1``, the patch embedding: a 4 x 4 conv at stride 4 from 3 channels to
  ``embed`` (the image padded right and below to a multiple of 4), then a
  LayerNorm;
- ``C2..C5``, the four stages. Stage k > 2 opens with the patch merging
  (``merge``: the four 2x2 neighbours concatenated as
  ``x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]``, the grid
  padded below and right to even sizes, a LayerNorm over the 4C channels,
  then a linear 4C -> 2C without bias), then ``blocks``; every block is

      x = x + proj(W-MSA(qkv(pad(norm1(x)))))[:H, :W]
      x = x + fc2(gelu(fc1(norm2(x))))

  with the window attention of ``ops/window_attention.py`` over a grid
  padded with zeros below and right to a multiple of the window (7), shifted
  by 3 on odd blocks, and an MLP 4 times as wide; ``norm`` is the LayerNorm of the stage's
  output, which feeds the neck (the next stage takes the output before it).

Module names are this package's: the levels read as ResNet's do (``fpn.C1``
the stem, ``fpn.C{k}`` the stage of output stride 2^k with the merge that
opens it), so the trainer's stage prefixes keep their meaning. Compute is
in the input's dtype; LayerNorm statistics and the attention's softmax are
float32. Training the trunk is not supported (the op has no backward and
there is no drop path); :class:`.train.optim.StagedSGD` refuses a stage
that trains it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.window_attention_cuda import KERNEL_WINDOW as WINDOW
from ..ops.window_attention_cuda import window_attention
from .common import Conv2d, FPNNeck, LayerNorm, Linear, nchw, nhwc

LAYER_NORM_EPS = 1e-5
# what every Swin variant shares: the patch, the MLP's width ratio, the
# window (``WINDOW``) and the head size (32), the last two what the
# window-attention kernel is built for
PATCH = 4
MLP_RATIO = 4


class SwinSize(NamedTuple):
    """What differs between Swin variants."""
    embed: int
    depths: Tuple[int, ...]
    heads: Tuple[int, ...]


SWIN_SIZES = {
    # Swin-S: Swin-Transformer-Object-Detection's
    # mask_rcnn_swin_small_patch4_window7_mstrain_480-800_adamw_3x_coco.py
    "swin_s": SwinSize(embed=96, depths=(2, 2, 18, 2), heads=(3, 6, 12, 24)),
}


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, PATCH, stride=PATCH)
        self.norm = LayerNorm(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x)
        ph, pw = -x.shape[2] % PATCH, -x.shape[3] % PATCH
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph))
        return self.norm(nhwc(self.proj(x)))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LAYER_NORM_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 2 or x.shape[2] % 2:
            x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class WindowAttention(nn.Module):
    """qkv, the shifted-window attention op, proj; on a padded grid."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 2, heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        out = window_attention(self.qkv(x), self.relative_position_bias_table,
                               self.heads, WINDOW, shift)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, shift: int):
        super().__init__()
        self.shift = shift
        self.norm1 = LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp = Mlp(dim, MLP_RATIO * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        y = self.norm1(x)
        ph, pw = -h % WINDOW, -w % WINDOW
        if ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        y = self.attn(y, self.shift)
        if ph or pw:
            y = y[:, :h, :w]
        x = x + y
        return x + self.mlp(self.norm2(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, merge: bool):
        super().__init__()
        self.merge = PatchMerging(dim // 2) if merge else None
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, 0 if i % 2 == 0 else WINDOW // 2)
                                    for i in range(depth))
        self.norm = LayerNorm(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the tokens the next stage takes, the normalized output)."""
        if self.merge is not None:
            x = self.merge(x)
        for block in self.blocks:
            x = block(x)
        return x, self.norm(x)


class SwinFPN(FPNNeck):
    """Swin trunk + FPN neck; ``size`` is an entry of :data:`SWIN_SIZES`."""

    # what training its weights would need, for the trainer's refusal
    training_lacks = "the window-attention op's backward and drop path"

    def __init__(self, size: SwinSize, out_channels: int = 256):
        super().__init__()
        dims = [size.embed * 2 ** k for k in range(4)]
        self.C1 = PatchEmbed(size.embed)
        for k, (dim, depth, heads) in enumerate(zip(dims, size.depths, size.heads)):
            setattr(self, f"C{k + 2}", SwinStage(dim, depth, heads, merge=k > 0))
        self.add_neck(dims, out_channels)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = self.C1(x)
        outs = []
        for k in range(2, 6):
            y, out = getattr(self, f"C{k}")(y)
            outs.append(nchw(out))
        return self.neck(*outs)
