"""RPN, classifier, layer-mask and refine heads, with the reference's state_dict names.

Semantics of the JAX package's ``models/heads.py``:

- RPN anchors ordered (h, w, anchor) with per-anchor (bg, fg) channel pairs;
- classifier: pooled 7x7 -> conv(k=7, VALID) 1024 -> conv1x1 1024 ->
  linear class / linear bbox (class-specific deltas);
- mask head: the GLM prior concatenated **in front of** the FPN crop
  (439 input channels by default), 4 x (3x3 conv + BN + relu), a 2x2
  stride-2 transposed conv, a 1x1 conv to ``num_classes`` logit maps;
- refine head (the dormant ``amodal_refine`` seam of training): the mask
  head's conv stack over a small fused input.

Each head computes in its input's dtype (the model's compute dtype; the
mask head casts the GLM-prior crop to the FPN crop's). Probabilities,
classifier outputs and mask and refine logits are float32 whatever the
compute dtype, as in the reference; the RPN's logits and deltas stay in the
compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (Conv2d, ConvTranspose2d, FrozenBatchNorm2d, Linear, nchw, nhwc,
                     pad_same)


class RPNHead(nn.Module):
    """Shared RPN head over one NHWC pyramid level [B, H, W, C].

    Returns (class_logits [B, HWA, 2], probs [B, HWA, 2] f32,
    deltas [B, HWA, 4])."""

    def __init__(self, in_channels: int = 256, anchors_per_location: int = 3,
                 anchor_stride: int = 1):
        super().__init__()
        self.anchor_stride = anchor_stride
        self.conv_shared = Conv2d(in_channels, 512, 3, stride=anchor_stride)
        self.conv_class = Conv2d(512, 2 * anchors_per_location, 1)
        self.conv_bbox = Conv2d(512, 4 * anchors_per_location, 1)

    def forward(self, x: torch.Tensor):
        b = x.shape[0]
        shared = F.relu(self.conv_shared(pad_same(nchw(x), 3, self.anchor_stride)))
        logits = nhwc(self.conv_class(shared)).reshape(b, -1, 2)
        deltas = nhwc(self.conv_bbox(shared)).reshape(b, -1, 4)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        return logits, probs, deltas


class ClassifierHead(nn.Module):
    """Box classifier + regressor over pooled NHWC crops [N, p, p, C].

    Returns (class_logits [N, num_classes] f32, probs f32,
    deltas [N, num_classes, 4] f32)."""

    def __init__(self, num_classes: int, pool_size: int = 7, in_channels: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.conv1 = Conv2d(in_channels, 1024, pool_size)
        self.bn1 = FrozenBatchNorm2d(1024)
        self.conv2 = Conv2d(1024, 1024, 1)
        self.bn2 = FrozenBatchNorm2d(1024)
        self.linear_class = Linear(1024, num_classes)
        self.linear_bbox = Linear(1024, num_classes * 4)

    def forward(self, x: torch.Tensor):
        n = x.shape[0]
        if x.dtype == torch.bfloat16:
            # the pool_size conv over a pool_size crop as one matmul (the JAX
            # package's FullKernelConv; cuDNN's bfloat16 weight gradient for
            # this shape falls back to a slow kernel, PERF.md §6):
            # NHWC flattened as (kh, kw, cin)
            w = self.conv1.weight.to(x.dtype).permute(0, 2, 3, 1).reshape(1024, -1)
            y = F.linear(x.reshape(n, -1), w, self.conv1.bias.to(x.dtype))[:, :, None, None]
        else:
            y = self.conv1(nchw(x))
        y = F.relu(self.bn1(y))
        y = F.relu(self.bn2(self.conv2(y)))
        y = y.reshape(n, 1024)
        logits = self.linear_class(y).to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        deltas = self.linear_bbox(y).reshape(n, self.num_classes, 4).to(torch.float32)
        return logits, probs, deltas


class _MaskConvStack(nn.Module):
    """4 x (3x3 conv + frozen BN + relu) -> 2x2 stride-2 transposed conv +
    relu -> 1x1 conv: the mask head's layers, shared by the refine head."""

    def __init__(self, num_classes: int, in_channels: int):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"conv{i}", Conv2d(in_channels if i == 1 else 256, 256, 3, padding=1))
            setattr(self, f"bn{i}", FrozenBatchNorm2d(256))
        self.deconv = ConvTranspose2d(256, 256, 2, stride=2)
        self.conv5 = Conv2d(256, num_classes, 1)

    def stack(self, x: torch.Tensor):
        """NHWC x -> (float32 NHWC logits [N, 2p, 2p, num_classes], NHWC
        features [N, p, p, 256] before the transposed conv)."""
        x = nchw(x)
        for i in range(1, 5):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        feat = x
        x = F.relu(self.deconv(x))
        x = self.conv5(x)
        return nhwc(x).to(torch.float32), nhwc(feat)


class MaskHead(_MaskConvStack):
    """Layer-mask head: [GLM prior | FPN crop] -> num_classes logit maps.

    Input: fpn_crop [N, p, p, C], glm_crop [N, p, p, 183] (NHWC).
    Output: (logits [N, 2p, 2p, num_classes] f32, features [N, p, p, 256])."""

    def __init__(self, num_classes: int, in_channels: int = 439):
        super().__init__(num_classes, in_channels)

    def forward(self, fpn_crop: torch.Tensor, glm_crop: torch.Tensor):
        return self.stack(torch.cat([glm_crop.to(fpn_crop.dtype), fpn_crop], dim=-1))


class RefineHead(_MaskConvStack):
    """The optional mask-refinement head (``Config.use_refine_head``, off by
    default; the reference's dormant ``Refine``): the mask head's layers
    over a fused NHWC input [N, p, p, in_channels]. Returns float32 logits
    [N, 2p, 2p, num_classes]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stack(x)[0]
