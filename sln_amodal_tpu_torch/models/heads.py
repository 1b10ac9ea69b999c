"""RPN, classifier and layer-mask heads, with the reference's state_dict names.

Semantics of the JAX package's ``models/heads.py``:

- RPN anchors ordered (h, w, anchor) with per-anchor (bg, fg) channel pairs;
- classifier: pooled 7x7 -> conv(k=7, VALID) 1024 -> conv1x1 1024 ->
  linear class / linear bbox (class-specific deltas);
- mask head: the GLM prior concatenated **in front of** the FPN crop
  (439 input channels by default), 4 x (3x3 conv + BN + relu), a 2x2
  stride-2 transposed conv, a 1x1 conv to ``num_classes`` logit maps.

Probabilities, classifier outputs and mask logits are float32 whatever the
compute dtype, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import FrozenBatchNorm2d, nchw, nhwc, pad_same


class RPNHead(nn.Module):
    """Shared RPN head over one NHWC pyramid level [B, H, W, C].

    Returns (class_logits [B, HWA, 2], probs [B, HWA, 2] f32,
    deltas [B, HWA, 4])."""

    def __init__(self, in_channels: int = 256, anchors_per_location: int = 3,
                 anchor_stride: int = 1):
        super().__init__()
        self.anchor_stride = anchor_stride
        self.conv_shared = nn.Conv2d(in_channels, 512, 3, stride=anchor_stride)
        self.conv_class = nn.Conv2d(512, 2 * anchors_per_location, 1)
        self.conv_bbox = nn.Conv2d(512, 4 * anchors_per_location, 1)

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
        self.conv1 = nn.Conv2d(in_channels, 1024, pool_size)
        self.bn1 = FrozenBatchNorm2d(1024)
        self.conv2 = nn.Conv2d(1024, 1024, 1)
        self.bn2 = FrozenBatchNorm2d(1024)
        self.linear_class = nn.Linear(1024, num_classes)
        self.linear_bbox = nn.Linear(1024, num_classes * 4)

    def forward(self, x: torch.Tensor):
        n = x.shape[0]
        y = F.relu(self.bn1(self.conv1(nchw(x))))
        y = F.relu(self.bn2(self.conv2(y)))
        y = y.reshape(n, 1024)
        logits = self.linear_class(y).to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        deltas = self.linear_bbox(y).reshape(n, self.num_classes, 4).to(torch.float32)
        return logits, probs, deltas


class MaskHead(nn.Module):
    """Layer-mask head: [GLM prior | FPN crop] -> num_classes logit maps.

    Input: fpn_crop [N, p, p, C], glm_crop [N, p, p, 183] (NHWC).
    Output: (logits [N, 2p, 2p, num_classes] f32, features [N, p, p, 256])."""

    def __init__(self, num_classes: int, in_channels: int = 439):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 256, 3, padding=1)
        self.bn1 = FrozenBatchNorm2d(256)
        self.conv2 = nn.Conv2d(256, 256, 3, padding=1)
        self.bn2 = FrozenBatchNorm2d(256)
        self.conv3 = nn.Conv2d(256, 256, 3, padding=1)
        self.bn3 = FrozenBatchNorm2d(256)
        self.conv4 = nn.Conv2d(256, 256, 3, padding=1)
        self.bn4 = FrozenBatchNorm2d(256)
        self.deconv = nn.ConvTranspose2d(256, 256, 2, stride=2)
        self.conv5 = nn.Conv2d(256, num_classes, 1)

    def forward(self, fpn_crop: torch.Tensor, glm_crop: torch.Tensor):
        dtype = self.conv1.weight.dtype
        x = torch.cat([glm_crop.to(dtype), fpn_crop.to(dtype)], dim=-1)
        x = nchw(x)
        for i in range(1, 5):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        feat = x
        x = F.relu(self.deconv(x))
        x = self.conv5(x)
        return nhwc(x).to(torch.float32), nhwc(feat)
