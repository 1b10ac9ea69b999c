"""SLN-Amodal's inference graph in plain PyTorch, float32: the benchmark's
reference.

A frozen copy of the published network (Mask R-CNN with the trunk and FPN
of the configuration's ``trunks/<backbone>.py``, the DeepLabV2-ResNet101-MSC
prior, the 439-channel layer-mask head) written for clarity, not speed:
NHWC tensors, plain convolutions, greedy NMS as a loop, RoIAlign as a
gather. It imports nothing of the program under test,
and takes its weights as a state_dict in the reference ``.pth`` layout,
the same one the benchmark hands the program.

Every convolution and matrix product goes through :func:`lowp.quantize`,
which is the identity unless a lower-precision control is switched on
(``lowp.precision("fp8")``).

What it computes beyond the published ``detect``: :meth:`Reference.candidates`
returns every proposal's class, score, logit margin and refined box, not
only the top detections, so that a judge can tell a legitimate reordering
at the top-k cut from a wrong answer; :meth:`Reference.masks_at` runs the
mask head at boxes it is given.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import lowp, trunks

F32 = torch.float32
LOG_DELTA_CLIP = 10.0


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        bias = None if self.bias is None else lowp.quantize(self.bias)
        return self._conv_forward(lowp.quantize(x), lowp.quantize(self.weight), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(lowp.quantize(x), lowp.quantize(self.weight),
                                  lowp.quantize(self.bias), self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(lowp.quantize(x), lowp.quantize(self.weight),
                        lowp.quantize(self.bias))


class FrozenBN(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias, on NCHW."""

    def __init__(self, n: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        for name, init in (("weight", torch.ones), ("bias", torch.zeros),
                           ("running_mean", torch.zeros), ("running_var", torch.ones)):
            self.register_buffer(name, init(n))

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = math.ceil(size / stride)
    pad = max((out - 1) * stride + kernel - size, 0)
    return pad // 2, pad - pad // 2


def pad_same(x, kernel: int, stride: int, value: float = 0.0):
    top, bottom = same_pad(x.shape[2], kernel, stride)
    left, right = same_pad(x.shape[3], kernel, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


def resize(x, size):
    """Bilinear, half-pixel centers, no antialias; NHWC or [B, H, W]."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    if x.dim() == 3:
        return F.interpolate(x[:, None], size=tuple(size), mode="bilinear",
                             align_corners=False)[:, 0]
    return nhwc(F.interpolate(nchw(x), size=tuple(size), mode="bilinear",
                              align_corners=False))


# ---------------------------------------------------------------- heads --

class RPNHead(nn.Module):
    def __init__(self, cin: int = 256, anchors: int = 3):
        super().__init__()
        self.conv_shared = Conv2d(cin, 512, 3)
        self.conv_class = Conv2d(512, 2 * anchors, 1)
        self.conv_bbox = Conv2d(512, 4 * anchors, 1)

    def forward(self, x):
        b = x.shape[0]
        shared = F.relu(self.conv_shared(pad_same(nchw(x), 3, 1)))
        logits = nhwc(self.conv_class(shared)).reshape(b, -1, 2)
        deltas = nhwc(self.conv_bbox(shared)).reshape(b, -1, 4)
        return logits, torch.softmax(logits, -1), deltas


class ClassifierHead(nn.Module):
    def __init__(self, num_classes: int, pool: int = 7, cin: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.conv1 = Conv2d(cin, 1024, pool)
        self.bn1 = FrozenBN(1024)
        self.conv2 = Conv2d(1024, 1024, 1)
        self.bn2 = FrozenBN(1024)
        self.linear_class = Linear(1024, num_classes)
        self.linear_bbox = Linear(1024, num_classes * 4)

    def features(self, x):
        y = F.relu(self.bn1(self.conv1(nchw(x))))
        return F.relu(self.bn2(self.conv2(y))).reshape(x.shape[0], 1024)

    def forward(self, x):
        y = self.features(x)
        logits = self.linear_class(y)
        return logits, torch.softmax(logits, -1), \
            self.linear_bbox(y).reshape(-1, self.num_classes, 4)


class MaskHead(nn.Module):
    def __init__(self, num_classes: int, cin: int = 439):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"conv{i}", Conv2d(cin if i == 1 else 256, 256, 3, padding=1))
            setattr(self, f"bn{i}", FrozenBN(256))
        self.deconv = ConvTranspose2d(256, 256, 2, stride=2)
        self.conv5 = Conv2d(256, num_classes, 1)

    def features(self, fpn_crop, glm_crop):
        x = nchw(torch.cat([glm_crop, fpn_crop], -1))
        for i in range(1, 5):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return F.relu(self.deconv(x))

    def forward(self, fpn_crop, glm_crop):
        return nhwc(self.conv5(self.features(fpn_crop, glm_crop)))


# -------------------------------------------------------------- DeepLab --

class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1, relu=True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=padding,
                           dilation=dilation, bias=False)
        self.bn = FrozenBN(cout, eps=1e-5)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.relu(y) if self.relu else y


class DLBottleneck(nn.Module):
    def __init__(self, cin, cout, stride, dilation, downsample):
        super().__init__()
        mid = cout // 4
        self.reduce = ConvBN(cin, mid, 1, stride)
        self.conv3x3 = ConvBN(mid, mid, 3, 1, dilation, dilation)
        self.increase = ConvBN(mid, cout, 1, relu=False)
        self.shortcut = ConvBN(cin, cout, 1, stride, relu=False) if downsample else None

    def forward(self, x):
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(self.increase(self.conv3x3(self.reduce(x))) + sc)


class DLResLayer(nn.Module):
    def __init__(self, n, cin, cout, stride, dilation):
        super().__init__()
        self.n = n
        for i in range(n):
            setattr(self, f"block{i + 1}", DLBottleneck(
                cin if i == 0 else cout, cout, stride if i == 0 else 1, dilation, i == 0))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"block{i + 1}")(x)
        return x


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBN(3, 64, 7, 2, 3, 1)

    def forward(self, x):
        return F.max_pool2d(self.conv1(x), 3, stride=2, padding=1, ceil_mode=True)


class ASPP(nn.Module):
    def __init__(self, cin, n_classes, rates=(6, 12, 18, 24)):
        super().__init__()
        self.n = len(rates)
        for i, r in enumerate(rates):
            setattr(self, f"c{i}", Conv2d(cin, n_classes, 3, padding=r, dilation=r))

    def forward(self, x):
        return sum(getattr(self, f"c{i}")(x) for i in range(self.n))


class DeepLabV2(nn.Module):
    def __init__(self, n_classes=182):
        super().__init__()
        self.layer1 = Stem()
        self.layer2 = DLResLayer(3, 64, 256, 1, 1)
        self.layer3 = DLResLayer(4, 256, 512, 2, 1)
        self.layer4 = DLResLayer(23, 512, 1024, 1, 2)
        self.layer5 = DLResLayer(3, 1024, 2048, 1, 4)
        self.aspp = ASPP(2048, n_classes)

    def forward(self, x):
        y = self.layer5(self.layer4(self.layer3(self.layer2(self.layer1(x)))))
        return self.aspp(y)


class DeepLabV2MSC(nn.Module):
    """Scales 1 and ``scales``, logits resized to the full-scale grid, fused
    by pixel max. NHWC in and out."""

    def __init__(self, n_classes=182, scales=(0.5, 0.75)):
        super().__init__()
        self.base = DeepLabV2(n_classes)
        self.scales = tuple(scales)

    def forward(self, x):
        fused = nhwc(self.base(nchw(x)))
        h, w = x.shape[1:3]
        for p in self.scales:
            ls = nhwc(self.base(nchw(resize(x, (int(h * p), int(w * p))))))
            fused = torch.maximum(fused, resize(ls, fused.shape[1:3]))
        return fused


# ------------------------------------------------------------ geometry --

def anchors_of(cfg) -> np.ndarray:
    """Pyramid anchors [A, 4] (y1, x1, y2, x2) float32, level-major, each
    level (row, column, ratio) ordered as the published generator."""
    out = []
    for scale, stride in zip(cfg["rpn_anchor_scales"], cfg["backbone_strides"]):
        n = int(math.ceil(cfg["image_size"] / stride))
        scales, ratios = np.meshgrid(np.array([scale]), np.array(cfg["rpn_anchor_ratios"]))
        scales, ratios = scales.flatten(), ratios.flatten()
        heights, widths = scales / np.sqrt(ratios), scales * np.sqrt(ratios)
        sx, sy = np.meshgrid(np.arange(n) * stride, np.arange(n) * stride)
        bw, cx = np.meshgrid(widths, sx)
        bh, cy = np.meshgrid(heights, sy)
        centers = np.stack([cy, cx], 2).reshape(-1, 2)
        sizes = np.stack([bh, bw], 2).reshape(-1, 2)
        out.append(np.concatenate([centers - 0.5 * sizes, centers + 0.5 * sizes], 1))
    return np.concatenate(out).astype(np.float32)


def apply_deltas(boxes, deltas):
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    cy = boxes[..., 0] + 0.5 * h + deltas[..., 0] * h
    cx = boxes[..., 1] + 0.5 * w + deltas[..., 1] * w
    h = h * torch.exp(deltas[..., 2].clamp(-LOG_DELTA_CLIP, LOG_DELTA_CLIP))
    w = w * torch.exp(deltas[..., 3].clamp(-LOG_DELTA_CLIP, LOG_DELTA_CLIP))
    y1, x1 = cy - 0.5 * h, cx - 0.5 * w
    return torch.stack([y1, x1, y1 + h, x1 + w], -1)


def clip(boxes, lo, hi):
    return boxes.clamp(lo, hi)


def iou_plus_one(box, boxes):
    """IoU of one box [4] with boxes [N, 4], the legacy +1 convention."""
    y1 = torch.maximum(box[0], boxes[:, 0])
    x1 = torch.maximum(box[1], boxes[:, 1])
    y2 = torch.minimum(box[2], boxes[:, 2])
    x2 = torch.minimum(box[3], boxes[:, 3])
    inter = (y2 - y1 + 1).clamp_min(0) * (x2 - x1 + 1).clamp_min(0)
    a = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    b = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    union = a + b - inter
    return inter / torch.where(union != 0, union, torch.ones_like(union))


def nms(boxes, max_out: int, threshold: float) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes [N, 4]: indices of the kept boxes
    in order, at most ``max_out``; a box is suppressed at IoU > threshold."""
    alive = torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    keep = []
    thr = float(np.float32(threshold))
    for _ in range(max_out):
        if not bool(alive.any()):
            break
        i = int(alive.to(torch.uint8).argmax())
        keep.append(i)
        alive &= ~(iou_plus_one(boxes[i], boxes) > thr)
        alive[i] = False
    return torch.tensor(keep, dtype=torch.long, device=boxes.device)


def nms_pairs(boxes, keep) -> int:
    """What greedy NMS needs: each kept box against every later box."""
    return int((boxes.shape[0] - 1 - keep).sum())


def _coords(lo, hi, out_size: int, dim1):
    """[N, out_size] float32 sample coordinates along one axis. As TF's
    crop_and_resize compiled by XLA computes them (the published graph's
    arithmetic): the step is a product with the float32 reciprocal of
    ``out_size - 1``, and ``lo * dim1 + step * scale`` one fused
    multiply-add (exact through float64 here). An ulp here decides whether
    a sample on the map's last row or column is inside it."""
    recip = float(np.float32(1.0) / np.float32(out_size - 1))
    scale = (hi - lo) * dim1 * recip
    steps = torch.arange(out_size, dtype=F32, device=lo.device)
    start = lo * dim1
    return (steps[None, :].double() * scale[:, None].double()
            + start[:, None].double()).to(F32)


def _bilinear(image, bi, in_y, in_x, h, w):
    """Gather-and-lerp from image [B, H, W, C] at per-box sample rows and
    columns; samples outside the map give 0."""
    top, left = torch.floor(in_y), torch.floor(in_x)
    ylerp, xlerp = in_y - top, in_x - left
    t = top.clamp(0, h - 1).long()
    bt = torch.ceil(in_y).clamp(0, h - 1).long()
    lf = left.clamp(0, w - 1).long()
    rt = torch.ceil(in_x).clamp(0, w - 1).long()
    bi = bi[:, None, None]

    def at(yy, xx):
        return image[bi, yy[:, :, None], xx[:, None, :], :]

    tl, tr, bl, br = at(t, lf), at(t, rt), at(bt, lf), at(bt, rt)
    top_v = tl + (tr - tl) * xlerp[:, None, :, None]
    bot_v = bl + (br - bl) * xlerp[:, None, :, None]
    out = top_v + (bot_v - top_v) * ylerp[:, :, None, None]
    valid = (((in_y >= 0) & (in_y <= h - 1))[:, :, None, None]
             & ((in_x >= 0) & (in_x <= w - 1))[:, None, :, None])
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


def crop_and_resize(image, boxes, box_indices, size):
    """TF crop_and_resize: normalized boxes [N, 4] over image [B, H, W, C]."""
    h, w = image.shape[1:3]
    y1, x1, y2, x2 = boxes.to(F32).unbind(1)
    return _bilinear(image, box_indices.long(), _coords(y1, y2, size, float(h) - 1.0),
                     _coords(x1, x2, size, float(w) - 1.0), h, w)


def roi_align(levels, boxes, size: int, image_size: int):
    """FPN RoIAlign of one image: levels P2..P5 [1, H_l, W_l, C], boxes
    [N, 4] normalized; each box on the level of the FPN paper's rule."""
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    lvl = 4.0 + torch.log2(torch.sqrt(torch.clamp_min(h * w, 1e-12))
                           / (224.0 / float(image_size)))
    lvl = torch.clamp(torch.round(lvl), 2, 5).long() - 2
    out = torch.zeros((boxes.shape[0], size, size, levels[0].shape[-1]),
                      dtype=levels[0].dtype, device=boxes.device)
    for i, level in enumerate(levels):
        rows = torch.nonzero(lvl == i).reshape(-1)
        if rows.numel():
            zero = torch.zeros(rows.numel(), dtype=torch.long, device=boxes.device)
            out[rows] = crop_and_resize(level, boxes[rows], zero, size)
    return out


# ---------------------------------------------------------------- graph --

class Candidates(NamedTuple):
    """Every proposal of one image after the classifier (R of them)."""

    boxes: torch.Tensor        # [R, 4] refined, clipped and rounded pixels
    class_ids: torch.Tensor    # [R] argmax class
    scores: torch.Tensor       # [R] its probability
    margin: torch.Tensor       # [R] foreground minus background logit
    detections: torch.Tensor   # [D] indices of the detect() output, best first
    nms_pairs: int             # the proposal NMS's pair count


class Reference(nn.Module):
    """The network of one configuration (a dict of the ``Config`` fields).
    ``trunk`` is the trunk file of the configuration's ``backbone``
    (``trunks/<backbone>.py``), whose network is ``fpn``."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        self.trunk = trunks.load(cfg["backbone"])
        self.fpn = self.trunk.network(cfg)
        self.rpn = RPNHead(cfg["fpn_channels"], len(cfg["rpn_anchor_ratios"]))
        self.classifier = ClassifierHead(cfg["num_classes"], cfg["pool_size"],
                                         cfg["fpn_channels"])
        self.mask = MaskHead(cfg["num_classes"],
                             cfg["fpn_channels"] + cfg["glm_num_classes"] + 1)
        self.GLM_modual = DeepLabV2MSC(cfg["glm_num_classes"], cfg["glm_scales"])
        self.register_buffer("anchors", torch.from_numpy(anchors_of(cfg)), persistent=False)
        self.requires_grad_(False)
        self.eval()

    def molded(self, image_u8: torch.Tensor) -> torch.Tensor:
        """A [1, S, S, 3] uint8 image, mean subtracted, float32."""
        return image_u8.to(F32) - torch.tensor(self.cfg["mean_pixel"], dtype=F32,
                                               device=image_u8.device)

    def prior(self, x):
        """The GLM prior [1, g, g, 183]: probabilities and argmax / 255."""
        g = self.cfg["glm_input_size"]
        probs = torch.softmax(self.GLM_modual(resize(x, (g, g))), -1)
        return torch.cat([probs, probs.argmax(-1)[..., None].to(F32) / 255.0], -1)

    def rpn_outputs(self, feats):
        """(logits [A, 2], probabilities, deltas [A, 4]) of one image over
        every level."""
        outs = [self.rpn(p) for p in feats]
        return tuple(torch.cat([o[i] for o in outs], 1)[0] for i in range(3))

    def proposals(self, probs, deltas, count: int = None):
        """(Normalized proposals [<= count, 4] of one image, the NMS's pair
        count); ``count`` defaults to ``post_nms_rois_inference``."""
        cfg = self.cfg
        k = min(cfg["pre_nms_limit"], self.anchors.shape[0])
        order = torch.sort(probs[:, 1], descending=True, stable=True).indices[:k]
        std = torch.tensor(cfg["rpn_bbox_std_dev"], dtype=F32, device=probs.device)
        boxes = clip(apply_deltas(self.anchors[order], deltas[order] * std),
                     0.0, float(cfg["image_size"]))
        keep = nms(boxes, count or cfg["post_nms_rois_inference"], cfg["rpn_nms_threshold"])
        return boxes[keep] / float(cfg["image_size"]), nms_pairs(boxes, keep)

    @torch.no_grad()
    def candidates(self, image_u8: torch.Tensor, chunk: int = 256):
        """(Candidates, P2..P5, prior) of one molded uint8 image [1, S, S, 3]."""
        cfg = self.cfg
        size = cfg["image_size"]
        x = self.molded(image_u8)
        feats = self.fpn(x)
        levels = feats[:4]
        _, probs, deltas = self.rpn_outputs(feats)
        rois, pairs = self.proposals(probs, deltas)
        logits = []
        deltas = []
        for s in range(0, rois.shape[0], chunk):
            crops = roi_align(levels, rois[s:s + chunk], cfg["pool_size"], size)
            lg, _, dl = self.classifier(crops)
            logits.append(lg)
            deltas.append(dl)
        logits, deltas = torch.cat(logits), torch.cat(deltas)
        probs = torch.softmax(logits, -1)
        class_ids = probs.argmax(-1)
        scores = probs.gather(1, class_ids[:, None])[:, 0]
        specific = deltas[torch.arange(deltas.shape[0]), class_ids]
        std = torch.tensor(cfg["bbox_std_dev"], dtype=F32, device=rois.device)
        boxes = torch.round(clip(apply_deltas(rois, specific * std) * size, 0.0, float(size)))
        key = torch.where(class_ids > 0, scores, torch.full_like(scores, -math.inf))
        top = torch.sort(key, descending=True, stable=True).indices
        top = top[:cfg["detection_max_instances"]]
        top = top[key[top] > -math.inf]
        cands = Candidates(boxes, class_ids, scores, logits[:, 1] - logits[:, 0], top, pairs)
        return cands, levels, self.prior(x)

    @torch.no_grad()
    def masks_at(self, levels, prior, boxes_px: torch.Tensor) -> torch.Tensor:
        """The mask head at pixel boxes [N, 4]: [N, 2m, 2m] foreground
        probabilities, the sigmoid of the layer channels' sum. The prior is
        cropped with pixel coordinates where normalized ones are expected
        (the released model's inference quirk, as the program has it)."""
        cfg = self.cfg
        m = cfg["mask_pool_size"]
        boxes_px = boxes_px.clamp(0.0, float(cfg["image_size"]))
        norm = boxes_px / float(cfg["image_size"])
        fpn = roi_align(levels, norm, m, cfg["image_size"])
        zero = torch.zeros(boxes_px.shape[0], dtype=torch.long, device=boxes_px.device)
        glm = crop_and_resize(prior, boxes_px, zero, m)
        logits = self.mask(fpn, glm)
        return torch.sigmoid(logits[..., 1:].sum(-1))
