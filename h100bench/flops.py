"""Model FLOPs from shapes, and the H100's peaks: the yardstick of the
``mfu.*`` metrics and of the kernels' rooflines.

:func:`inference_flops` counts every convolution and matrix product that
the published network needs for one image at a configuration's shapes
(two operations per multiply-add): the trunk and FPN (counted by the
configuration's trunk file, ``reference/trunks/<backbone>.py``), the RPN
head over all five levels, the classifier over the proposals, DeepLabV2 at
its three scales with the ASPP's four dilated branches, and the mask head
over the detections. Resizes, softmaxes, NMS and RoIAlign are not products
and are not counted. The count is the same whatever implements the work (a
cuDNN convolution or the same product as one matmul).

The kernel bounds follow ``chip_smoke.py``'s counts: the least time is the
larger of the bytes the inputs and outputs need at the HBM rate and the
operations at the rate of the units that run them.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

from .reference import trunks

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores: lerps, IoUs
HBM_BYTES_PER_S = 3.35e12
IOU_FLOPS = 15                  # one +1 IoU and its compare


def conv_out(n: int, k: int, s: int = 1, p: int = 0, d: int = 1) -> int:
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def conv_flops(h: int, w: int, cin: int, cout: int, k: int) -> float:
    """2 x output pixels x cout x cin x k x k."""
    return 2.0 * h * w * cout * cin * k * k


class Layer(NamedTuple):
    """One convolution or matrix product of the graph: its forward FLOPs,
    its part (for the split), whether stage ``4+`` trains its weights, and
    whether the gradient must pass into its input in that stage."""

    flops: float
    part: str
    trained: bool = False
    input_grad: bool = False


def bottleneck_stage(n: int, cin: int, planes: int, blocks: int, stride: int, part: str,
                     trained: bool = False, grad_in: bool = False) -> Tuple[list, int]:
    """(layers, output size) of a stage of bottlenecks whose first block
    strides on its 1x1 reduce and has a projection shortcut; ``grad_in``:
    the stage's input carries a gradient."""
    out = conv_out(n, 1, stride)
    layers = []
    for i in range(blocks):
        c_in = cin if i == 0 else planes * 4
        into = grad_in if i == 0 else trained or grad_in
        inner = trained or grad_in
        layers += [Layer(conv_flops(out, out, c_in, planes, 1), part, trained, into),
                   Layer(conv_flops(out, out, planes, planes, 3), part, trained, inner),
                   Layer(conv_flops(out, out, planes, planes * 4, 1), part, trained, inner)]
        if i == 0:
            layers.append(Layer(conv_flops(out, out, c_in, planes * 4, 1), part, trained, into))
    return layers, out


def trunk_fpn_layers(cfg: Dict, trained_levels=()) -> Tuple[list, list]:
    """(layers, level sizes P2..P6) of the trunk and FPN at cfg's image
    size, from the trunk file of cfg's ``backbone``
    (``reference/trunks/<backbone>.py``); ``trained_levels`` names the
    pyramid levels (2..5) whose trunk weights train."""
    return trunks.load(cfg["backbone"]).flop_layers(cfg, trained_levels)


def head_layers(cfg: Dict, levels, rois: int, boxes: int, trained: bool) -> list:
    """The RPN over every level, the classifier over ``rois`` and the mask
    head over ``boxes``."""
    a, c, k = len(cfg["rpn_anchor_ratios"]), cfg["fpn_channels"], cfg["num_classes"]
    layers = []
    for n in levels:
        layers += [Layer(conv_flops(n, n, c, 512, 3), "rpn", trained, trained),
                   Layer(conv_flops(n, n, 512, 6 * a, 1), "rpn", trained, trained)]
    p = cfg["pool_size"]
    layers += [Layer(rois * 2.0 * p * p * c * 1024, "classifier", trained, trained),
               Layer(rois * 2.0 * 1024 * 1024, "classifier", trained, trained),
               Layer(rois * 2.0 * 1024 * k * 5, "classifier", trained, trained)]
    m = cfg["mask_pool_size"]
    cin = c + cfg["glm_num_classes"] + 1
    layers += [Layer(boxes * conv_flops(m, m, cin, 256, 3), "mask", trained, trained)]
    layers += [Layer(boxes * conv_flops(m, m, 256, 256, 3), "mask", trained, trained)] * 3
    layers += [Layer(boxes * conv_flops(2 * m, 2 * m, 256, 256, 1), "mask", trained, trained),
               Layer(boxes * conv_flops(2 * m, 2 * m, 256, k, 1), "mask", trained, trained)]
    return layers


def deeplab_flops(n: int, classes: int) -> float:
    """DeepLabV2-ResNet101 (output stride 8) on an n x n input."""
    s = conv_out(n, 7, 2, 3)
    total = conv_flops(s, s, 3, 64, 7)
    s = math.ceil((s + 2 - 3) / 2) + 1                         # max pool, ceil mode
    cin = 64
    for cout, count, stride in ((256, 3, 1), (512, 4, 2), (1024, 23, 1), (2048, 3, 1)):
        layers, s = bottleneck_stage(s, cin, cout // 4, count, stride, "glm")
        total += sum(x.flops for x in layers)
        cin = cout
    return total + 4 * conv_flops(s, s, 2048, classes, 3)


def glm_flops(cfg: Dict) -> float:
    g = cfg["glm_input_size"]
    sizes = [g] + [int(g * p) for p in cfg["glm_scales"]]
    return sum(deeplab_flops(n, cfg["glm_num_classes"]) for n in sizes)


def by_part(layers, glm: float) -> Dict[str, float]:
    parts: Dict[str, float] = {"glm": glm}
    for x in layers:
        parts[x.part] = parts.get(x.part, 0.0) + x.flops
    parts["total"] = sum(parts.values())
    return parts


def inference_flops(cfg: Dict, rois: int = None, detections: int = None) -> Dict[str, float]:
    """FLOPs of one image's inference by part, and their ``total``;
    ``rois`` and ``detections`` default to the configuration's
    ``post_nms_rois_inference`` and ``detection_max_instances``."""
    rois = cfg["post_nms_rois_inference"] if rois is None else rois
    detections = cfg["detection_max_instances"] if detections is None else detections
    trunk, levels = trunk_fpn_layers(cfg)
    return by_part(trunk + head_layers(cfg, levels, rois, detections, False), glm_flops(cfg))


def training_flops(cfg: Dict) -> Dict[str, float]:
    """FLOPs of one image's step of stage ``4+``: the forward (the GLM
    without gradient; the classifier and the mask head over the
    ``train_rois_per_image`` sampled ROIs), each trained layer's weight
    gradient, and the input gradient of every layer the gradient passes
    through on its way to a trained weight (each as many FLOPs as the
    layer's forward). ``backward`` holds the two gradients' sum."""
    trunk, levels = trunk_fpn_layers(cfg, trained_levels=(4, 5))
    t = cfg["train_rois_per_image"]
    layers = trunk + head_layers(cfg, levels, t, t, True)
    parts = by_part(layers, glm_flops(cfg))
    backward = sum(x.flops * (x.trained + x.input_grad) for x in layers)
    parts["backward"] = backward
    parts["total"] += backward
    return parts


def nms_bound_s(batch: int, n: int, max_out: int, pairs: int) -> Tuple[float, str]:
    """The least time of one batched NMS call (seconds) and what bounds it:
    the boxes and validity read once, the keeps written once; each kept
    box's IoU against every later box, in float32."""
    nbytes = batch * n * (16 + 1) + batch * max_out * (4 + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, pairs * IOU_FLOPS / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def backward_bound_s(batch: int, rois: int, pool: int, levels, elem: int) -> Tuple[float, str]:
    """The least time of one RoIAlign backward call (seconds) and what
    bounds it: every level's gradient [batch, H, W, C] written whole, the
    cotangent [batch, rois, pool, pool, C] read once, the boxes once; per
    cotangent element two rows, two corners, two products and an add (12
    float32 operations)."""
    c = levels[0][2]
    grad = batch * rois * pool * pool * c
    nbytes = sum(batch * h * w * ch * elem for h, w, ch in levels) + grad * elem + batch * rois * 16
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 12 * grad / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
