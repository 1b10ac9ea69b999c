"""SLNAmodal — the semantic layering network's inference graph in PyTorch.

Port of the JAX package's ``models/sln.py`` (``infer`` and
``infer_detect_only``). The submodules carry the reference's state_dict
names (``fpn``, ``rpn``, ``classifier``, ``mask``, ``GLM_modual``), so the
reference ``.pth`` layout loads with ``strict=True``.

The graph, per batch of molded NHWC images:

1. ResNet-FPN -> P2..P6; the RPN head over every level;
2. proposals: top ``pre_nms_limit`` -> deltas -> clip -> NMS (CUDA kernel
   on the card) -> ``post_nms_rois_inference`` ROIs;
3. 7x7 RoIAlign over P2..P5 (CUDA kernel on the card), the classifier;
4. ``refine_detections``: the top ``detection_max_instances``;
5. the GLM prior: DeepLabV2-MSC logits -> softmax, argmax label channel;
6. 16x16 RoIAlign plus the GLM-prior crop, the 439-channel mask head;
7. mask channel 1 set to the sigmoid of the layer-channel sum.

Reference quirks kept: at inference the GLM prior is cropped with pixel
coordinates where normalized ones are expected
(``glm_prior_pixel_coords_at_inference``), which zeroes it for interior
boxes; ``glm_elide_at_inference`` skips DeepLab on the detect-only path.

:meth:`SLNAmodal.train_step_outputs` is the training graph (the JAX
package's ``train_step_outputs``, ``models/sln.py:310-387``): the GLM prior
and the proposal layer run without gradient (JAX stops it there), the
detection-target layer samples ``train_rois_per_image`` ROIs per image, and
the classifier and the mask head run over the detached sampled ROIs, the
GLM prior cropped with normalized coordinates. Gradients reach P2..P5
through the RoIAlign kernel's backward. With ``use_refine_head`` the
refine head runs over the ``amodal_refine`` seam (output ``refined``). The
constructor builds an inference graph (no parameter requires a gradient);
the trainer turns gradients on for the parameters of its stage.

Dtypes, as in the JAX package: parameters (and the frozen BN statistics)
in ``param_dtype``, convolutions and matmuls in ``compute_dtype`` (the
images are cast to it before the backbone and before the GLM resize); the
RPN's softmax, the box math, NMS, the RoIAlign geometry, the heads' outputs,
the GLM logits and the losses in float32 or wider.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..config import Config
from ..detect.detection import refine_detections
from ..detect.proposal import proposal_layer_batched
from ..detect.targets import RoiTargets, detection_target_layer
from ..device import resolve_device, torch_dtype
from ..ops.anchors import config_anchors
from ..ops.roi_align import crop_and_resize
from ..ops.roi_align_cuda import pyramid_roi_align
from .backbone import ResNetFPN
from .common import resize_bilinear, resize_bilinear_2d
from .deeplab import DeepLabV2MSC
from .heads import ClassifierHead, MaskHead, RefineHead, RPNHead


class InferenceOutputs(NamedTuple):
    detections: torch.Tensor    # [B, D, 6] pixel coords, zero-padded
    det_valid: torch.Tensor     # [B, D]
    masks: torch.Tensor         # [B, D, 2m, 2m, C] (channel 1 = sigmoid sum)
    global_label: torch.Tensor  # [B, H, W] upsampled GLM argmax


class DetectOutputs(NamedTuple):
    """The ``detect()`` contract: the GLM global label is not computed."""

    detections: torch.Tensor
    det_valid: torch.Tensor
    masks: torch.Tensor


class TrainingOutputs(NamedTuple):
    rpn_logits: torch.Tensor       # [B, A, 2]
    rpn_deltas: torch.Tensor       # [B, A, 4]
    targets: RoiTargets            # [B, T, ...]
    class_logits: torch.Tensor     # [B, T, C] f32
    bbox_deltas: torch.Tensor      # [B, T, C, 4] f32
    mask_logits: torch.Tensor      # [B, T, 2m, 2m, C] f32
    refined: Optional[torch.Tensor] = None  # [B, T, 2m, 2m, C] f32 with the refine head


class SLNAmodal(nn.Module):
    """The inference graph on ``device`` ("cuda" by default; raises when no
    card is present unless ``device="cpu"``). Parameters are held in
    ``param_dtype`` (float32 or float64), the graph computes in
    ``compute_dtype``."""

    def __init__(self, config: Config, device="cuda"):
        super().__init__()
        self.compute_dtype = torch_dtype(config.compute_dtype)
        param_dtype = torch_dtype(config.param_dtype)
        if param_dtype not in (torch.float32, torch.float64):
            raise ValueError(f"param_dtype must be float32 or float64, got "
                             f"{config.param_dtype!r}")
        dev = resolve_device(device)
        self.config = config
        self.fpn = ResNetFPN(config.backbone, config.fpn_channels)
        self.rpn = RPNHead(config.fpn_channels, len(config.rpn_anchor_ratios),
                           config.rpn_anchor_stride)
        self.classifier = ClassifierHead(config.num_classes, config.pool_size,
                                         config.fpn_channels)
        self.mask = MaskHead(config.num_classes, config.mask_head_in_channels)
        self.GLM_modual = DeepLabV2MSC(config.glm_num_classes, config.glm_scales)
        if config.use_refine_head:
            # image crop (3) | mask logits twice | GLM-label crop (1)
            self.amodal_refine = RefineHead(config.num_classes, 4 + 2 * config.num_classes)
        # anchors are float32 values, widened exactly to the box dtype at use
        self.register_buffer(
            "anchors", torch.from_numpy(config_anchors(config)), persistent=False)
        self.to(device=dev, dtype=param_dtype)
        if dev.type == "cuda":
            self.to(memory_format=torch.channels_last)
        # an inference graph: no autograd state is recorded
        self.requires_grad_(False)
        self.eval()

    def cast_weights_to_compute_dtype(self) -> "SLNAmodal":
        """Hold the convolution and linear weights in the compute dtype, for
        a model whose weights no longer change (inference): the casts each
        layer makes at use then do nothing. The values are those the casts
        give; the frozen BN statistics keep ``param_dtype``. A no-op where
        the two dtypes agree."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(self.compute_dtype)
        return self

    # ------------------------------------------------------------- pieces --

    def _rpn_all_levels(self, feats: Sequence[torch.Tensor]):
        outs = [self.rpn(p) for p in feats]
        return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(3))

    def _glm_prior(self, images: torch.Tensor, need_label: bool = True):
        """Frozen DeepLab prior: (probs + label channel [B, g, g, 183] f32,
        the full-resolution argmax label [B, H, W] or None)."""
        cfg = self.config
        h, w = images.shape[1:3]
        glm_in = resize_bilinear(images.to(self.compute_dtype),
                                 (cfg.glm_input_size, cfg.glm_input_size))
        logits = self.GLM_modual(glm_in)                      # [B, g, g, 182] f32
        probs = torch.softmax(logits, dim=-1)
        label = probs.argmax(dim=-1)
        prior = torch.cat([probs, label[..., None].to(torch.float32) / 255.0], dim=-1)
        if not need_label:
            return prior, None
        return prior, resize_bilinear_2d(label.to(torch.float32), (h, w))

    def _proposals(self, rpn_probs, rpn_deltas, proposal_count: int):
        cfg = self.config
        return proposal_layer_batched(
            rpn_probs, rpn_deltas, self.anchors,
            proposal_count=proposal_count,
            nms_threshold=cfg.rpn_nms_threshold,
            image_size=cfg.image_size,
            rpn_bbox_std_dev=cfg.rpn_bbox_std_dev,
            pre_nms_limit=cfg.pre_nms_limit,
        )

    def _classifier_on(self, feats, rois):
        """feats: 4 NHWC levels [B, H_l, W_l, C]; rois [B, R, 4]."""
        cfg = self.config
        b, r = rois.shape[:2]
        crops = pyramid_roi_align(feats, rois, (cfg.pool_size, cfg.pool_size),
                                  (cfg.image_size, cfg.image_size))
        logits, probs, deltas = self.classifier(crops.reshape(b * r, *crops.shape[2:]))
        return (logits.reshape(b, r, -1), probs.reshape(b, r, -1),
                deltas.reshape(b, r, cfg.num_classes, 4))

    def _mask_on(self, feats, rois, glm_prior: Optional[torch.Tensor], glm_boxes):
        """Mask head over [B, N] boxes. ``glm_boxes`` are the coords of the
        GLM-prior crop; ``glm_prior=None`` feeds exact-zero prior crops."""
        cfg = self.config
        b, n = rois.shape[:2]
        m = cfg.mask_pool_size
        fpn_crops = pyramid_roi_align(feats, rois, (m, m),
                                      (cfg.image_size, cfg.image_size))
        if glm_prior is None:
            glm_crops = torch.zeros((b, n, m, m, cfg.glm_num_classes + 1),
                                    dtype=fpn_crops.dtype, device=rois.device)
        else:
            box_indices = torch.arange(b, device=rois.device).repeat_interleave(n)
            glm_crops = crop_and_resize(glm_prior, glm_boxes.reshape(b * n, 4),
                                        box_indices, (m, m))
        logits, _ = self.mask(fpn_crops.reshape(b * n, m, m, -1),
                              glm_crops.reshape(b * n, m, m, -1))
        return logits.reshape(b, n, *logits.shape[1:])

    # -------------------------------------------------------------- modes --

    @torch.no_grad()
    def infer(self, images: torch.Tensor, windows: torch.Tensor) -> InferenceOutputs:
        """Full inference graph. images [B, H, W, 3] molded (mean
        subtracted); windows [B, 4] pixels."""
        return self._infer_impl(images, windows, detect_only=False)

    @torch.no_grad()
    def infer_detect_only(self, images: torch.Tensor, windows: torch.Tensor) -> DetectOutputs:
        """:meth:`infer` without the full-resolution global label (the
        ``detect()`` contract). With ``glm_elide_at_inference`` the DeepLab
        forward is skipped and the mask head gets zero prior crops
        (near-parity: boxes touching the top/left edge can differ)."""
        return self._infer_impl(images, windows, detect_only=True)

    def _infer_impl(self, images, windows, *, detect_only: bool):
        cfg = self.config
        feats = self.fpn(images.to(self.compute_dtype))
        _, rpn_probs, rpn_deltas = self._rpn_all_levels(feats)
        skip_glm = (detect_only and cfg.glm_prior_pixel_coords_at_inference
                    and cfg.glm_elide_at_inference)
        if skip_glm:
            glm_prior, global_label = None, None
        else:
            glm_prior, global_label = self._glm_prior(images, need_label=not detect_only)

        rois, roi_valid = self._proposals(rpn_probs, rpn_deltas,
                                          cfg.post_nms_rois_inference)
        # the RoIAlign kernel reads NHWC levels; the FPN's channels_last
        # outputs are already contiguous in that layout
        levels = [p.contiguous() for p in feats[:4]]
        _, probs, deltas = self._classifier_on(levels, rois)

        detections, det_valid = refine_detections(
            rois, roi_valid, probs, deltas, windows,
            image_size=cfg.image_size,
            bbox_std_dev=cfg.rpn_bbox_std_dev,
            max_instances=cfg.detection_max_instances,
            min_confidence=cfg.detection_min_confidence,
            use_nms=cfg.use_nms,
            nms_threshold=cfg.detection_nms_threshold,
        )

        det_boxes_px = torch.clamp(detections[..., :4], 0.0, float(cfg.image_size))
        det_boxes_norm = det_boxes_px / float(cfg.image_size)
        glm_boxes = (det_boxes_px if cfg.glm_prior_pixel_coords_at_inference
                     else det_boxes_norm)
        mask_logits = self._mask_on(levels, det_boxes_norm, glm_prior, glm_boxes)

        # channel 1 := sigmoid(sum of layer channels)
        masks = mask_logits.clone()
        masks[..., 1] = torch.sigmoid(mask_logits[..., 1:].sum(dim=-1))

        if detect_only:
            return DetectOutputs(detections, det_valid, masks)
        return InferenceOutputs(detections, det_valid, masks, global_label)

    def train_step_outputs(self, images: torch.Tensor, gt_class_ids: torch.Tensor,
                           gt_boxes: torch.Tensor, gt_masks: torch.Tensor, *,
                           generator: Optional[torch.Generator] = None,
                           pos_uniform: Optional[torch.Tensor] = None,
                           neg_uniform: Optional[torch.Tensor] = None) -> TrainingOutputs:
        """Training forward graph. images [B, H, W, 3] molded; gt_class_ids
        [B, G]; gt_boxes [B, G, 4] normalized; gt_masks [B, G, L, H, W].
        The target layer's random priorities come from ``generator``, or
        are ``pos_uniform``/``neg_uniform`` [B, P] (P =
        ``post_nms_rois_training``)."""
        cfg = self.config
        feats = self.fpn(images.to(self.compute_dtype))
        rpn_logits, rpn_probs, rpn_deltas = self._rpn_all_levels(feats)
        # no gradient through the prior or the proposals: both are targets
        # of the heads, not a gradient path (the reference detaches the ROIs)
        with torch.no_grad():
            glm_prior, _ = self._glm_prior(images, need_label=False)
            rois, roi_valid = self._proposals(rpn_probs, rpn_deltas,
                                              cfg.post_nms_rois_training)
            targets = detection_target_layer(
                rois, roi_valid, gt_class_ids, gt_boxes, gt_masks,
                train_rois=cfg.train_rois_per_image,
                roi_positive_ratio=cfg.roi_positive_ratio,
                mask_shape=cfg.mask_shape, bbox_std_dev=cfg.bbox_std_dev,
                generator=generator, pos_uniform=pos_uniform, neg_uniform=neg_uniform)
        sampled = targets.rois
        levels = [p.contiguous() for p in feats[:4]]
        class_logits, _, bbox_deltas = self._classifier_on(levels, sampled)
        mask_logits = self._mask_on(levels, sampled, glm_prior, sampled)
        refined = (self._refine_on(images, sampled, glm_prior, mask_logits)
                   if cfg.use_refine_head else None)
        return TrainingOutputs(rpn_logits=rpn_logits, rpn_deltas=rpn_deltas,
                               targets=targets, class_logits=class_logits,
                               bbox_deltas=bbox_deltas, mask_logits=mask_logits,
                               refined=refined)

    def _refine_on(self, images, rois, glm_prior, mask_logits):
        """The reference's dormant ``amodal_refine`` seam (the JAX package's
        ``models/sln.py:351-377``): the image crop / 140, the mask logits
        (no gradient) twice and the GLM-label crop, fused at the mask size,
        through the refine head. rois [B, T, 4] normalized."""
        b, t = rois.shape[:2]
        mh = self.config.mask_shape[0]
        boxes = rois.reshape(b * t, 4)
        box_indices = torch.arange(b, device=rois.device).repeat_interleave(t)
        img_crop = crop_and_resize(images / 140.0, boxes, box_indices, (mh, mh))
        lab_crop = crop_and_resize(glm_prior[..., -1:], boxes, box_indices, (mh, mh))
        mask_small = mask_logits.detach().reshape(b * t, *mask_logits.shape[2:])
        fused = torch.cat([img_crop, mask_small, mask_small, lab_crop], dim=-1)
        refined = self.amodal_refine(fused.to(self.compute_dtype))
        return refined.reshape(b, t, *refined.shape[1:])
