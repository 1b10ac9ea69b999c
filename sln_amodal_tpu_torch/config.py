"""Configuration of the PyTorch port.

The port's own copy of the JAX package's ``Config``: the same fields with
the same defaults, so that one kwargs dict builds the configuration of both
packages in the parity tests. The port imports nothing from the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    """Model / training / inference configuration (reference defaults)."""

    name: str = "coco"

    # --- classes & layers -------------------------------------------------
    # NUM_CLASSES = 2 (bg + foreground) after the reference's head surgery;
    # the mask head emits num_classes channels, channels 1: being
    # occlusion-depth layers.
    num_classes: int = 2

    # --- image geometry ---------------------------------------------------
    image_size: int = 1024            # IMAGE_MAX_DIM; squash-resized square
    image_min_dim: int = 800
    image_padding: bool = True
    mean_pixel: Tuple[float, float, float] = (123.7, 116.8, 103.9)

    # --- backbone / FPN ---------------------------------------------------
    backbone: str = "resnet101"
    backbone_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    fpn_channels: int = 256

    # --- anchors ----------------------------------------------------------
    rpn_anchor_scales: Tuple[int, ...] = (32, 64, 128, 256, 512)
    rpn_anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_anchor_stride: int = 1

    # --- proposals --------------------------------------------------------
    rpn_nms_threshold: float = 0.7
    pre_nms_limit: int = 6000
    post_nms_rois_training: int = 1000
    post_nms_rois_inference: int = 1000
    rpn_train_anchors_per_image: int = 256
    max_num_rois_heads: int = 500     # MAX_NUMB_RPNS cap before heads

    # --- ROI heads ----------------------------------------------------------
    train_rois_per_image: int = 100
    roi_positive_ratio: float = 0.7
    pool_size: int = 7
    mask_pool_size: int = 16
    mask_shape: Tuple[int, int] = (32, 32)
    glm_num_classes: int = 182
    glm_input_size: int = 513
    # MSC extra scales (the base scale plus these, fused by max).
    glm_scales: Tuple[float, ...] = (0.5, 0.75)
    # TPU lowering of the trunk's dilated convs in the JAX package. Carried
    # so that one kwargs dict builds both configs; the port reads nothing
    # here (its dilated convs are cuDNN convolutions).
    glm_dilated_lowering: str = "conv"

    max_gt_instances: int = 50

    # --- bbox regression --------------------------------------------------
    rpn_bbox_std_dev: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    bbox_std_dev: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)

    # --- detection --------------------------------------------------------
    use_nms: bool = False             # reference ships USE_NMS=False
    detection_max_instances: int = 100
    detection_min_confidence: float = 0.0
    detection_nms_threshold: float = 0.3

    use_refine_head: bool = False

    # Reference quirk: at inference the GLM prior is cropped with pixel
    # coords where crop_and_resize expects normalized ones, zeroing the
    # prior for interior boxes. True = reproduce the reference.
    glm_prior_pixel_coords_at_inference: bool = True

    # Skip the frozen DeepLab forward on the detect-only path and feed
    # exact-zero prior crops to the mask head. Near-parity only: boxes that
    # touch the top/left image edge sample the prior's first row/column.
    glm_elide_at_inference: bool = False

    # --- training ---------------------------------------------------------
    batch_size: int = 1
    steps_per_epoch: int = 2500
    validation_steps: int = 100
    learning_rate: float = 0.001
    learning_momentum: float = 0.9
    weight_decay: float = 0.0001
    gradient_clip_norm: float = 5.0

    # --- compute ----------------------------------------------------------
    # The port runs float32 or float64; bfloat16 compute is not ported yet.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # TPU kernel selection in the JAX package. Carried for the shared
    # kwargs; the port reads neither: a CUDA tensor always goes to the
    # CUDA kernel and a CPU tensor to the plain PyTorch version.
    nms_impl: str = "auto"
    roi_align_impl: str = "auto"
    # GLM-prior crop lowering in the JAX package; read by nothing here.
    glm_crop_impl: str = "auto"

    # ----------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        """Occlusion-depth layer channels (reference: NUM_CLASSES - 1)."""
        return self.num_classes - 1

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.image_size, self.image_size, 3)

    @property
    def backbone_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(
            (int(math.ceil(self.image_size / s)), int(math.ceil(self.image_size / s)))
            for s in self.backbone_strides
        )

    @property
    def num_anchors(self) -> int:
        per_loc = len(self.rpn_anchor_ratios)
        return sum(
            (h // self.rpn_anchor_stride) * (w // self.rpn_anchor_stride) * per_loc
            for (h, w) in self.backbone_shapes
        )

    @property
    def mask_head_in_channels(self) -> int:
        """Mask head conv1 input channels: FPN + GLM probs + argmax channel
        (439 = 256 + 182 + 1 by default)."""
        return self.fpn_channels + self.glm_num_classes + 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
