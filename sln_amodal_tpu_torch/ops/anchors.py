"""Anchor generation (host-side numpy; anchors are a constant of the config).

Same generator as the reference, including the meshgrid ordering, so that
anchor index ``i`` names the same box in both packages.
"""

from __future__ import annotations

import numpy as np


def generate_anchors(scales, ratios, shape, feature_stride, anchor_stride):
    """All anchors for one pyramid level. Returns [A, (y1, x1, y2, x2)] f32."""
    scales, ratios = np.meshgrid(np.array(scales), np.array(ratios))
    scales = scales.flatten()
    ratios = ratios.flatten()

    heights = scales / np.sqrt(ratios)
    widths = scales * np.sqrt(ratios)

    shifts_y = np.arange(0, shape[0], anchor_stride) * feature_stride
    shifts_x = np.arange(0, shape[1], anchor_stride) * feature_stride
    shifts_x, shifts_y = np.meshgrid(shifts_x, shifts_y)

    box_widths, box_centers_x = np.meshgrid(widths, shifts_x)
    box_heights, box_centers_y = np.meshgrid(heights, shifts_y)

    box_centers = np.stack([box_centers_y, box_centers_x], axis=2).reshape([-1, 2])
    box_sizes = np.stack([box_heights, box_widths], axis=2).reshape([-1, 2])

    boxes = np.concatenate(
        [box_centers - 0.5 * box_sizes, box_centers + 0.5 * box_sizes], axis=1
    )
    return boxes.astype(np.float32)


def generate_pyramid_anchors(scales, ratios, feature_shapes, feature_strides, anchor_stride):
    """Anchors across all pyramid levels, concatenated scale-major.
    Returns [N, (y1, x1, y2, x2)] float32."""
    anchors = [
        generate_anchors(scales[i], ratios, feature_shapes[i], feature_strides[i], anchor_stride)
        for i in range(len(scales))
    ]
    return np.concatenate(anchors, axis=0)


def config_anchors(config) -> np.ndarray:
    """Pyramid anchors for a :class:`sln_amodal_tpu_torch.config.Config`."""
    return generate_pyramid_anchors(
        config.rpn_anchor_scales,
        config.rpn_anchor_ratios,
        config.backbone_shapes,
        config.backbone_strides,
        config.rpn_anchor_stride,
    )
