"""The port's five kernels as ``torch.library`` custom ops.

Each op is one node to the dispatcher, to autograd and to ``torch.export``,
which traces on fake tensors that have no storage and so cannot follow a
``ctypes`` call into a kernel. The tensor's device picks the
implementation: a CUDA tensor goes to the kernel's launch (which counts it),
a CPU tensor to the plain version; any other device has none. Each op has a
fake implementation that computes only the outputs' shapes and dtypes; the
checks that read ``data_ptr()`` stay in the launches.

- ``sln_amodal::nms_sorted_batched`` — ``csrc/nms.cu`` / ``nms.nms_sorted_batched_plain``;
- ``sln_amodal::roi_align`` — ``csrc/roi_align.cu`` / ``roi_align.pyramid_roi_align_plain``,
  differentiable in the levels through
- ``sln_amodal::roi_align_backward`` — ``csrc/roi_align_backward.cu`` /
  ``roi_align.pyramid_roi_align_backward_plain``;
- ``sln_amodal::window_attention`` — ``csrc/window_attention.cu`` /
  ``window_attention.window_attention_plain`` (inference only: no backward);
- ``sln_amodal::resize_bilinear_u8`` — ``csrc/resize_bilinear.cu`` /
  ``resize.resize_bilinear_u8_plain`` (the packed frames' device picks the
  implementation; their table stays on the host).

Importing ``sln_amodal_tpu_torch.ops`` registers them (``ops/__init__.py``),
so a saved exported program that holds them loads after that import.
"""

from __future__ import annotations

from typing import List

import torch

from .nms import nms_sorted_batched_plain
from .nms_cuda import launch_nms
from .resize import resize_bilinear_u8_plain
from .resize_cuda import launch_resize_bilinear
from .roi_align import pyramid_roi_align_backward_plain, pyramid_roi_align_plain
from .roi_align_cuda import launch_roi_align, launch_roi_align_backward
from .window_attention import window_attention_plain
from .window_attention_cuda import launch_window_attention

NAMESPACE = "sln_amodal"
Tensor = torch.Tensor


# ----------------------------------------------------------------- NMS --

@torch.library.custom_op(f"{NAMESPACE}::nms_sorted_batched", mutates_args=(),
                         device_types="cpu")
def nms_sorted_batched(boxes: Tensor, valid: Tensor, max_outputs: int, iou_threshold: float,
                       suppress_at_equal: bool, pad_value: int) -> tuple[Tensor, Tensor]:
    return nms_sorted_batched_plain(boxes, valid, max_outputs, iou_threshold,
                                    suppress_at_equal, pad_value)


nms_sorted_batched.register_kernel("cuda")(launch_nms)


@nms_sorted_batched.register_fake
def _(boxes, valid, max_outputs, iou_threshold, suppress_at_equal, pad_value):
    shape = (boxes.shape[0], max_outputs)
    return (boxes.new_empty(shape, dtype=torch.int32),
            boxes.new_empty(shape, dtype=torch.bool))


# ------------------------------------------------------------ RoIAlign --

@torch.library.custom_op(f"{NAMESPACE}::roi_align", mutates_args=(), device_types="cpu")
def roi_align(features: List[Tensor], boxes: Tensor, crop_size: List[int],
              image_shape: List[int], extrapolation_value: float) -> Tensor:
    return pyramid_roi_align_plain(features, boxes, crop_size, image_shape,
                                   extrapolation_value)


roi_align.register_kernel("cuda")(launch_roi_align)


@roi_align.register_fake
def _(features, boxes, crop_size, image_shape, extrapolation_value):
    b, n = boxes.shape[:2]
    return features[0].new_empty((b, n, crop_size[0], crop_size[1], features[0].shape[-1]))


@torch.library.custom_op(f"{NAMESPACE}::roi_align_backward", mutates_args=(),
                         device_types="cpu")
def roi_align_backward(grad: Tensor, boxes: Tensor, heights: List[int], widths: List[int],
                       crop_size: List[int], image_shape: List[int],
                       dtype: torch.dtype) -> List[Tensor]:
    shapes = [(h, w, grad.shape[-1]) for h, w in zip(heights, widths)]
    return list(pyramid_roi_align_backward_plain(grad, boxes, shapes, crop_size,
                                                 image_shape, dtype))


roi_align_backward.register_kernel("cuda")(launch_roi_align_backward)


@roi_align_backward.register_fake
def _(grad, boxes, heights, widths, crop_size, image_shape, dtype):
    b, c = boxes.shape[0], grad.shape[-1]
    return [grad.new_empty((b, h, w, c), dtype=dtype) for h, w in zip(heights, widths)]


def _save_for_backward(ctx, inputs, output):
    features, boxes, crop_size, image_shape, _ = inputs
    ctx.save_for_backward(boxes)
    ctx.heights = [int(f.shape[1]) for f in features]
    ctx.widths = [int(f.shape[2]) for f in features]
    ctx.dtype = features[0].dtype
    ctx.crop_size, ctx.image_shape = list(crop_size), list(image_shape)


def _roi_align_vjp(ctx, grad):
    (boxes,) = ctx.saved_tensors
    grads = roi_align_backward(grad.contiguous(), boxes, ctx.heights, ctx.widths,
                               ctx.crop_size, ctx.image_shape, ctx.dtype)
    # the levels get their gradient; the boxes and the static arguments none
    return list(grads), None, None, None, None


roi_align.register_autograd(_roi_align_vjp, setup_context=_save_for_backward)


# ---------------------------------------------------- window attention --

@torch.library.custom_op(f"{NAMESPACE}::window_attention", mutates_args=(),
                         device_types="cpu")
def window_attention(qkv: Tensor, table: Tensor, heads: int, window: int,
                     shift: int) -> Tensor:
    return window_attention_plain(qkv, table, heads, window, shift)


window_attention.register_kernel("cuda")(launch_window_attention)


@window_attention.register_fake
def _(qkv, table, heads, window, shift):
    return qkv.new_empty((*qkv.shape[:3], qkv.shape[3] // 3))


# ------------------------------------------------------- squash resize --

@torch.library.custom_op(f"{NAMESPACE}::resize_bilinear_u8", mutates_args=(),
                         device_types="cpu")
def resize_bilinear_u8(packed: Tensor, table: Tensor, size: int) -> Tensor:
    return resize_bilinear_u8_plain(packed, table, size)


resize_bilinear_u8.register_kernel("cuda")(launch_resize_bilinear)


@resize_bilinear_u8.register_fake
def _(packed, table, size):
    return packed.new_empty((table.shape[0], size, size, 3))
