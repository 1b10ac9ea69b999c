"""Box ops, NMS, RoIAlign, Swin's window attention and the frames' squash
resize, with their CUDA kernels.

Importing the package registers the kernels as ``torch.library`` custom ops
(:mod:`.library`), which the wrappers in :mod:`.nms_cuda`,
:mod:`.roi_align_cuda`, :mod:`.window_attention_cuda` and :mod:`.resize_cuda`
call.
"""

from . import library  # noqa: F401  (registers the sln_amodal:: ops)
