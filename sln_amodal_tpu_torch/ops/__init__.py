"""Box ops, NMS, RoIAlign and Swin's window attention, with their CUDA kernels.

Importing the package registers the kernels as ``torch.library`` custom ops
(:mod:`.library`), which the wrappers in :mod:`.nms_cuda`,
:mod:`.roi_align_cuda` and :mod:`.window_attention_cuda` call.
"""

from . import library  # noqa: F401  (registers the sln_amodal:: ops)
