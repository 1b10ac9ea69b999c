"""Box ops, NMS and RoIAlign, with their CUDA kernels.

Importing the package registers the kernels as ``torch.library`` custom ops
(:mod:`.library`), which the wrappers in :mod:`.nms_cuda` and
:mod:`.roi_align_cuda` call.
"""

from . import library  # noqa: F401  (registers the sln_amodal:: ops)
