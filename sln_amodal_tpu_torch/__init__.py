"""PyTorch/CUDA port of SLN-Amodal.

A second package beside the JAX reference (``sln_amodal_tpu``): the same
inference graph written with ``torch`` modules, with the two TPU kernels of
the reference (greedy NMS and FPN RoIAlign) replaced by CUDA kernels for
Hopper (``csrc/``). It imports nothing from the JAX package.
"""

from .config import Config

__all__ = ["Config"]
