"""The devices a batch is split over: the port's counterpart of the JAX
package's ``parallel/mesh.py``.

JAX builds a 1-D ``('data',)`` mesh, shards the batch over it batch-first
and lets XLA place each device's part. Here a mesh is a tuple of
``torch.device``s: a batch is cut into contiguous row blocks, one per entry,
and the caller runs each block on its entry's device (``infer.Detector``
holds one replica of the model per device). Training is data-parallel
across processes instead, one process per card (``parallel/multihost.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device

Mesh = Tuple[torch.device, ...]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The mesh over ``devices``, by default every local CUDA device;
    raises where there is none (pass ``devices`` to run on the CPU)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(resolve_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_batch(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[Tuple[torch.Tensor, ...]]:
    """Batch-first tensors as one part per mesh entry, each on its entry's
    device: contiguous row blocks, as the JAX ``batch_sharding`` splits
    ([(block of each tensor), ...]). The rows must split evenly."""
    rows, n = tensors[0].shape[0], len(mesh)
    if rows % n:
        raise ValueError(f"{rows} rows do not split evenly over {n} devices")
    per = rows // n
    return [tuple(t[i * per:(i + 1) * per].to(dev) for t in tensors)
            for i, dev in enumerate(mesh)]
