"""Data parallelism across processes, one process per card: the port's
counterpart of the JAX package's ``parallel/multihost.py``.

The JAX package runs one process per host, and the processes form one
global mesh: each passes its local batch, ``global_batch`` assembles the
global array, and XLA inserts the gradient psum. Here the processes form a
``torch.distributed`` process group (NCCL between cards, gloo on the CPU):

1. :func:`initialize` brings the group up (before anything touches a card);
2. :func:`partition_ids` gives each process a disjoint, equally sized slice
   of the dataset, with the wrap-around of the reference's dormant
   ``DistributedSampler`` (``modal/lib/utils/data/distributed.py:34-50``);
3. each process keeps its local rows (``config.batch_size`` of them: the
   local batch, as in the JAX package's multi-host mode), and the train
   step averages what the global batch would have summed over with
   :func:`all_reduce_mean_`: the gradients after the backward, the logged
   losses, the validation losses.

One process is the common case: :func:`initialize` is then a no-op,
:func:`partition_ids` returns every id, and no collective runs.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def default_backend(device) -> str:
    """NCCL for a process on a card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(coordinator_address: str, num_processes: int, process_id: int,
               backend: str) -> None:
    """Join the process group of ``num_processes`` processes whose rank 0
    listens on ``coordinator_address`` (``host:port``), over ``backend``
    (any world size, one included). Raises if the group cannot form."""
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> None:
    """Start the process group (a no-op for a single process).

    ``device`` is this process's device: it picks the backend (NCCL for a
    card, gloo for the CPU) and, for a card, becomes the current CUDA
    device, as NCCL needs."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None:
        raise ValueError("multi-process run needs --coordinator host:port")
    if process_id is None:
        raise ValueError("multi-process run needs --process_id")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_group(coordinator_address, num_processes, process_id, default_backend(device))


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()


def is_distributed() -> bool:
    """True inside a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The process group's backend ("nccl", "gloo"), None without a group."""
    return dist.get_backend() if is_distributed() else None


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_device(process_id: int) -> torch.device:
    """The card of process ``process_id`` on its host: one process per
    card, round robin over the host's cards."""
    resolve_device("cuda")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def partition_ids(ids: Sequence[int],
                  index: Optional[int] = None,
                  count: Optional[int] = None) -> np.ndarray:
    """This process's slice of ``ids``: every process gets exactly
    ``ceil(N/count)`` ids; when ``count`` does not divide N the tail is
    padded by wrapping to the front (the DistributedSampler convention —
    equal lengths keep every process on the same step count, which lock-step
    collectives require)."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if not 0 <= index < count:
        raise ValueError(f"process index {index} not in [0, {count})")
    ids = np.asarray(ids)
    if count == 1:
        return ids
    per = math.ceil(len(ids) / count)
    total = per * count
    padded = np.concatenate([ids, ids[: total - len(ids)]])
    return padded[index * per : (index + 1) * per]


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> int:
    """Average ``tensors`` (one dtype, one device) over the process group in
    place: one flat bucket, one ``all_reduce(SUM)``, a division by the world
    size, the bucket copied back. Exact over one process (a sum of one
    value, a division by 1). Returns the bucket's bytes."""
    tensors = list(tensors)
    bucket = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM)
    bucket.div_(float(process_count()))
    offset = 0
    for t in tensors:
        t.copy_(bucket[offset: offset + t.numel()].view_as(t))
        offset += t.numel()
    return bucket.numel() * bucket.element_size()


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` on every process with process ``src``'s."""
    for t in tensors:
        dist.broadcast(t, src)


def barrier() -> None:
    """Wait for every process of the group (a no-op without one)."""
    if is_distributed():
        dist.barrier()
