"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    The default is the card. Asking for CUDA where no card is present
    raises: the port never carries on silently on the CPU, which must be
    asked for with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name -> torch dtype. bfloat16 compute is not ported
    yet, so only float32 and float64 are accepted."""
    dtypes = {"float32": torch.float32, "float64": torch.float64}
    if name not in dtypes:
        raise ValueError(
            f"dtype {name!r} is not supported by the port yet "
            f"(float32 or float64)")
    return dtypes[name]
