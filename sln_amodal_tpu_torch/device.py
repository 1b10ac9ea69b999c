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


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name -> torch dtype: bfloat16, float32 or float64."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} is not supported by the port "
                         f"(one of {', '.join(DTYPES)})")
    return DTYPES[name]
