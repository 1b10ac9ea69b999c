"""Logging helpers of the CLIs: messages with array stats, a progress bar,
the parameter count of a state_dict (the reference's ad-hoc prints,
``modal/Functions.py:17-48``, ``modal/networks.py:80-85``) and a step timer
for the training loop."""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Mapping, Optional

import numpy as np


def log(text: str, array: Optional[np.ndarray] = None) -> None:
    """Print a message, optionally with array shape/min/max stats."""
    if array is not None:
        array = np.asarray(array)
        text = text.ljust(25)
        if array.size:
            text += "shape: {:20}  min: {:10.5f}  max: {:10.5f}".format(
                str(array.shape), float(array.min()), float(array.max()))
        else:
            text += f"shape: {array.shape}  (empty)"
    print(text)


def progress_bar(iteration: int, total: int, prefix: str = "", suffix: str = "",
                 length: int = 50, fill: str = "|") -> None:
    """Terminal progress bar."""
    frac = iteration / float(max(total, 1))
    filled = int(length * iteration // max(total, 1))
    bar = fill * filled + "-" * (length - filled)
    sys.stdout.write(f"\r{prefix} |{bar}| {100 * frac:.1f}% {suffix}")
    if iteration >= total:
        sys.stdout.write("\n")
    sys.stdout.flush()


def count_params(state_dict: Mapping) -> int:
    """Total number of values in a state_dict's tensors."""
    return sum(int(np.prod(tuple(v.shape))) for v in state_dict.values())


def print_network(state_dict: Mapping, name: str = "model") -> int:
    n = count_params(state_dict)
    print(f"{name}: total number of parameters: {n}")
    return n


class StepTimer:
    """Host seconds between successive ``tick`` calls of a loop."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.history: List[float] = []

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        self.history.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.history:
            return {}
        arr = np.asarray(self.history)
        return {"steps": len(arr), "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95))}
