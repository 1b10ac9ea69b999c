"""Builds the port's CUDA kernels with ``nvcc`` at first use and binds them.

Each source under ``csrc/`` is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with ``ctypes``. Libraries are cached under ``build/kernels/`` at the root of
the checkout, keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is never
served by a stale library.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# -fmad=false: no multiply-add contraction anywhere, so the kernels' float
# arithmetic matches the plain PyTorch versions op for op (the sources also
# spell the rounding of each operation with __fadd_rn/__fmul_rn). Never
# --use_fast_math: NMS keeps near the IoU threshold depend on IEEE division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME to the CUDA toolkit)")
    return found


class CudaKernel:
    """One ``csrc/*.cu`` source: its shared library, its C entry points and
    the launch count of the wrapper that calls it.

    ``functions`` maps each C entry point to its ctypes argument types; each
    returns the ``cudaError_t`` of its launch as an int."""

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = SOURCE_DIR / source
        self.functions = dict(functions)
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fns = {}
        self._lock = threading.Lock()

    @property
    def library_path(self) -> Path:
        headers = b"".join(p.read_bytes() for p in sorted(SOURCE_DIR.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def start_build(self):
        """Start nvcc for this source unless its library is built; returns
        (process, temporary output path) or None."""
        out = self.library_path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{log}")
        os.replace(tmp, self.library_path)

    def launch(self, name: str, device, *args) -> None:
        """Call C entry point ``name`` with ``args`` and, last, the current
        stream of CUDA ``device``; raise if its launch failed."""
        import torch

        fn = self._fns.get(name)
        if fn is None:
            fn = self._fns[name] = getattr(self.lib(), name)
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        with contextlib.nullcontext() if index == current else torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            raise RuntimeError(
                f"{self.source.name}:{name} launch failed with cudaError {err}")

    def lib(self):
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.library_path))
                for fn, argtypes in self.functions.items():
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = ctypes.c_int
                self._lib = lib
            return self._lib


def build_all(kernels: Iterable[CudaKernel]) -> Tuple[float, Dict[str, str]]:
    """Build every kernel's library at once (one nvcc per source, all
    started together) and load them. Returns (wall seconds, build logs)."""
    kernels = list(kernels)
    t0 = time.perf_counter()
    started = [k.start_build() for k in kernels]
    for k, s in zip(kernels, started):
        k.finish_build(s)
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0, {k.source.name: k.build_log for k in kernels}


VOIDP = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
DOUBLE = ctypes.c_double
