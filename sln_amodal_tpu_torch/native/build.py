"""Builds the port's native RLE library (``rle.cpp``) at first use and binds it.

The source is compiled with the host C++ compiler (``$CXX``, else ``g++``)
into ``build/native/`` at the root of the checkout, under a name keyed by a
hash of the source and the flags, so an edited source is never served by a
stale library. A missing compiler, a failed build or a missing symbol
raises: the RLE code has no silent numpy fallback on its main path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

SOURCE = Path(__file__).resolve().parent / "rle.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}


def compiler() -> str:
    """Path of the C++ compiler; raises if there is none."""
    name = os.environ.get("CXX", "g++")
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"C++ compiler {name!r} not found: the native RLE library "
            f"({SOURCE.name}) cannot be built (set CXX to a C++17 compiler)")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librle-{digest}.so"


def build() -> Path:
    """Compile ``rle.cpp`` unless its library is built; returns the path.

    The compiler writes a temporary file that is renamed into place, so
    processes building at once never load a half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([compiler(), *CXX_FLAGS, str(SOURCE), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The built and bound RLE library (built on the first call)."""
    with _lock:
        path = library_path()
        lib = _loaded.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(build()))
            try:
                _bind(lib)
            except AttributeError as e:
                raise RuntimeError(f"{path} lacks a symbol of {SOURCE.name}: {e}") from e
            _loaded[path] = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    """Declare restype/argtypes for every exported symbol."""
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    dp = ctypes.POINTER(ctypes.c_double)
    i = ctypes.c_int

    lib.sln_rle_encode.restype = i
    lib.sln_rle_encode.argtypes = [u8p, i, i, u32p]
    lib.sln_rle_encode_pasted.restype = i
    lib.sln_rle_encode_pasted.argtypes = [u8p] + [i] * 6 + [u32p]
    lib.sln_rle_decode.restype = None
    lib.sln_rle_decode.argtypes = [u32p, i, u8p, ctypes.c_long]
    lib.sln_rle_area.restype = ctypes.c_long
    lib.sln_rle_area.argtypes = [u32p, i]
    lib.sln_rle_merge.restype = i
    lib.sln_rle_merge.argtypes = [u32p, i32p, i, i, u32p]
    lib.sln_rle_to_bbox.restype = None
    lib.sln_rle_to_bbox.argtypes = [u32p, i32p, i, i, dp]
    lib.sln_bb_iou.restype = None
    lib.sln_bb_iou.argtypes = [dp, dp, i, i, u8p, dp]
    lib.sln_rle_iou.restype = None
    lib.sln_rle_iou.argtypes = [u32p, i32p, i, u32p, i32p, i, i, u8p, dp]
    lib.sln_rle_nms.restype = None
    lib.sln_rle_nms.argtypes = [u32p, i32p, i, i, ctypes.c_double, u8p]
    lib.sln_rle_from_poly.restype = i
    lib.sln_rle_from_poly.argtypes = [dp, i, i, i, u32p, i]
    lib.sln_rle_to_string.restype = i
    lib.sln_rle_to_string.argtypes = [u32p, i, ctypes.c_char_p]
    lib.sln_rle_from_string.restype = i
    lib.sln_rle_from_string.argtypes = [ctypes.c_char_p, u32p]
