"""Native host code: the C++ cell-list neighbour list (``nl.cpp``, the
port's copy of ``sevennet_tpu/native/nl.cpp``), compiled by ``g++`` at first
use into ``build/native`` at the root of the checkout and bound with
``ctypes``.

Unlike the JAX package, which falls back to its numpy path when the build
fails, a failed build raises here: :func:`native_neighbor_list` either runs
the native list or says why it cannot. It returns ``None`` only for a system
the cell list does not take (a periodic height under the cutoff, which
needs more than one image; ``nl.cpp`` returns -1), which the caller lists
with scipy. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["native_neighbor_list", "BUILD_DIR", "library"]

SOURCE = Path(__file__).resolve().parent / "nl.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None


def _build() -> Path:
    """Compiles ``nl.cpp`` unless this source with these flags is built
    already (the library's name carries their hash); raises on failure."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libnl_{h}.so"
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native neighbour list cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded neighbour-list library (built first if needed)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build()))
        P = ctypes.POINTER
        lib.nl_build.restype = ctypes.c_int64
        lib.nl_build.argtypes = [P(ctypes.c_double), ctypes.c_int64, P(ctypes.c_double),
                                 P(ctypes.c_int), ctypes.c_double]
        lib.nl_dst_ptr.restype = P(ctypes.c_int64)
        lib.nl_src_ptr.restype = P(ctypes.c_int64)
        lib.nl_shift_ptr.restype = P(ctypes.c_double)
        lib.nl_release.restype = None
        _LIB = lib
    return _LIB


def native_neighbor_list(positions: np.ndarray, cutoff: float, cell: np.ndarray,
                         pbc) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The C++ cell list's full neighbour list ``(dst, src, shifts)`` with
    matscipy ``ijDS`` semantics, the edges receiver by receiver (``dst``
    sorted), or None where the cell list does not take the system (a
    periodic height under the cutoff). The library owns its result until
    its next call, so the arrays are copied out before this returns."""
    lib = library()
    pos = np.ascontiguousarray(positions, np.float64)
    cellm = np.ascontiguousarray(cell, np.float64).reshape(9)
    pbc_arr = np.ascontiguousarray([int(bool(b)) for b in pbc], np.int32)
    P = ctypes.POINTER
    total = lib.nl_build(pos.ctypes.data_as(P(ctypes.c_double)), ctypes.c_int64(len(pos)),
                         cellm.ctypes.data_as(P(ctypes.c_double)),
                         pbc_arr.ctypes.data_as(P(ctypes.c_int)), ctypes.c_double(float(cutoff)))
    if total < 0:
        return None
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros((0, 3), np.float64)
    dst = np.ctypeslib.as_array(lib.nl_dst_ptr(), shape=(total,)).copy()
    src = np.ctypeslib.as_array(lib.nl_src_ptr(), shape=(total,)).copy()
    shift = np.ctypeslib.as_array(lib.nl_shift_ptr(), shape=(total, 3)).copy()
    lib.nl_release()
    return dst, src, shift
