"""Builds and loads the hand-written CUDA kernels of ``sevennet_tpu_torch/csrc``.

Each ``*.cu`` source becomes a shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` at first use into ``build/kernels`` at
the root of the checkout, and loaded with ``ctypes``. Libraries are keyed by
a hash of their sources and flags, so an edited kernel is rebuilt. Nothing
here runs at import time: this module imports on machines without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build", "library", "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_conv_fwd", "fused_conv_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compiles every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns name -> library path;
    each library's ptxas report (registers, spills) is written beside it as
    ``<library>.log``. Raises on the first failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        so = targets[name]
        Path(str(so) + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name`` (built first if needed)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return _LIBS[name]
