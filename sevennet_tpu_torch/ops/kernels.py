"""Builds and loads the hand-written CUDA kernels of ``sevennet_tpu_torch/csrc``:
the fused conv (``fused_conv_fwd``, ``fused_conv_bwd``, ``pg_reduce``) and the Hopper
probes (``probe_mm``, ``probe_batched_dot``, ``probe_fma``, ``probe_gather``,
``probe_reduce``, ``probe_xpose``, ``probe_fold``, ``probe_fold_conv``,
``probe_breakdown``, ``probe_breakdown_k``, ``probe_breakdown_feat``,
``probe_knockout``, :mod:`..probes`).

Each ``*.cu`` source becomes a shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` at first use into ``build/kernels`` at
the root of the checkout, and loaded with ``ctypes``. Libraries are keyed by
a hash of their sources and flags, so an edited kernel is rebuilt. A
profile build (``profile=True``: ``-DFUSED_CONV_PROFILE``, section clocks in
every kernel, see ``csrc/fused_conv_common.cuh:Prof``) is a library of its
own, loaded only by ``conv_breakdown.py`` at the root of the checkout; the
wrappers never load it. Nothing here runs at import time: this module
imports on machines without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

__all__ = ["SOURCES", "build", "library", "call", "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_conv_fwd", "fused_conv_bwd", "pg_reduce", "probe_mm", "probe_batched_dot", "probe_fma",
           "probe_gather", "probe_reduce", "probe_xpose", "probe_fold", "probe_fold_conv",
           "probe_breakdown", "probe_breakdown_k", "probe_breakdown_feat", "probe_knockout")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

PROFILE_FLAGS = ("-DFUSED_CONV_PROFILE",)
# what a cluster launch of the fused conv returns when its cluster cannot be
# resident (csrc/fused_conv_common.cuh CLUSTER_UNSCHEDULABLE)
CLUSTER_UNSCHEDULABLE = -2

_LIBS: Dict[Tuple[str, bool, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(profile: bool, defines: Tuple[str, ...] = ()):
    return NVCC_FLAGS + (PROFILE_FLAGS if profile else ()) + tuple(f"-D{d}" for d in defines)


def _target(name: str, profile: bool = False, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(_flags(profile, defines)).encode())
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(path.read_bytes())
    tag = "".join(f"_{d.replace('=', '')}" for d in defines)
    return BUILD_DIR / f"lib{name}{'_prof' if profile else ''}{tag}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, profile: bool = False,
          defines: Tuple[str, ...] = ()) -> Dict[str, Path]:
    """Compiles every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together (``profile``: the profile
    builds instead; ``defines``: macros ``NAME=VALUE`` of a measurement
    build, a library of its own). Returns name -> library path; each
    library's ptxas report (registers, spills) is written beside it as
    ``<library>.log``. Raises on the first failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n, profile, defines) for n in names}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(profile, defines), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
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


def library(name: str, profile: bool = False, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of source ``name`` (built first if needed), or
    with ``profile`` its profile build, or with ``defines`` that
    measurement build."""
    key = (name, profile, tuple(defines))
    if key not in _LIBS:
        _LIBS[key] = ctypes.CDLL(str(build([name], profile, tuple(defines))[name]))
    return _LIBS[key]


def call(name: str, fn_name: str, *args, on_load=None) -> None:
    """Calls C entry ``fn_name`` of library ``name`` with ``args`` (ctypes
    values; the argument types are theirs, fixed at the first call) and
    raises if it returns non-zero, a launch that failed or was refused (a
    cluster that cannot be resident, ``CLUSTER_UNSCHEDULABLE``). ``on_load(lib)``
    runs before an entry's first call (a check of the library's layout)."""
    lib = library(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        if on_load is not None:
            on_load(lib)
        fn.argtypes = [type(a) for a in args]
        fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc == CLUSTER_UNSCHEDULABLE:
        raise RuntimeError(f"{fn_name}: no thread-block cluster of the launch's shape can be "
                           "resident on this device (cudaOccupancyMaxActiveClusters is 0)")
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {rc}")
