"""K-reduction probes: sums over K consecutive rows or columns, carried REP
times (``csrc/probe_reduce.cu``), the counterparts of three TPU probes:

- :func:`kreduce`: ``scripts_dev/r2_pallas_fma.py:kreduce`` (pallas_call at
  ``:94``): x ``(A K, mul)``; REP reps of ``xi = x + acc[0, 0]``, ``acc =
  acc + xi.reshape(A, K, mul).sum(1) * 1e-8`` from zeros, ``(A, mul)``;
- :func:`subreduce`: ``scripts_dev/r2_pallas_mm.py:subreduce`` (pallas_call
  at ``:120``): a ``(A K, mul)``, s ``(1, 1)``; ``acc = 0.5 acc + (a (1 + s
  i)).reshape(A, K, mul).sum(1)`` for i = 0 .. REP - 1, ``(A, mul)``;
- :func:`lanereduce`: ``scripts_dev/r2_pallas_mm.py:lanereduce``
  (pallas_call at ``:98``): the same over K consecutive columns of a
  ``(rows, A K)``, ``(rows, A)``.

The wrappers launch the kernels on CUDA tensors and raise on CPU tensors
unless ``plain=True`` (the plain version, the same operations as torch ops,
on any device); each counts its launches in ``.launches``. Kernel and plain
sum in another order (the kernel's is in its source): they agree within
:data:`TOL` of max |plain|. Timing: ``diff_ms(fn, *R2_TIME)``, the
scripts' differential of 250 and 50 calls, best of 3
(``r2_pallas_mm.py:14-29``, ``r2_pallas_fma.py:19-34``)."""

from __future__ import annotations

import ctypes

import torch

from ..ops.kernels import call
from ._lib import check_device, stream

__all__ = ["REP", "A", "T", "LANE_K", "KREDUCE_MULS", "SUB_MULS", "LANE_ROWS", "TOL",
           "kreduce_plain", "subreduce_plain", "lanereduce_plain", "kreduce", "subreduce",
           "lanereduce", "reduce_work"]

REP = 16         # reps of a call (csrc/probe_reduce.cu RD_REP)
A = 8            # groups (r2_pallas_fma.py:84, r2_pallas_mm.py:87, 109)
T = 1024         # rows of the row reductions (r2_pallas_fma.py:15, r2_pallas_mm.py:109)
LANE_K = 128     # r2_pallas_mm.py:87
KREDUCE_MULS = (128, 3136)  # r2_pallas_fma.py:133-134
SUB_MULS = (128, 960)       # r2_pallas_mm.py:142-143
LANE_ROWS = (128, 960)      # r2_pallas_mm.py:140-141
SCALE = 1e-8     # kreduce's scale of a rep's sum
# kernel against plain, of max |plain|: fp32 on both sides, sums of K terms
# in another order
TOL = 1e-5
KMAX = 128       # rows a kernel thread holds (csrc/probe_reduce.cu RD_KMAX)
LANE_KMAX = 128  # 32 lanes x RD_LMAX


class _ReduceArgs(ctypes.Structure):
    """ctypes mirror of ``struct ReduceArgs`` (csrc/probe_reduce.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("x", "s", "out")] + [
        (f, ctypes.c_int) for f in ("A", "K", "mul", "rows")]


def _factor(s, i: int):
    """``1 + s i`` in float32, as the scripts form it (s times i first)."""
    return 1.0 + s[0, 0] * float(i)


def kreduce_plain(x):
    """``r2_pallas_fma.py:86-92`` in torch."""
    k, mul = x.shape[0] // A, x.shape[1]
    acc = torch.zeros(A, mul, dtype=torch.float32, device=x.device)
    for _ in range(REP):
        xi = x + acc[0, 0]
        acc = acc + xi.reshape(A, k, mul).sum(1) * SCALE
    return acc


def subreduce_plain(x, s):
    """``r2_pallas_mm.py:112-117`` in torch."""
    k, mul = x.shape[0] // A, x.shape[1]
    acc = torch.zeros(A, mul, dtype=torch.float32, device=x.device)
    for i in range(REP):
        acc = acc * 0.5 + (x * _factor(s, i)).reshape(A, k, mul).sum(1)
    return acc


def lanereduce_plain(x, s):
    """``r2_pallas_mm.py:90-95`` in torch."""
    rows, k = x.shape[0], x.shape[1] // A
    acc = torch.zeros(rows, A, dtype=torch.float32, device=x.device)
    for i in range(REP):
        acc = acc * 0.5 + (x * _factor(s, i)).reshape(rows, A, k).sum(2)
    return acc


def _check(x, s, axis: str):
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 2:
        raise ValueError(f"x: a contiguous 2-d float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if s is not None and (s.dtype != torch.float32 or tuple(s.shape) != (1, 1)):
        raise ValueError(f"s: a (1, 1) float32 tensor, got {s.dtype} {tuple(s.shape)}")
    n = x.shape[0] if axis == "rows" else x.shape[1]
    if n % A or n == 0:
        raise ValueError(f"the {axis} of x {tuple(x.shape)} do not split into {A} groups")
    k = n // A
    if axis == "rows" and k > KMAX:
        raise ValueError(f"the row kernel sums at most {KMAX} rows a group, got K {k}")
    if axis == "lanes" and not (32 % k == 0 if k < 32 else k % 32 == 0 and k <= LANE_KMAX):
        raise ValueError(f"the lane kernel sums K a power of two below 32 or a multiple of 32 "
                         f"up to {LANE_KMAX} columns, got K {k}")
    return k


def _launch(axis: int, carry: int, x, s, k, shape):
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    mul = x.shape[1] if axis == 0 else 0
    rows = x.shape[0] if axis == 1 else 0
    call("probe_reduce", "probe_reduce_launch", ctypes.c_int(axis), ctypes.c_int(carry),
         _ReduceArgs(x.data_ptr(), 0 if s is None else s.data_ptr(), out.data_ptr(), A, k, mul,
                     rows),
         stream(x.device))
    return out


def kreduce(x, plain: bool = False):
    """``r2_pallas_fma.py:kreduce``'s function (:func:`kreduce_plain`),
    ``(A, mul)``. CUDA tensors: the ``probe_reduce`` row kernel with
    kreduce's carry; ``plain=True``: the plain version."""
    k = _check(x, None, "rows")
    if check_device(plain, x):
        return kreduce_plain(x)
    out = _launch(0, 0, x, None, k, (A, x.shape[1]))
    kreduce.launches += 1
    return out


kreduce.launches = 0


def subreduce(x, s, plain: bool = False):
    """``r2_pallas_mm.py:subreduce``'s function (:func:`subreduce_plain`),
    ``(A, mul)``. CUDA tensors: the ``probe_reduce`` row kernel with the
    scaled carry; ``plain=True``: the plain version."""
    k = _check(x, s, "rows")
    if check_device(plain, x, s):
        return subreduce_plain(x, s)
    out = _launch(0, 1, x, s, k, (A, x.shape[1]))
    subreduce.launches += 1
    return out


subreduce.launches = 0


def lanereduce(x, s, plain: bool = False):
    """``r2_pallas_mm.py:lanereduce``'s function (:func:`lanereduce_plain`),
    ``(rows, A)``. CUDA tensors: the ``probe_reduce`` lane kernel;
    ``plain=True``: the plain version."""
    k = _check(x, s, "lanes")
    if check_device(plain, x, s):
        return lanereduce_plain(x, s)
    out = _launch(1, 1, x, s, k, (x.shape[0], A))
    lanereduce.launches += 1
    return out


lanereduce.launches = 0


def reduce_work(n_in: int, n_out: int):
    """(flops, bytes) of one call of any of the three on ``n_in`` inputs and
    ``n_out`` outputs: per rep an add (kreduce's ``x + c``) or a multiply
    (``a (1 + s i)``) and an add of the sum for each input, a multiply and an
    add for each output (the carry); the input read once, the output written
    once."""
    return REP * (2 * n_in + 2 * n_out), 4 * (n_in + n_out)
