"""Transpose probes: 32 x 32 tiles through shared memory
(``csrc/probe_xpose.cu``), the counterparts of three TPU probes:

- :func:`transpose_carry`: ``scripts_dev/r2_pallas_mm.py:transpose``
  (pallas_call at ``:76``): a ``(m, n)``, s ``(1, 1)``; ``acc = 0.5 acc +
  (a (1 + s i)).T`` for i = 0 .. REP - 1 from zeros, ``(n, m)``;
- :func:`xpose`: ``scripts_dev/r5_xpose_probe.py:xpose`` (pallas_call at
  ``:96``): ``(NK, dim_x) -> (dim_x, NK)``;
- :func:`xpose2`: ``scripts_dev/r5_xpose_probe.py:xpose2`` (pallas_call at
  ``:114``): ``in.T.T``, a round trip through a transposed tile, ``(NK,
  dim_x)``.

Each takes a variant (:data:`VARIANTS`), a layout of the shared-memory
tile, both free of bank conflicts in its row writes and column reads:
``pad0``, the tile unpadded (rows 32 floats apart) with element ``(r, c)``
at column ``c ^ r`` (a 4-byte XOR swizzle), or ``pad1``, rows 33 floats
apart. The round trip at ``pad0`` is a kernel of its own
(``probe_xpose_rt_kernel``): four tiles a CTA, 16-byte global accesses
where the width and the pointers allow, and both transposes still through
shared memory. The wrappers launch the kernel on CUDA
tensors and raise on CPU tensors unless ``plain=True`` (the plain version,
on any device); each counts its launches in ``.launches`` and, per variant,
in ``.by_variant``. A transpose copies bits: :func:`xpose` and
:func:`xpose2` equal their plain versions exactly; the carried form does
the plain version's multiplies and adds in its order, within
:data:`CARRY_TOL` of max |plain|. Timing: ``diff_ms(fn, *R2_TIME)``, the
r2 script's differential of 250 and 50 calls, best of 3
(``r2_pallas_mm.py:14-29``); :func:`stream_time`, 8 calls in one graph over
8 (``r5_xpose_probe.py:64-83``)."""

from __future__ import annotations

import ctypes

import torch

from ..ops.kernels import call
from ._lib import check_device, graph_ms, stream

__all__ = ["VARIANTS", "REP", "CARRY_SHAPES", "STREAM_SHAPE", "T_B", "CARRY_TOL",
           "transpose_carry_plain", "xpose_plain", "xpose2_plain", "transpose_carry", "xpose",
           "xpose2", "xpose_work", "stream_time"]

VARIANTS = ("pad0", "pad1")
REP = 16  # the carried form's reps (csrc/probe_xpose.cu XP_REP)
CARRY_SHAPES = ((1024, 480), (1024, 960))  # r2_pallas_mm.py:138-139
# r5_xpose_probe.py:35-47, 86: N 2,560 atoms x K 64 slots, dim_x of
# 128x0e+64x1e+32x2e; the TPU streamed it in blocks of T_b = A_b K rows
T_B = 2048
STREAM_SHAPE = (2560 * 64, 480)
# the carried form against plain, of max |plain|: the same operations in the
# same order on both sides
CARRY_TOL = 1e-6
_MODES = {"xpose": 0, "round_trip": 1, "carry": 2}


class _XposeArgs(ctypes.Structure):
    """ctypes mirror of ``struct XposeArgs`` (csrc/probe_xpose.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("x", "s", "out")] + [
        (f, ctypes.c_int) for f in ("R", "C")]


def transpose_carry_plain(a, s):
    """``r2_pallas_mm.py:68-73`` in torch."""
    acc = torch.zeros(a.shape[1], a.shape[0], dtype=torch.float32, device=a.device)
    for i in range(REP):
        acc = acc * 0.5 + (a * (1.0 + s[0, 0] * float(i))).T
    return acc


def xpose_plain(x):
    """``r5_xpose_probe.py:90-91`` in torch."""
    return x.t().contiguous()


def xpose2_plain(x):
    """``r5_xpose_probe.py:111-112`` in torch: two materialized transposes."""
    return x.t().contiguous().t().contiguous()


def _check(x, s, variant: str, out, transposed: bool):
    """The output shape, after checking the inputs and ``out``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"x: a contiguous 2-d float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if s is not None and (s.dtype != torch.float32 or tuple(s.shape) != (1, 1)):
        raise ValueError(f"s: a (1, 1) float32 tensor, got {s.dtype} {tuple(s.shape)}")
    shape = (x.shape[1], x.shape[0]) if transposed else tuple(x.shape)
    if out is not None and (tuple(out.shape) != shape or out.dtype != torch.float32
                            or not out.is_contiguous()):
        raise ValueError(f"out: a contiguous float32 {shape}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    return shape


def _launch(mode: str, x, s, variant, out, out_shape):
    if out is None:
        out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    call("probe_xpose", "probe_xpose_launch", ctypes.c_int(_MODES[mode]),
         ctypes.c_int(VARIANTS.index(variant)),
         _XposeArgs(x.data_ptr(), 0 if s is None else s.data_ptr(), out.data_ptr(), x.shape[0],
                    x.shape[1]),
         stream(x.device))
    return out


def _count(fn, variant):
    fn.launches += 1
    fn.by_variant[variant] += 1


def transpose_carry(a, s, variant: str = "pad1", plain: bool = False):
    """``r2_pallas_mm.py:transpose``'s function (:func:`transpose_carry_plain`),
    ``(n, m)``. CUDA tensors: the ``probe_xpose`` kernel's carried form;
    ``plain=True``: the plain version."""
    shape = _check(a, s, variant, None, True)
    if check_device(plain, a, s):
        return transpose_carry_plain(a, s)
    out = _launch("carry", a, s, variant, None, shape)
    _count(transpose_carry, variant)
    return out


def xpose(x, variant: str = "pad1", out=None, plain: bool = False):
    """``r5_xpose_probe.py:xpose``'s function, ``(C, R)`` (into ``out`` when
    given). CUDA tensors: the ``probe_xpose`` kernel; ``plain=True``:
    :func:`xpose_plain`."""
    shape = _check(x, None, variant, out, True)
    if check_device(plain, x, *(() if out is None else (out,))):
        res = xpose_plain(x)
        return res if out is None else out.copy_(res)
    res = _launch("xpose", x, None, variant, out, shape)
    _count(xpose, variant)
    return res


def xpose2(x, variant: str = "pad1", out=None, plain: bool = False):
    """``r5_xpose_probe.py:xpose2``'s function, ``(R, C)`` (into ``out`` when
    given). CUDA tensors: the ``probe_xpose`` kernel's round trip;
    ``plain=True``: :func:`xpose2_plain`."""
    shape = _check(x, None, variant, out, False)
    if check_device(plain, x, *(() if out is None else (out,))):
        res = xpose2_plain(x)
        return res if out is None else out.copy_(res)
    res = _launch("round_trip", x, None, variant, out, shape)
    _count(xpose2, variant)
    return res


for _fn in (transpose_carry, xpose, xpose2):
    _fn.launches = 0
    _fn.by_variant = dict.fromkeys(VARIANTS, 0)


def xpose_work(n: int, carried: bool = False):
    """(flops, bytes) of one call on n elements: the carried form's multiply,
    scale and add per element and rep (the transposes none), the input read
    once, the output written once."""
    return 3 * n * REP * carried, 8 * n


def stream_time(fn, reps: int = 8) -> float:
    """Device ms per call, ``r5_xpose_probe.py:timed``: ``reps`` calls in one
    run (one CUDA graph) over ``reps``, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    return graph_ms(fn, reps) / reps
