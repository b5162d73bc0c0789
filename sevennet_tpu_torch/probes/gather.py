"""Gather probes (``csrc/probe_gather.cu``), the counterparts of three TPU
probes:

- :func:`gather_rows`: ``out = x[idx]``, rows of an ``(N, D)`` table:
  ``scripts_dev/r3_gather_probe.py:make_take`` (pallas_call at ``:27``) at
  SevenNet-0's 9,999-atom ``x[src]`` shape (:data:`ROWS_SHAPE`), and
  ``scripts_dev/r2_pallas_caps.py:p2`` (pallas_call at ``:91``) on a
  ``(512, 480)`` table, its index ``(T, 1)``;
- :func:`gather_cols`: ``out[d, t] = tbl[d, idx[t]]``, columns of a ``(480,
  512)`` table: ``scripts_dev/r2_pallas_caps.py:p1`` (pallas_call at
  ``:55``, and its timed loop at ``:68``), its index ``(1, T)``.

Tables are float32, indices int32 of any shape (read flat), every index in
range: the wrappers check that outside CUDA-graph capture (a read of the
index on the host) and raise. ``gather_rows`` has two variants
(:data:`VARIANTS`): ``ldg``, rows read through the read-only path, and
``cp_async``, rows staged in shared memory as the conv kernels stage
``x[src]``; ``streaming`` writes the output with streaming stores. Both
wrappers take ``copies`` (independent copies of the output, for the card
rate) and an optional preallocated ``out``.

The wrappers launch the kernels on CUDA tensors and raise on CPU tensors
unless ``plain=True`` (the plain version, ``torch.index_select``, which is
also the library call); each counts its launches in ``.launches``
(``gather_rows`` also per variant in ``.by_variant``). A gather copies
bits: kernel and plain agree exactly. Timing: :func:`gather_time`, the
TPU scripts' differential method with their counts (:data:`ROWS_TIMING`,
:data:`TABLE_TIMING`); :func:`empty_launch` launches a kernel that does
nothing, the floor of p1's single call under its timing method.

:func:`cols_plan` is the column gather's launch plan: the rows a thread,
which the wrapper passes to ``probe_gather_cols_launch``, and the grid that
the launcher derives from them."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ops.kernels import call
from ._lib import check_device, diff_ms, stream

__all__ = ["VARIANTS", "ROWS_SHAPE", "TABLE_SHAPE", "ROWS_TIMING", "TABLE_TIMING",
           "gather_rows_plain", "gather_cols_plain", "gather_rows", "gather_cols",
           "gather_bytes", "gather_time", "cols_plan", "ColsPlan", "empty_launch", "N_SM"]

VARIANTS = ("ldg", "cp_async")
ROWS_SHAPE = (10016, 480, 313 * 2304)  # N, D, T (r3_gather_probe.py:17-18)
TABLE_SHAPE = (480, 512, 1024)  # DX, W, T (r2_pallas_caps.py:21-23)
ROWS_TIMING = (4, 16, 3)   # n1, n2, tries (r3_gather_probe.py:40-56)
TABLE_TIMING = (40, 240, 1)  # r2_pallas_caps.py:35-44
N_SM = 132  # SMs of an H100 SXM, the plan's default
# csrc/probe_gather.cu GC_QB, GC_RG: quads of t and row lanes of a CTA
COLS_QB, COLS_RG = 64, 4
COLS_ROWS = (4, 2, 1)  # rows a thread the kernel has instances for, most first


class _RowsArgs(ctypes.Structure):
    """ctypes mirror of ``struct RowsArgs`` (csrc/probe_gather.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("x", "idx", "out")] + [
        (f, ctypes.c_int) for f in ("N", "D", "T", "copies")]


class _ColsArgs(ctypes.Structure):
    """ctypes mirror of ``struct ColsArgs`` (csrc/probe_gather.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("tbl", "idx", "out")] + [
        (f, ctypes.c_int) for f in ("D", "W", "T", "copies", "rows")]


class ColsPlan(NamedTuple):
    """The column gather's launch: ``rows`` table rows a thread, the grid
    (quad blocks of t, row blocks, copies) of ``COLS_QB x COLS_RG``-thread
    CTAs, and ``ctas`` in all."""

    rows: int
    grid: tuple
    ctas: int


def cols_plan(d: int, t: int, copies: int = 1, n_sm: int = N_SM) -> ColsPlan:
    """The most rows a thread (4, 2, 1) whose grid still has ``n_sm`` CTAs
    or more (one thread's loads all in flight at once; more CTAs than SMs,
    so that no SM idles), else 1. A thread owns 4 consecutive t and rows
    ``y COLS_RG rows + lane + COLS_RG r``."""
    for rows in COLS_ROWS:
        grid = (-(-t // (4 * COLS_QB)), -(-d // (COLS_RG * rows)), copies)
        if grid[0] * grid[1] * grid[2] >= n_sm or rows == 1:
            return ColsPlan(rows, grid, grid[0] * grid[1] * grid[2])
    raise AssertionError("unreachable")


def gather_rows_plain(x, idx, copies: int = 1):
    """``x[idx]`` (``torch.index_select`` along rows)."""
    out = torch.index_select(x, 0, idx.reshape(-1))
    return out if copies == 1 else out.expand(copies, *out.shape).contiguous()


def gather_cols_plain(tbl, idx, copies: int = 1):
    """``tbl[:, idx]`` (``torch.index_select`` along columns)."""
    out = torch.index_select(tbl, 1, idx.reshape(-1))
    return out if copies == 1 else out.expand(copies, *out.shape).contiguous()


def _check(table, idx, out, out_shape, axis):
    if table.dtype != torch.float32 or not table.is_contiguous() or table.dim() != 2:
        raise ValueError(f"the table: a contiguous 2-d float32 tensor, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if idx.dtype != torch.int32 or not idx.is_contiguous() or idx.numel() == 0:
        raise ValueError(f"idx: contiguous int32 indices, got {idx.dtype} {tuple(idx.shape)}")
    if table.shape[1] % 4:
        raise ValueError(f"the table's rows: a multiple of 4 floats, got {tuple(table.shape)}")
    if out is not None and (tuple(out.shape) != out_shape or out.dtype != torch.float32
                            or not out.is_contiguous()):
        raise ValueError(f"out: a contiguous float32 {out_shape}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    n = table.shape[axis]
    if table.device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n:
            raise ValueError(f"idx in [0, {n}), got [{lo}, {hi}]")


def gather_rows(x, idx, variant: str = "ldg", streaming: bool = True, copies: int = 1,
                out=None, plain: bool = False):
    """``x[idx]``, ``(T, D)`` or ``(copies, T, D)``. CUDA tensors: the
    ``probe_gather_rows`` kernel's ``variant``; ``plain=True``:
    :func:`gather_rows_plain`."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    t = idx.numel()
    shape = (t, x.shape[1]) if copies == 1 else (copies, t, x.shape[1])
    _check(x, idx, out, shape, 0)
    if check_device(plain, x, idx, *(() if out is None else (out,))):
        res = gather_rows_plain(x, idx, copies)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
    call("probe_gather", "probe_gather_rows_launch", ctypes.c_int(VARIANTS.index(variant)),
         ctypes.c_int(int(streaming)),
         _RowsArgs(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], t,
                   copies),
         stream(x.device))
    gather_rows.launches += 1
    gather_rows.by_variant[variant] += 1
    return out


gather_rows.launches = 0
gather_rows.by_variant = dict.fromkeys(VARIANTS, 0)


def gather_cols(tbl, idx, copies: int = 1, out=None, plain: bool = False):
    """``tbl[:, idx]``, ``(D, T)`` or ``(copies, D, T)``. CUDA tensors: the
    ``probe_gather_cols`` kernel; ``plain=True``: :func:`gather_cols_plain`."""
    t = idx.numel()
    shape = (tbl.shape[0], t) if copies == 1 else (copies, tbl.shape[0], t)
    _check(tbl, idx, out, shape, 1)
    if check_device(plain, tbl, idx, *(() if out is None else (out,))):
        res = gather_cols_plain(tbl, idx, copies)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=tbl.device)
    plan = cols_plan(tbl.shape[0], t, copies,
                     torch.cuda.get_device_properties(tbl.device).multi_processor_count)
    call("probe_gather", "probe_gather_cols_launch",
         _ColsArgs(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), tbl.shape[0], tbl.shape[1], t,
                   copies, plan.rows),
         stream(tbl.device))
    gather_cols.launches += 1
    return out


gather_cols.launches = 0


def gather_bytes(table, idx, axis: int, copies: int = 1) -> int:
    """Bytes of one call gathering along ``axis`` (0 rows, 1 columns): the
    table and the indices read once, the ``copies`` outputs written once (a
    table entry is read once however often it is gathered)."""
    n_out = idx.numel() * table.shape[1 - axis]
    return 4 * (table.numel() + idx.numel() + copies * n_out)


def empty_launch(dev) -> None:
    """Launches ``probe_empty_kernel`` (one CTA of one warp, no work) on
    ``dev``'s current stream: a measurement of the launch alone, on no
    path."""
    call("probe_gather", "probe_empty_launch", stream(dev))


def gather_time(fn, timing=ROWS_TIMING) -> float:
    """Device ms per call of ``fn``: ``_lib.diff_ms`` with ``timing`` = (n1,
    n2, tries), :data:`ROWS_TIMING` or :data:`TABLE_TIMING`."""
    return diff_ms(fn, *timing)
