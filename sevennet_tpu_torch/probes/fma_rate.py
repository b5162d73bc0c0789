"""FMA-rate probes: fp32 multiply-add chains on the CUDA cores
(``csrc/probe_fma.cu``), the counterparts of three TPU probes:

- :func:`fma_chain`: ``scripts_dev/r2_pallas_fma.py:fma`` (pallas_call at
  ``:72``): REP reps, each ``xi = x + acc``, then ``acc += xi * t[r % 8]``
  for r < R, then ``acc *= 1e-8``;
- :func:`fma_pass`: ``scripts_dev/r2_pallas_caps.py:fma_probe``
  (pallas_call at ``:127``): one pass from 0, ``acc += x * t[r % 8]``;
- :func:`vpu_chain`: ``scripts_dev/r4_vpu_roofline.py:kernel`` (pallas_call
  at ``:28``): elementwise, ``acc += a * b; a += 1e-9``, 64 times.

The first two take a layout (:data:`LAYOUTS`): ``feat``, x and the output
``(mul, T)``, t ``(8, T)``, each element (m, j) taking t of its column j;
``edge``, x and the output ``(T, mul)``, t ``(T, 8)``, each element (j, m)
taking t of its row j. The output is float32, or ``(copies, ...)`` for
``copies`` independent copies of the function (the card rate needs more
threads than one copy at mul 32 gives).

The wrappers launch the kernels on CUDA tensors and raise on CPU tensors
unless ``plain=True`` (the plain version, the same operations in the same
order as torch ops, on any device); each counts its launches in
``.launches`` and, per layout, in ``.by_layout``. The kernels contract
``acc + xi * t`` into one FFMA, the plain versions round the product first:
they agree within :data:`TOL` of max |plain|. Timing (``_lib.diff_ms``,
``_lib.graph_ms``): :func:`fma_time` the differential of 250 and 50 calls,
best of 3 (``r2_pallas_fma.py:19-34``); the one pass 240 against 40 calls,
one try (``r2_pallas_caps.py:35-44``); :func:`vpu_time` 8 calls in one
graph over 8 (``r4_vpu_roofline.py:44-57``)."""

from __future__ import annotations

import ctypes

import torch

from ..ops.kernels import call
from ._lib import check_device, diff_ms, graph_ms, stream

__all__ = ["LAYOUTS", "R", "REP", "T", "CHAIN_MULS", "PASS_MUL", "VPU_SHAPE", "VPU_ITERS", "TOL",
           "fma_shapes", "fma_chain_plain", "fma_pass_plain", "vpu_chain_plain", "fma_chain",
           "fma_pass", "vpu_chain", "fma_flops", "fma_bytes", "vpu_work", "fma_time",
           "pass_time", "vpu_time"]

LAYOUTS = ("feat", "edge")
R = 133          # steps of a chain (r2_pallas_fma.py:45, r2_pallas_caps.py:104)
REP = 16         # carried reps (r2_pallas_fma.py:16)
T = 1024         # edges of a block (r2_pallas_fma.py:15, r2_pallas_caps.py:22)
CHAIN_MULS = (128, 64, 32)  # r2_pallas_fma.py:138-143's report lines
PASS_MUL = 64    # r2_pallas_caps.py:104
VPU_SHAPE = (8192, 2304)    # r4_vpu_roofline.py: a grid of 64 blocks of (128, 2304)
VPU_ITERS = 64
VPU_EPS = 1e-9
SCALE = 1e-8     # the carried chain's scale after each rep
# kernel against plain, of max |plain|: fp32 on both sides, the kernel's
# FFMA rounds once where the plain version rounds the product and the sum
TOL = 1e-5
E = 4            # consecutive elements a thread owns (csrc/probe_fma.cu FMA_E)


class _FmaArgs(ctypes.Structure):
    """ctypes mirror of ``struct FmaArgs`` (csrc/probe_fma.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("x", "t", "out")] + [
        (f, ctypes.c_int) for f in ("mul", "T", "rep", "copies")]


def fma_shapes(layout: str, mul: int, t: int = T):
    """(x shape, t shape) of a layout."""
    return ((mul, t), (8, t)) if layout == "feat" else ((t, mul), (t, 8))


def _t_rows(t, layout: str):
    """The 8 t operands as a list of tensors broadcasting against x."""
    return [t[r][None, :] for r in range(8)] if layout == "feat" else \
        [t[:, r][:, None] for r in range(8)]


def fma_chain_plain(x, t, layout: str, rep: int = REP, copies: int = 1):
    """``r2_pallas_fma.py:48-70`` in torch: REP reps of ``xi = x + acc``, R
    steps ``acc = acc + xi * t[r % 8]``, ``acc = acc * 1e-8``."""
    tr = _t_rows(t, layout)
    acc = torch.zeros_like(x)
    for _ in range(rep):
        xi = x + acc
        for s in range(R):
            acc = acc + xi * tr[s % 8]
        acc = acc * SCALE
    return acc if copies == 1 else acc.expand(copies, *acc.shape).contiguous()


def fma_pass_plain(x, t, layout: str, copies: int = 1):
    """``r2_pallas_caps.py:107-123`` in torch: ``acc = acc + x * t[r % 8]``
    from zero, R steps."""
    tr = _t_rows(t, layout)
    acc = torch.zeros_like(x)
    for s in range(R):
        acc = acc + x * tr[s % 8]
    return acc if copies == 1 else acc.expand(copies, *acc.shape).contiguous()


def vpu_chain_plain(a, b):
    """``r4_vpu_roofline.py:18-25`` in torch: ``acc = acc + a * b; a = a +
    1e-9``, 64 times."""
    acc = torch.zeros_like(a)
    for _ in range(VPU_ITERS):
        acc = acc + a * b
        a = a + VPU_EPS
    return acc


def _check_f32(**tensors):
    for name, v in tensors.items():
        if v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"{name}: contiguous float32, got {v.dtype}")


def _check_fma(x, t, layout):
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    _check_f32(x=x, t=t)
    if x.dim() != 2:
        raise ValueError(f"x: 2-d, got {tuple(x.shape)}")
    mul, tt = (x.shape[0], x.shape[1]) if layout == "feat" else (x.shape[1], x.shape[0])
    want_t = fma_shapes(layout, mul, tt)[1]
    if tuple(t.shape) != want_t:
        raise ValueError(f"{layout}-major x {tuple(x.shape)} takes t {want_t}, "
                         f"got {tuple(t.shape)}")
    if (tt if layout == "feat" else mul) % E:
        raise ValueError(f"the {layout}-major kernel takes a contiguous dimension that is a "
                         f"multiple of {E}, got x {tuple(x.shape)}")
    return mul, tt


def _launch_fma(x, t, layout, mul, tt, rep, carry, copies):
    out = torch.empty((copies, *x.shape), dtype=torch.float32, device=x.device)
    call("probe_fma", "probe_fma_launch", ctypes.c_int(LAYOUTS.index(layout)),
         ctypes.c_int(int(carry)),
         _FmaArgs(x.data_ptr(), t.data_ptr(), out.data_ptr(), mul, tt, rep, copies),
         stream(x.device))
    return out[0] if copies == 1 else out


def fma_chain(x, t, layout: str = "feat", rep: int = REP, copies: int = 1, plain: bool = False):
    """``r2_pallas_fma.py:fma``'s function (:func:`fma_chain_plain`). CUDA
    tensors: the ``probe_fma`` kernel with the carry; ``plain=True``: the
    plain version."""
    mul, tt = _check_fma(x, t, layout)
    if check_device(plain, x, t):
        return fma_chain_plain(x, t, layout, rep, copies=copies)
    out = _launch_fma(x, t, layout, mul, tt, rep, True, copies)
    fma_chain.launches += 1
    fma_chain.by_layout[layout] += 1
    return out


fma_chain.launches = 0
fma_chain.by_layout = dict.fromkeys(LAYOUTS, 0)


def fma_pass(x, t, layout: str = "feat", copies: int = 1, plain: bool = False):
    """``r2_pallas_caps.py:fma_probe``'s function (:func:`fma_pass_plain`).
    CUDA tensors: the ``probe_fma`` kernel in one pass; ``plain=True``: the
    plain version."""
    mul, tt = _check_fma(x, t, layout)
    if check_device(plain, x, t):
        return fma_pass_plain(x, t, layout, copies=copies)
    out = _launch_fma(x, t, layout, mul, tt, 1, False, copies)
    fma_pass.launches += 1
    fma_pass.by_layout[layout] += 1
    return out


fma_pass.launches = 0
fma_pass.by_layout = dict.fromkeys(LAYOUTS, 0)


def vpu_chain(a, b, plain: bool = False):
    """``r4_vpu_roofline.py:kernel``'s function (:func:`vpu_chain_plain`),
    elementwise on a and b of one shape. CUDA tensors: the ``probe_vpu``
    kernel; ``plain=True``: the plain version."""
    _check_f32(a=a, b=b)
    if a.shape != b.shape or a.numel() % 4:
        raise ValueError(f"a and b of one shape, a multiple of 4 elements; got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if check_device(plain, a, b):
        return vpu_chain_plain(a, b)
    out = torch.empty_like(a)
    call("probe_fma", "probe_vpu_launch", ctypes.c_void_p(a.data_ptr()),
         ctypes.c_void_p(b.data_ptr()), ctypes.c_void_p(out.data_ptr()),
         ctypes.c_longlong(a.numel()), stream(a.device))
    vpu_chain.launches += 1
    return out


vpu_chain.launches = 0


def fma_flops(mul: int, rep: int = 1, copies: int = 1) -> int:
    """Operations of one call: 2 a step (a multiply and an add), as the TPU
    scripts count them (``r2_pallas_fma.py:80``, ``r2_pallas_caps.py:142``);
    ``rep=1`` for the one pass. The carry's adds and scales are left out."""
    return 2 * mul * T * R * rep * copies


def fma_bytes(mul: int) -> int:
    """Bytes of one call: x and t read once, the output written once."""
    return 4 * (2 * mul * T + 8 * T)


def vpu_work(n: int):
    """(flop slots, bytes) of one call on n elements: per element and
    iteration one FFMA and one FADD, each an issue slot of the fp32 pipes
    that a peak FLOP/s rate counts as 2 operations (so 4 per iteration; the
    TPU script counts 3 VPU ops, ``r4_vpu_roofline.py:56``); a, b read and
    the output written once."""
    return 4 * n * VPU_ITERS, 3 * 4 * n


def fma_time(fn, n1: int = 50, n2: int = 250, tries: int = 3) -> float:
    """Device ms per call, ``r2_pallas_fma.py:difftime``'s method."""
    return diff_ms(fn, n1, n2, tries)


def pass_time(fn, n1: int = 40, n2: int = 240, tries: int = 1) -> float:
    """Device ms per call, ``r2_pallas_caps.py:difftime``'s method."""
    return diff_ms(fn, n1, n2, tries)


def vpu_time(fn, reps: int = 8) -> float:
    """Device ms per call, ``r4_vpu_roofline.py:timed``'s method: ``reps``
    calls in one run (one CUDA graph) over ``reps``, after a warm-up run."""
    fn()
    torch.cuda.synchronize()
    return graph_ms(fn, reps) / reps
