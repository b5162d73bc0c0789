"""Matmul-rate probes: ``acc = 0.5 acc + a_i @ b``, REP times in one kernel
(``csrc/probe_mm.cu``), the counterparts of two TPU probes:

- :func:`mm_rate`: ``scripts_dev/r2_pallas_mm.py:mm`` (pallas_call at
  ``:54``), ``a_i = a (1 + s i)``: the rate of independent products;
- :func:`mm_chain`: ``scripts_dev/r2_pallas_fma.py:mm`` (pallas_call at
  ``:115``), ``a_i = a + acc[0, 0] 1e-20``: each product waits on the
  last, the latency of a dependent chain.

``a (m, k)`` and ``b (k, n)`` are float32 (bfloat16 for the ``bf16``
variant), ``s`` a ``(1, 1)`` float32 scalar; the output is ``(m, n)``
float32, or ``(copies, m, n)`` for ``copies`` independent copies (into ``out`` when
given). The variants (:data:`VARIANTS`) run the product as the conv kernels
do or might: fp32 on the CUDA cores, one TF32 pass, 3xTF32 with A split
for every product or split once (both on ``wgmma`` with A from registers),
``wgmma`` from shared memory, bf16; every variant on one or two warpgroups
a CTA by :func:`mm_plan`, a CTA a tile and copy.

The wrappers launch the kernel on CUDA tensors and raise on CPU tensors
unless ``plain=True`` (the plain version, on any device); each counts its
launches in ``.launches`` and, per variant, in ``.by_variant``. :func:`mm_time`
times a call the TPU script's way (``r2_pallas_mm.py:14-29``): the
difference of 250 and 50 back-to-back calls over 200, best of 3, which
removes the fixed cost; the calls are captured in a CUDA graph and its
replay timed by CUDA events, so that the host's cost per call is not in
the time either. :data:`PROBE_TOL` holds the limits of each variant
against the plain version."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..ops.kernels import call
from ._lib import check_device, diff_ms, stream

__all__ = ["VARIANTS", "PROBE_TOL", "REP", "MM_SHAPES", "CHAIN_SHAPES", "BF16_SHAPES",
           "mm_plain", "mm_rate", "mm_chain", "mm_time", "mm_tiles", "mm_flops", "mm_plan",
           "MmPlan", "mm_args", "mm_ctas", "WGMMA_3X", "WGMMA_BN", "KS_MIN_STEPS", "N_SM",
           "PER_SM"]

VARIANTS = ("ffma", "tf32", "3xtf32", "3xtf32_presplit", "wgmma_tf32", "bf16")
# limits of each variant against the plain version, of max |plain|: fp32
# accuracy (ffma, 3xTF32) 1e-5, as the conv kernels; one TF32 pass (tf32,
# wgmma_tf32) 2^-9: TF32 keeps 10 mantissa bits, each operand rounded within
# 2^-11, a product within 2^-10, and over k products of random sign the
# error of the largest output stays within a few 2^-11 (one pass was 3e-4 off
# at W3's shapes, csrc/fused_conv_common.cuh); bf16 2^-8: the operands are
# bf16 on both sides and their products exact in fp32, but the plain version
# rounds a (1 + s i) to bf16 (2^-9 relative) where the kernel scales the
# product
PROBE_TOL = {"ffma": 1e-5, "3xtf32": 1e-5, "3xtf32_presplit": 1e-5, "tf32": 2.0**-9,
             "wgmma_tf32": 2.0**-9, "bf16": 2.0**-8}
REP = 16
# (m, k, n) of the TPU scripts' report lines (r2_pallas_mm.py:131-137,
# r2_pallas_fma.py:145-147); bf16 at 1024 x 64 x 960 in both
MM_SHAPES = ((1024, 64, 960), (960, 64, 1024), (1024, 9, 185), (185, 16, 1024),
             (480, 512, 1024), (1024, 512, 480))
CHAIN_SHAPES = ((1024, 64, 960), (1024, 9, 185))
BF16_SHAPES = ((1024, 64, 960),)
# the variants on the 3xTF32 wgmma kernel (csrc/probe_mm.cu probe_mm3x_kernel);
# ffma runs on probe_mm_ffma_kernel, tf32, wgmma_tf32 and bf16 on probe_mm_tc_kernel
WGMMA_3X = ("3xtf32", "3xtf32_presplit")
BN = 64  # output columns a warpgroup, every kernel (csrc/probe_mm.cu MM_BN), or WGMMA_BN
TILE = (64, BN)  # output rows x columns of one warpgroup
# CTAs an SM of two warpgroups: ffma's kernel (csrc/probe_mm.cu
# probe_mm_ffma_kernel) two, its registers allow them; every other variant
# one (the tensor-core kernels' shared memory). CTAs of one warpgroup (mw 1,
# ks 1): two an SM for every variant that has them
PER_SM = {"ffma": 2}
# wgmma_tf32's output columns a warpgroup (its wgmma N) that mm_plan may
# take: 128 only where a warpgroup's k-steps are one chunk of 8 (a k-step
# reads 96 bytes of shared memory a clock at the peak rate, against N 64's
# 128, the whole of its rate: 0.0120 against 0.0130 ms at 1024 x 64 x 960,
# mm_breakdown.py --only wgmma, H100 SXM at 700 W)
WGMMA_BN = (64, 128)
# k-steps from which mm_plan may halve k between a CTA's two warpgroups
# (ks 2): wgmma_tf32 only where each half keeps a chunk of its own (at 1024
# x 9 x 185 the halves' exchange cost more than it saved: 0.0092 against
# 0.0081 ms on one warpgroup a CTA, mm_breakdown.py --only wgmma)
KS_MIN_STEPS = {"wgmma_tf32": 16}
N_SM = 132  # SMs of an H100 SXM, the plan's default


class MmPlan(NamedTuple):
    """A launch of any of the kernels: its two warpgroups side by side in
    m (``mw`` 2, ``ks`` 1: a CTA's tile is 128 x ``BN``), on the two halves
    of the k-steps of one 64 x ``BN`` tile (``mw`` 1, ``ks`` 2), or (not
    the 3xTF32 kernel) one warpgroup a CTA (``mw`` 1, ``ks`` 1); ``ctas``,
    the CTA tiles of one copy; ``rows``, a warpgroup tile's rows: 64, or 32
    (ffma's chain, one warpgroup a CTA); ``bn``, its columns: 64, or 128
    (wgmma_tf32, ``WGMMA_BN``)."""

    mw: int
    ks: int
    ctas: int
    rows: int = 64
    bn: int = BN


class _MmArgs(ctypes.Structure):
    """ctypes mirror of ``struct MmArgs`` (csrc/probe_mm.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("a", "b", "out", "s")] + [
        (f, ctypes.c_int) for f in ("m", "k", "n", "rep", "copies", "mw", "ks", "rows", "bn")]


def mm_args(a, b, s, out, rep: int, copies: int, plan: MmPlan) -> _MmArgs:
    """The kernels' arguments: ``a (m, k)``, ``b (k, n)``, ``s`` (None with
    the carry) and ``out`` on ``plan``."""
    return _MmArgs(a.data_ptr(), b.data_ptr(), out.data_ptr(), None if s is None else s.data_ptr(),
                   a.shape[0], a.shape[1], b.shape[1], rep, copies, plan.mw, plan.ks, plan.rows,
                   plan.bn)


def mm_plan(m: int, k: int, n: int, carry: bool = False, copies: int = 1,
            n_sm: int = N_SM, variant: str = "3xtf32") -> MmPlan:
    """The plan of one call of ``variant``: of ``mw`` 2 (every k-step in
    each warpgroup), ``mw`` 1 with ``ks`` 2 (half the k-steps each; not for
    the carried chain, whose next A needs the whole product, nor for one
    k-step) and, but for the 3xTF32 variants, one warpgroup a CTA (for
    ffma's chain, which cannot split k, also on 32-row tiles), the one whose
    SMs' most work is least (CTA tiles an SM x warpgroups a CTA x k-steps a
    warpgroup x its tile's rows x columns); on a tie the wider tile
    (wgmma_tf32's N 128), then the one with more threads on the card at
    once (all its CTAs resident, ``PER_SM`` an SM, two of one warpgroup:
    more warps to hide latency), then the first. wgmma_tf32 also at
    ``WGMMA_BN``'s columns where a warpgroup's k-steps are one chunk of 8;
    ``ks`` 2 from ``KS_MIN_STEPS`` k-steps (2 by default)."""
    nks = -(-k // 8)
    best = None
    arrangements = ((2, 1, 64), (1, 2, 64)) + ((1, 1, 64),) * (variant not in WGMMA_3X)
    arrangements += ((1, 1, 32),) * (variant == "ffma" and carry)
    for bn in WGMMA_BN if variant == "wgmma_tf32" else (BN,):
        for mw, ks, rows in arrangements:
            if ((ks == 2 and (carry or nks < KS_MIN_STEPS.get(variant, 2)))
                    or (bn > BN and -(-nks // ks) > 8)):
                continue
            per_sm = PER_SM.get(variant, 1) if mw * ks == 2 else 2
            ctas = -(-m // (rows * mw)) * -(-n // bn)
            work = -(-ctas * copies // n_sm) * mw * ks * -(-nks // ks) * rows * bn
            threads = 128 * mw * ks * ctas * copies if ctas * copies <= n_sm * per_sm else 0
            if best is None or (work, -bn, -threads) < best[0]:
                best = ((work, -bn, -threads), MmPlan(mw, ks, ctas, rows, bn))
    return best[1]


def mm_ctas(m: int, k: int, n: int, variant: str, carry: bool = False) -> int:
    """CTAs of one copy of a call of ``variant`` on an H100's 132 SMs."""
    return mm_plan(m, k, n, carry, variant=variant).ctas


def mm_plain(a, b, s, rep: int = REP, carry: bool = False, copies: int = 1):
    """The TPU kernels' loop in PyTorch: ``acc = acc * 0.5 + a_i @ b`` with
    ``a_i = a * (1 + s i)`` (cast to a's type) or, with ``carry``, ``a_i =
    a + acc[0, 0] * 1e-20`` (cast to a's type); the product in float32."""
    m, n = a.shape[0], b.shape[1]
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    bf = b.float()
    for i in range(rep):
        if carry:
            ai = a + (acc[0:1, 0:1] * 1e-20).to(a.dtype)
        else:
            ai = a * (1.0 + s[0, 0] * i).to(a.dtype)
        acc = acc * 0.5 + ai.float() @ bf
    return acc if copies == 1 else acc.expand(copies, m, n).contiguous()


def _check(a, b, s, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    want = torch.bfloat16 if variant == "bf16" else torch.float32
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a (m, k) and b (k, n), got {tuple(a.shape)} and {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: the {variant} variant takes contiguous {want}, got {t.dtype}")
    if s is not None and (tuple(s.shape) != (1, 1) or s.dtype != torch.float32):
        raise ValueError(f"s: a (1, 1) float32 scalar, got {s.dtype} {tuple(s.shape)}")


def _out(a, b, copies: int, out):
    shape = (a.shape[0], b.shape[1]) if copies == 1 else (copies, a.shape[0], b.shape[1])
    if out is not None and (tuple(out.shape) != shape or out.dtype != torch.float32
                            or not out.is_contiguous()):
        raise ValueError(f"out: a contiguous float32 {shape}, got {out.dtype} {tuple(out.shape)}")
    return shape


def _launch(a, b, s, variant: str, rep: int, carry: bool, copies: int, out):
    m, k = a.shape
    n = b.shape[1]
    shape = _out(a, b, copies, out)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=a.device)
    plan = mm_plan(m, k, n, carry, copies,
                   torch.cuda.get_device_properties(a.device).multi_processor_count, variant)
    call("probe_mm", "probe_mm_launch", ctypes.c_int(VARIANTS.index(variant)),
         ctypes.c_int(int(carry)), mm_args(a, b, None if carry else s, out, rep, copies, plan),
         stream(a.device))
    return out


def _plain_into(res, out):
    if out is None:
        return res
    return out.copy_(res)


def mm_rate(a, b, s, variant: str = "3xtf32", rep: int = REP, copies: int = 1,
            plain: bool = False, out=None):
    """``r2_pallas_mm.py:mm``'s function: :func:`mm_plain` without carry.
    CUDA tensors: the ``probe_mm`` kernel's ``variant``; ``plain=True``:
    the plain version."""
    _check(a, b, s, variant)
    _out(a, b, copies, out)
    if check_device(plain, a, b, s, *(() if out is None else (out,))):
        return _plain_into(mm_plain(a, b, s, rep, carry=False, copies=copies), out)
    out = _launch(a, b, s, variant, rep, False, copies, out)
    mm_rate.launches += 1
    mm_rate.by_variant[variant] += 1
    return out


mm_rate.launches = 0
mm_rate.by_variant = dict.fromkeys(VARIANTS, 0)


def mm_chain(a, b, variant: str = "3xtf32", rep: int = REP, copies: int = 1,
             plain: bool = False, out=None):
    """``r2_pallas_fma.py:mm``'s function: :func:`mm_plain` with the
    carry. CUDA tensors: the ``probe_mm`` kernel's ``variant`` with the
    carry; ``plain=True``: the plain version."""
    _check(a, b, None, variant)
    _out(a, b, copies, out)
    if check_device(plain, a, b, *(() if out is None else (out,))):
        return _plain_into(mm_plain(a, b, None, rep, carry=True, copies=copies), out)
    out = _launch(a, b, None, variant, rep, True, copies, out)
    mm_chain.launches += 1
    mm_chain.by_variant[variant] += 1
    return out


mm_chain.launches = 0
mm_chain.by_variant = dict.fromkeys(VARIANTS, 0)


def mm_tiles(m: int, n: int) -> int:
    """Warpgroup tiles (``TILE``, 64 x 64 outputs) of one copy: two a CTA
    (``mm_plan``'s ``mw`` 2) or one (``ks`` 2)."""
    return -(-m // TILE[0]) * -(-n // TILE[1])


def mm_flops(m: int, k: int, n: int, rep: int = REP, copies: int = 1) -> int:
    """Operations of one call: ``2 m k n`` per product, as the TPU script
    counts them."""
    return 2 * m * k * n * rep * copies


def mm_time(fn, n1: int = 50, n2: int = 250, tries: int = 3) -> float:
    """Device ms per call of ``fn`` (a call of :func:`mm_rate` or
    :func:`mm_chain` on the card, or library calls), the TPU script's
    method (``_lib.diff_ms``): 250 against 50 calls, best of 3."""
    return diff_ms(fn, n1, n2, tries)


def shapes(variant: str, chain: bool) -> Tuple[Tuple[int, int, int], ...]:
    """The (m, k, n) a variant runs at in each contract."""
    if variant == "bf16":
        return BF16_SHAPES
    return CHAIN_SHAPES if chain else MM_SHAPES
