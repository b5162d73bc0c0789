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
for every product or split once (both on ``wgmma``, :func:`mm_plan`),
``wgmma`` from shared memory, bf16.

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
           "MmPlan", "mm_ctas", "WGMMA_3X", "N_SM"]

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
TILE = (64, 32)  # output rows x columns of one CTA (csrc/probe_mm.cu PBM, PBN)
# the variants on the 3xTF32 wgmma kernel (csrc/probe_mm.cu probe_mm3x_kernel)
WGMMA_3X = ("3xtf32", "3xtf32_presplit")
BN = 64  # its output columns a warpgroup (csrc/probe_mm.cu MM_BN)
N_SM = 132  # SMs of an H100 SXM, the plan's default


class MmPlan(NamedTuple):
    """The 3xTF32 kernel's launch: its two warpgroups side by side in m
    (``mw`` 2, ``ks`` 1: a CTA's tile is 128 x ``BN``) or on the two halves
    of the k-steps of one 64 x ``BN`` tile (``mw`` 1, ``ks`` 2); ``ctas``
    of one copy."""

    mw: int
    ks: int
    ctas: int


class _MmArgs(ctypes.Structure):
    """ctypes mirror of ``struct MmArgs`` (csrc/probe_mm.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("a", "b", "out", "s")] + [
        (f, ctypes.c_int) for f in ("m", "k", "n", "rep", "copies", "mw", "ks")]


def mm_plan(m: int, k: int, n: int, carry: bool = False, copies: int = 1,
            n_sm: int = N_SM) -> MmPlan:
    """The 3xTF32 kernel's plan for one call: of ``mw`` 2 (every k-step in
    each warpgroup) and ``mw`` 1 with ``ks`` 2 (half the k-steps each; not
    for the carried chain, whose next A needs the whole product, nor for one
    k-step), the one whose waves of CTAs times k-steps a CTA runs is least
    (one CTA an SM), ``mw`` 2 on a tie."""
    nks = -(-k // 8)
    best = None
    for mw, ks in ((2, 1), (1, 2)):
        if ks == 2 and (carry or nks < 2):
            continue
        ctas = -(-m // (64 * mw)) * -(-n // BN)
        cost = -(-ctas * copies // n_sm) * 2 * -(-nks // ks)
        if best is None or cost < best[0]:
            best = (cost, MmPlan(mw, ks, ctas))
    return best[1]


def mm_ctas(m: int, k: int, n: int, variant: str, carry: bool = False) -> int:
    """CTAs of one copy of a call of ``variant``."""
    if variant in WGMMA_3X:
        return mm_plan(m, k, n, carry).ctas
    return mm_tiles(m, n)


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
    plan = MmPlan(0, 0, 0)
    if variant in WGMMA_3X:
        plan = mm_plan(m, k, n, carry, copies,
                       torch.cuda.get_device_properties(a.device).multi_processor_count)
    call("probe_mm", "probe_mm_launch", ctypes.c_int(VARIANTS.index(variant)),
         ctypes.c_int(int(carry)),
         _MmArgs(a.data_ptr(), b.data_ptr(), out.data_ptr(), None if carry else s.data_ptr(),
                 m, k, n, rep, copies, plan.mw, plan.ks),
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
    """CTAs of one copy of the ffma, tf32, wgmma_tf32 and bf16 variants
    (64 x 32 output tiles)."""
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
