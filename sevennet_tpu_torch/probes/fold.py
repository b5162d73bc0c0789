"""K-fold probes (``csrc/probe_fold.cu``): the sum over each receiver's K
neighbour slots of a dim_mid tile, alone, the counterpart of the TPU probe
``scripts_dev/r3_fold_probe.py:make`` (pallas_call at ``:85``).

:func:`fold` takes x ``(NB T, DX)``, T = A K, DX = DM / 8, in the TPU's
k-major rows (block b holds row ``b T + k A + a`` for slot k of receiver ``b
A + a``), and the 0/1 fold matrix ``(T, A)`` (:func:`fold_matrix`), and
returns ``(NB A, DM)``::

    out[b A + a, c] = sum_k x[b T + k A + a, cmap[c]]

with the script's column map (:func:`column_map`): the tile variants map
output column ``start + j`` of each tile of ``muls`` rows to input column
``(start // 8 + j) mod DX`` (``:54-60``), ``bigroll`` column r to ``r mod
DX`` (``:79-82``). The variants (:data:`VARIANTS`): ``roll`` and
``bigroll`` sum in the script's halving order (``_kfold``, ``:36-49``) in
fp32; ``mxu2`` and ``mxu3`` split x into 2 or 3 bf16 pieces and multiply
each by the fold matrix with fp32 accumulation (``:63-77``).

The ``roll`` kernel streams each receiver's K rows as slices of
:data:`ROLL_SW` input columns through a ring of shared-memory stages and
folds, from each stage, every output column whose input column lies in its
slice, each on its own; :func:`roll_plan` is the host's inverse column map
and ring (``csrc/probe_fold.cu``). The ``mxu`` kernel runs a block's m64
tiles of output columns on a
thread-block cluster, :data:`MMA_TPW` tiles a CTA, each stage of x loaded
once by TMA and multicast to the cluster's CTAs in boxes of ``W`` columns;
:func:`mma_plan` is the host's plan of both, :func:`mma_pairs` says whether
the column map lets it load two columns at once (``csrc/probe_fold.cu``).
A call is two launches: the fold matrix's bf16 tiles into a scratch buffer
the wrapper allocates, then the product (the fold is read from its
argument, whatever its values; ``mxu`` rounds it to bf16).

The wrapper launches the kernel on CUDA tensors and raises on CPU tensors
unless ``plain=True`` (the plain version, on any device, which folds each
input column once and then maps the columns: the same sums, since a
column's fold does not depend on which output column asks for it; the
``mxu`` plain versions multiply with float32 matmuls, so TF32 must be off
for them on the card). It counts its launches in ``.launches`` and, per
variant, in ``.by_variant``. Kernel and plain agree within :data:`TOL` of
max |plain|: ``roll`` and ``bigroll`` add in the same order, the ``mxu``
products in another. Timing: ``diff_ms(fn, *FOLD_TIME)``, the script's
differential of 9 and 3 calls, best of 3 (``r3_fold_probe.py:99-117``)."""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels import call
from ._lib import check_device, stream

__all__ = ["VARIANTS", "N", "K", "A", "DM", "MULS", "FOLD_KS", "TOL", "fold_matrix",
           "column_map", "kfold_plain", "fold_plain", "fold", "fold_work", "MmaPlan",
           "mma_plan", "mma_pairs", "MMA_TPW", "MMA_CLMAX", "MMA_BOXW", "cancelling_input",
           "RollPlan", "roll_plan", "roll_vec", "ROLL_SW"]

VARIANTS = ("roll", "mxu2", "mxu3", "bigroll")
N, K, A = 10016, 72, 32            # r3_fold_probe.py:17
DM = 3136                          # :19
MULS = (128,) * 8 + (64,) * 22 + (32,) * 22  # :22, summing to DM
FOLD_KS = (8, 9, 72)   # the roll kernel's K (a template argument, csrc/probe_fold.cu)
# kernel against plain, of max |plain|: fp32 sums of K terms (roll: the same
# order; mxu: the same bf16 pieces, their sums in another order)
TOL = 1e-5
PIECES = {"roll": 0, "bigroll": 0, "mxu2": 2, "mxu3": 3}
# the mxu kernel's layout (csrc/probe_fold.cu; probe_fold_layout returns the
# same): m64 tiles of output columns, tiles a CTA, CTAs a cluster at most,
# the widest TMA box of x (<= 256 columns, 4 mod 8), rows a stage, stages,
# threads, bytes of a stage's B
MMA_TILE, MMA_TPW, MMA_CLMAX, MMA_BOXW = 64, 7, 8, 252
MMA_R, MMA_NSMAX, MMA_NT, MMA_BBYTES = 16, 8, 384, 1024
SMEM_LIMIT = 232448  # dynamic shared memory a CTA may have on sm_90
# the roll kernel's layout (csrc/probe_fold.cu; probe_fold_roll_layout
# returns the same): threads that fold, stages at most; and its slice of
# input columns (16 KB of x a stage at K 72; 7 slices at DX 392)
ROLL_NT, ROLL_NSMAX = 256, 12
ROLL_SW = 56
ROLL_ALIGN = 128  # bytes the kernel may skip to align its ring for TMA


class _RollArgs(ctypes.Structure):
    """ctypes mirror of ``struct RollArgs`` (csrc/probe_fold.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("x", "out", "units", "uoff")] + [
        (f, ctypes.c_int) for f in ("NB", "A", "DX", "DM", "SW", "nsl", "ns", "vec")]


class _FoldArgs(ctypes.Structure):
    """ctypes mirror of ``struct FoldArgs`` (csrc/probe_fold.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("x", "fold", "cmap", "out", "bq")] + [
        (f, ctypes.c_int) for f in ("NB", "K", "A", "DX", "DM", "tiles", "cl", "ctas", "nbox",
                                    "W", "ns", "pairs")]


def fold_matrix(k: int, a: int, device=None) -> torch.Tensor:
    """The script's ``fold[t, t mod A] = 1`` (``:31-33``), ``(A K, A)``."""
    t = torch.arange(k * a)
    f = torch.zeros(k * a, a)
    f[t, t % a] = 1.0
    return f.to(device)


# slot pairs of cancelling_input: its running sums stay below 2 x 32.5 < 2^7
# in multiples of 2^-16 (23 bits), exact in fp32 in any order
CANCEL_PAIRS = 2


def cancelling_input(nb: int, k: int, a: int, dx: int, seed: int = 0,
                     device=None) -> torch.Tensor:
    """An x ``(NB A K, DX)`` whose fold under :func:`fold_matrix` lives in
    x's lower bf16 pieces, so that a fold without its third piece misses
    :data:`TOL` (on random x the third piece is below it). For j <
    min(:data:`CANCEL_PAIRS`, K // 2) slot j holds ``h + m`` and slot ``K //
    2 + j`` holds ``-h``: h a bf16 value in [16, 32), m of 16 significant
    bits in ±[1/4, 1/2); the other slots are 0. ``h + m`` is exact in fp32 and
    in 3 bf16 pieces, so each fold is the exact sum of the m, in every
    order; 2 pieces leave up to 2^-11 of each ``h + m`` out."""
    g = torch.Generator().manual_seed(seed)
    p, half = min(CANCEL_PAIRS, k // 2), k // 2
    h = torch.randint(128, 256, (nb, p, a, dx), generator=g).float() * 2.0 ** -3
    m = torch.randint(2 ** 14, 2 ** 15, (nb, p, a, dx), generator=g).float() * 2.0 ** -16
    m *= torch.randint(0, 2, (nb, p, a, dx), generator=g).float() * 2 - 1
    x = torch.zeros(nb, k, a, dx, device=device)
    x[:, :p] = (h + m).to(device)
    x[:, half:half + p] = (-h).to(device)
    return x.view(nb * k * a, dx)


@dataclass(frozen=True)
class MmaPlan:
    """How the mxu kernel covers one block (``csrc/probe_fold.cu``):
    ``tiles`` m64 tiles of the DM output columns, clusters of ``cl`` CTAs,
    ``ctas`` CTAs a block (CTA q takes tiles ``[q tiles // ctas, (q + 1)
    tiles // ctas)``, at most :data:`MMA_TPW`), each stage of x loaded as
    ``nbox`` TMA boxes of ``W`` columns (W = 4 mod 8: the staged row pitch
    that keeps the fragment loads on distinct banks), a ring of ``ns``
    stages (even: the CTA's two warpgroups take alternate stages), ``smem``
    bytes of shared memory a CTA (at least what carries one warpgroup's
    sums to the other at the end)."""

    tiles: int
    cl: int
    ctas: int
    nbox: int
    W: int
    ns: int
    smem: int

    def cta_tiles(self, q: int) -> range:
        return range(q * self.tiles // self.ctas, (q + 1) * self.tiles // self.ctas)


def _mma_smem(ns: int, nbox: int, w: int) -> int:
    ring = ns * (nbox * MMA_R * w + 2 * MMA_BBYTES // 4)
    return 4 * max(ring, MMA_TPW * 16 * 128) + 2 * ns * 8


def mma_plan(dx: int, dm: int, a: int) -> MmaPlan:
    """The mxu kernel's plan for DX input and DM output columns at A: the
    fewest CTAs a cluster (at most :data:`MMA_CLMAX`) whose
    :data:`MMA_TPW` tiles each cover the tiles, as many clusters a block as
    that leaves short, the tiles spread evenly; the fewest boxes of at most
    :data:`MMA_BOXW` columns, each the narrowest width of 4 mod 8 that
    covers DX; the deepest even ring, up to :data:`MMA_NSMAX` stages, that
    fits :data:`SMEM_LIMIT` (0 stages: none fits)."""
    tiles = -(-dm // MMA_TILE)
    cl = min(MMA_CLMAX, -(-tiles // MMA_TPW))
    ctas = cl * -(-tiles // (cl * MMA_TPW))
    nbox = -(-dx // MMA_BOXW)
    w = -(-dx // nbox)
    w += (4 - w) % 8
    ns = next((n for n in range(MMA_NSMAX, 0, -2) if _mma_smem(n, nbox, w) <= SMEM_LIMIT), 0)
    return MmaPlan(tiles, cl, ctas, nbox, w, ns, _mma_smem(max(ns, 2), nbox, w))


def mma_pairs(cmap: np.ndarray) -> bool:
    """Whether every pair of output columns 2i, 2i + 1 reads input columns
    ci, ci + 1 with ci even: the mxu kernel then loads both of a row in one
    8-byte load (each column's value still its own)."""
    ci = np.asarray(cmap).reshape(-1, 2)
    return bool(np.all(ci[:, 0] % 2 == 0) and np.all(ci[:, 1] == ci[:, 0] + 1))


def roll_vec(cmap: np.ndarray) -> bool:
    """Whether every aligned run of 4 output columns reads 4 consecutive
    input columns from a multiple of 4: the roll kernel then folds a run at
    once, by 16-byte loads (each column's sum still its own)."""
    ci = np.asarray(cmap).reshape(-1, 4)
    return bool(np.all(ci[:, 0] % 4 == 0) and np.all(ci - ci[:, :1] == np.arange(4)))


@dataclass(frozen=True, eq=False)
class RollPlan:
    """How the roll kernel covers a receiver (``csrc/probe_fold.cu``): its
    K rows as ``nsl`` slices of ``sw`` input columns (the last narrower when
    sw does not divide DX), a stage each, in a ring of ``ns`` stages
    (``smem`` bytes with the mbarriers; a stage is K sw floats rounded up to
    128 bytes, where one TMA box lands); slice s's units are ``units[uoff[s]
    : uoff[s + 1]]``, each (output column, input column - s sw): 4 columns
    from there when ``vec``, else 1; within a slice sorted by input column,
    so that neighbouring threads read neighbouring words."""

    sw: int
    nsl: int
    ns: int
    smem: int
    vec: bool
    units: np.ndarray
    uoff: np.ndarray


def roll_plan(cmap: np.ndarray, dx: int, k: int, sw: int = ROLL_SW) -> RollPlan:
    """The roll kernel's plan for column map ``cmap`` over DX input columns
    at K: the inverse map by slice and the deepest ring up to
    :data:`ROLL_NSMAX` stages that fits :data:`SMEM_LIMIT` (0: none)."""
    cmap = np.asarray(cmap)
    vec = roll_vec(cmap)
    cols = np.arange(0, len(cmap), 4 if vec else 1)
    ci = cmap[cols]
    order = np.lexsort((cols, ci))
    cols, ci = cols[order], ci[order]
    nsl = -(-dx // sw)
    units = np.stack([cols, ci % sw], axis=1).astype(np.int32)
    uoff = np.searchsorted(ci // sw, np.arange(nsl + 1)).astype(np.int32)
    return RollPlan(sw, nsl, *_roll_ring(k, sw), vec, units, uoff)


def _roll_ring(k: int, sw: int):
    """(stages, bytes) of the roll kernel's ring: stages of K sw floats,
    each rounded up to 128 bytes, and 2 mbarriers, as many as fit, up to
    ROLL_NSMAX."""
    stage = 4 * -(-k * sw // 32) * 32 + 16
    ns = min(ROLL_NSMAX, (SMEM_LIMIT - ROLL_ALIGN) // stage)
    return ns, stage * ns + ROLL_ALIGN


@lru_cache(maxsize=None)
def _column_map(variant: str, muls: Tuple[int, ...], dx: int) -> np.ndarray:
    dm = sum(muls)
    if variant == "bigroll":
        return np.arange(dm, dtype=np.int32) % dx
    cols, start = [], 0
    for mul in muls:
        if mul > dx:
            raise ValueError(f"a tile of {mul} rows wraps more than once around {dx} columns")
        cols.append((start // 8 + np.arange(mul)) % dx)
        start += mul
    return np.concatenate(cols).astype(np.int32)


def column_map(variant: str, muls: Sequence[int] = MULS, dx: int = None) -> np.ndarray:
    """The input column of each output column (``(DM,)`` int32) for
    ``variant``: tiles of ``muls`` rows, DX = DM / 8 unless given."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    muls = tuple(int(m) for m in muls)
    return _column_map(variant, muls, sum(muls) // 8 if dx is None else dx)


def kfold_plain(v: torch.Tensor, dim: int) -> torch.Tensor:
    """The script's ``_kfold`` order along ``dim``: halve while the count is
    even, add the last slot onto the first while it is odd."""
    v = v.movedim(dim, 0)
    while v.shape[0] > 1:
        kc = v.shape[0]
        if kc % 2 == 0:
            v = v[: kc // 2] + v[kc // 2:]
        else:
            v = torch.cat([(v[0] + v[kc - 1])[None], v[1: kc - 1]])
    return v[0]


def _pieces(x, n: int):
    """x as n bf16 pieces (``:64-65``, ``:70-73``), each as float32."""
    out, r = [], x
    for i in range(n):
        q = r.to(torch.bfloat16).float()
        out.append(q)
        if i + 1 < n:
            r = r - q
    return out


def fold_plain(x, foldm, k: int, a: int, variant: str, muls: Sequence[int] = MULS):
    """The script's function in torch, ``(NB A, DM)``."""
    t, dx = k * a, x.shape[1]
    nb = x.shape[0] // t
    cmap = torch.as_tensor(column_map(variant, muls, dx), dtype=torch.long, device=x.device)
    if PIECES[variant] == 0:
        folded = kfold_plain(x.view(nb, k, a, dx), 1)  # (NB, A, DX)
    else:
        folded = sum(torch.matmul(foldm.t(), p.view(nb, t, dx))
                     for p in _pieces(x, PIECES[variant]))
    return folded[:, :, cmap].reshape(nb * a, -1)


def _check(x, foldm, k, a, variant, muls, out):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    for name, v in (("x", x), ("fold", foldm)):
        if v.dtype != torch.float32 or not v.is_contiguous() or v.dim() != 2:
            raise ValueError(f"{name}: a contiguous 2-d float32 tensor, got {v.dtype} "
                             f"{tuple(v.shape)}")
    t, dx, dm = k * a, x.shape[1], sum(muls)
    if t <= 0 or x.shape[0] % t or x.shape[0] == 0:
        raise ValueError(f"x {tuple(x.shape)}: a whole number of blocks of A K = {t} rows")
    if tuple(foldm.shape) != (t, a):
        raise ValueError(f"fold: ({t}, {a}), got {tuple(foldm.shape)}")
    if dm != 8 * dx:
        raise ValueError(f"the tiles ({dm} rows) are 8 times x's {dx} columns in the script")
    shape = (x.shape[0] // t * a, dm)
    if out is not None and (tuple(out.shape) != shape or out.dtype != torch.float32
                            or not out.is_contiguous()):
        raise ValueError(f"out: a contiguous float32 {shape}, got {out.dtype} {tuple(out.shape)}")
    return shape


def _check_kernel(k, a, dx, dm, variant, nb, tensors):
    if dx % 4 or dm % 8:
        raise ValueError(f"the fold kernels take DX a multiple of 4 and DM of 8, got {dx}, {dm}")
    if nb > 65535:
        raise ValueError(f"the fold kernels take at most 65,535 blocks, got {nb}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the fold kernels take x, fold and out 16-byte aligned")
    if PIECES[variant] == 0 and k not in FOLD_KS:
        raise ValueError(f"the roll kernel is built for K in {FOLD_KS}, got {k}")
    if PIECES[variant] == 0:
        if _roll_ring(k, ROLL_SW)[0] < 2:
            raise ValueError(f"the roll kernel's two stages of K {k} need more than "
                             f"{SMEM_LIMIT} bytes of shared memory")
        return None
    if a not in (16, 32):
        raise ValueError(f"the mxu kernel takes A 16 or 32, got {a}")
    plan = mma_plan(dx, dm, a)
    if plan.ns == 0:
        raise ValueError(f"the mxu kernel's two stages of DX {dx} need {plan.smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return plan


def _check_layout(lib):
    got = (ctypes.c_int * 8)()
    lib.probe_fold_layout(got)
    want = (MMA_TILE, MMA_TPW, MMA_CLMAX, MMA_BOXW, MMA_R, MMA_NSMAX, MMA_NT, MMA_BBYTES)
    roll = (ctypes.c_int * 2)()
    lib.probe_fold_roll_layout(roll)
    if tuple(got) != want or tuple(roll) != (ROLL_NT, ROLL_NSMAX):
        raise RuntimeError(f"csrc/probe_fold.cu's layout {tuple(got)}, {tuple(roll)} is not "
                           f"probes/fold.py's {want}, {(ROLL_NT, ROLL_NSMAX)}")


def fold(x, foldm, k: int = K, a: int = A, variant: str = "roll",
         muls: Sequence[int] = MULS, out=None, plain: bool = False):
    """``r3_fold_probe.py:make(variant)``'s function, ``(NB A, DM)`` (into
    ``out`` when given). CUDA tensors: the ``probe_fold`` kernel of the
    variant; ``plain=True``: :func:`fold_plain`."""
    muls = tuple(int(m) for m in muls)
    shape = _check(x, foldm, k, a, variant, muls, out)
    if check_device(plain, x, foldm, *(() if out is None else (out,))):
        res = fold_plain(x, foldm, k, a, variant, muls)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
    nb = x.shape[0] // (k * a)
    plan = _check_kernel(k, a, x.shape[1], shape[1], variant, nb, (x, foldm, out))
    if plan is None:
        rp, units, uoff = _device_roll_plan(variant, muls, x.shape[1], k, x.device)
        call("probe_fold", "probe_fold_roll_launch", ctypes.c_int(k),
             _RollArgs(x.data_ptr(), out.data_ptr(), units.data_ptr(), uoff.data_ptr(), nb, a,
                       x.shape[1], shape[1], rp.sw, rp.nsl, rp.ns, int(rp.vec)),
             stream(x.device), on_load=_check_layout)
        fold.launches += 1
        fold.by_variant[variant] += 1
        return out
    cmap = _device_map(variant, muls, x.shape[1], x.device)
    tiling = (plan.tiles, plan.cl, plan.ctas, plan.nbox, plan.W, plan.ns,
              int(_mma_pairs(variant, muls, x.shape[1])))
    bq = torch.empty(k * a // MMA_R * MMA_BBYTES, dtype=torch.uint8, device=x.device)
    call("probe_fold", "probe_fold_launch", ctypes.c_int(PIECES[variant]),
         _FoldArgs(x.data_ptr(), foldm.data_ptr(), cmap.data_ptr(), out.data_ptr(),
                   bq.data_ptr(), nb, k, a, x.shape[1], shape[1], *tiling),
         stream(x.device), on_load=_check_layout)
    fold.launches += 1
    fold.by_variant[variant] += 1
    return out


fold.launches = 0
fold.by_variant = dict.fromkeys(VARIANTS, 0)


@lru_cache(maxsize=None)
def _mma_pairs(variant, muls, dx):
    return mma_pairs(column_map(variant, muls, dx))


@lru_cache(maxsize=None)
def _device_roll_plan(variant, muls, dx, k, device):
    rp = roll_plan(column_map(variant, muls, dx), dx, k)
    return (rp, torch.as_tensor(rp.units, device=device).contiguous(),
            torch.as_tensor(rp.uoff, device=device))


@lru_cache(maxsize=None)
def _device_map(variant, muls, dx, device):
    return torch.as_tensor(column_map(variant, muls, dx), device=device)


def fold_work(nb: int, k: int = K, a: int = A, dm: int = DM):
    """(flops, bytes) of one call of the function, the same for every
    variant (a variant is a method, not more work): K - 1 adds per output;
    the input and the fold matrix read once, the output written once."""
    n_out, n_in = nb * a * dm, nb * k * a * (dm // 8)
    return n_out * (k - 1), 4 * (n_in + k * a * a + n_out)

