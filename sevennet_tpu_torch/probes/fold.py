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
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels import call
from ._lib import check_device, stream

__all__ = ["VARIANTS", "N", "K", "A", "DM", "MULS", "FOLD_KS", "TOL", "fold_matrix",
           "column_map", "kfold_plain", "fold_plain", "fold", "fold_work"]

VARIANTS = ("roll", "mxu2", "mxu3", "bigroll")
N, K, A = 10016, 72, 32            # r3_fold_probe.py:17
DM = 3136                          # :19
MULS = (128,) * 8 + (64,) * 22 + (32,) * 22  # :22, summing to DM
FOLD_KS = (8, 9, 72)   # the roll kernel's K (a template argument, csrc/probe_fold.cu)
# kernel against plain, of max |plain|: fp32 sums of K terms (roll: the same
# order; mxu: the same bf16 pieces, their sums in another order)
TOL = 1e-5
PIECES = {"roll": 0, "bigroll": 0, "mxu2": 2, "mxu3": 3}


class _FoldArgs(ctypes.Structure):
    """ctypes mirror of ``struct FoldArgs`` (csrc/probe_fold.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("x", "fold", "cmap", "out")] + [
        (f, ctypes.c_int) for f in ("NB", "K", "A", "DX", "DM")]


def fold_matrix(k: int, a: int, device=None) -> torch.Tensor:
    """The script's ``fold[t, t mod A] = 1`` (``:31-33``), ``(A K, A)``."""
    t = torch.arange(k * a)
    f = torch.zeros(k * a, a)
    f[t, t % a] = 1.0
    return f.to(device)


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


def _check_kernel(k, a, dx, dm, variant):
    if dx % 4 or dm % 8:
        raise ValueError(f"the fold kernels take DX a multiple of 4 and DM of 8, got {dx}, {dm}")
    if PIECES[variant] == 0 and k not in FOLD_KS:
        raise ValueError(f"the roll kernel is built for K in {FOLD_KS}, got {k}")
    if PIECES[variant] and a not in (16, 32):
        raise ValueError(f"the mxu kernel takes A 16 or 32, got {a}")


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
    _check_kernel(k, a, x.shape[1], shape[1], variant)
    cmap = _device_map(variant, muls, x.shape[1], x.device)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
    call("probe_fold", "probe_fold_launch", ctypes.c_int(PIECES[variant]),
         _FoldArgs(x.data_ptr(), foldm.data_ptr(), cmap.data_ptr(), out.data_ptr(),
                   x.shape[0] // (k * a), k, a, x.shape[1], shape[1]),
         stream(x.device))
    fold.launches += 1
    fold.by_variant[variant] += 1
    return out


fold.launches = 0
fold.by_variant = dict.fromkeys(VARIANTS, 0)


@lru_cache(maxsize=None)
def _device_map(variant, muls, dx, device):
    return torch.as_tensor(column_map(variant, muls, dx), device=device)


def fold_work(nb: int, k: int = K, a: int = A, dm: int = DM):
    """(flops, bytes) of one call of the function, the same for every
    variant (a variant is a method, not more work): K - 1 adds per output;
    the input and the fold matrix read once, the output written once."""
    n_out, n_in = nb * a * dm, nb * k * a * (dm // 8)
    return n_out * (k - 1), 4 * (n_in + k * a * a + n_out)
