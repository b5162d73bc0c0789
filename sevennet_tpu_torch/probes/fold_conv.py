"""Fold-order probe of the emb/sh fused conv forward
(``csrc/probe_fold_conv.cu``), the counterpart of the TPU probe
``scripts_dev/r4_fold_probe.py:make`` (pallas_call at ``:153``).

:func:`fold_conv` computes B4 fwd's function (the emb/sh conv forward,
:func:`~sevennet_tpu_torch.ops.fused_conv.fused_conv_fwd_embsh`) from the
gathered sender features: radial MLP on ``emb`` (each layer ``h W /
sqrt(fan_in)``, silu times the normalization constant between layers), ``tmp
= sh w3j_pack^T``, per instruction of the port's ``_instr_tables`` the terms
``(xg w) tmp`` of each output row, summed over each receiver's K slots.
The variants (:data:`VARIANTS`) differ only in the order of that K sum:
``sliceadd`` keeps all K values of a column and halves them in the script's
order; ``group4`` and ``group8`` keep kg running sums (slot k into sum k mod
kg) over the K / kg groups, then halve the kg sums (``:52-141``).

Edge arrays are receiver-major, as B4 fwd reads them (the TPU's k-major rows
stay behind): ``xg (N K, dim_x)``, ``emb (N K, n_basis)``, ``sh (N K,
dim_f)``; ``w3j (R, dim_f)``; out ``(N, dim_mid)``. The wrapper launches the
kernel on CUDA tensors and raises on CPU tensors unless ``plain=True`` (the
plain version, the script's operations as torch ops in its order, on any
device); it counts its launches in ``.launches`` and, per variant, in
``.by_variant``. Kernel and plain: :data:`TOL` of max |plain| (the conv's
limit: the MLP and tmp sums in another order). Timing: ``diff_ms(fn,
*FOLD_TIME)``, the script's differential of 9 and 3 calls, best of 3
(``r4_fold_probe.py:167-187``)."""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from ..irreps import Irreps, infer_irreps_out
from ..ops.activations import NORMALIZE2MOM_CST
from ..ops.fused_conv import _instr_tables
from ..ops.kernels import call
from ..ops.mlp import ScalarMLPSpec
from ..ops.tensor_product import ConvTPSpec
from ._lib import check_device, stream
from .fold import kfold_plain

__all__ = ["VARIANTS", "N", "K", "TOL", "sevennet0_conv", "fold_conv_plain", "fold_conv",
           "fold_conv_work"]

VARIANTS = ("sliceadd", "group4", "group8")
N, K = 10016, 72   # r4_fold_probe.py:26 (A 32 there: the TPU's block, not needed here)
TOL = 1e-4
NT = 256           # threads of a CTA (csrc/probe_fold_conv.cu FC_NT)
MAXL = 8           # MLP weight matrices
REC = 10           # ints of an instruction record (FC_REC)
_GROUP = {"group4": 4, "group8": 8}


def sevennet0_conv():
    """The script's layer (``r4_fold_probe.py:28-32``): SevenNet-0's
    ``128x0e+64x1e+32x2e`` against lmax-2 harmonics, radial MLP ``(8, 64,
    64, numel)``."""
    x_ir = Irreps("128x0e+64x1e+32x2e")
    f_ir = Irreps.spherical_harmonics(2, 1)
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    return conv, ScalarMLPSpec((8, 64, 64, conv.weight_numel))


class _FoldConvArgs(ctypes.Structure):
    """ctypes mirror of ``struct FoldConvArgs`` (csrc/probe_fold_conv.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("xg", "emb", "sh", "w3j", "itab", "out")] + [
        ("w", ctypes.c_void_p * MAXL), ("inv_sqrt", ctypes.c_float * MAXL),
        ("dims", ctypes.c_int * (MAXL + 1))] + [
        (f, ctypes.c_int) for f in ("nl", "N", "K", "dim_x", "dim_f", "R", "dim_mid", "n_ins",
                                    "max_mul", "max_xw", "max_rows")] + [
        ("act_cst", ctypes.c_float)]


@lru_cache(maxsize=None)
def _tables(conv: ConvTPSpec):
    """(instr, w3j_pack, dim_mid, itab): the kernel's records (x_start, d1,
    d3, mul, w_start, g_start, u_off, u_tot, where the row starts lie, first
    Wigner row: an instruction's rows are consecutive), then per instruction
    the d3 + 1 starts of each output row's (m, r) pairs, then the pairs, each
    row's in the table's order."""
    instr, w3j_pack, dim_mid, _ = _instr_tables(conv)
    n_rec = REC * len(instr)
    starts_at = n_rec + np.cumsum([0] + [ins["d3"] + 1 for ins in instr])
    pair_at = int(starts_at[-1])
    recs, starts, pairs = [], [], []
    for ins, at in zip(instr, starts_at):
        recs.append([ins["x_start"], ins["d1"], ins["d3"], ins["mul"], ins["w_start"],
                     ins["g_start"], ins["u_off"], ins["u_tot"], int(at),
                     min(r for _, _, r in ins["mp"])])
        assert sorted(r for _, _, r in ins["mp"]) == list(range(recs[-1][9],
                                                                 recs[-1][9] + len(ins["mp"])))
        for p in range(ins["d3"]):
            starts.append(pair_at + 2 * len(pairs))
            pairs.extend((m, r) for m, pp, r in ins["mp"] if pp == p)
        starts.append(pair_at + 2 * len(pairs))
    itab = np.concatenate([np.asarray(recs, np.int64).reshape(-1), np.asarray(starts, np.int64),
                           np.asarray(pairs, np.int64).reshape(-1)]).astype(np.int32)
    return instr, w3j_pack, dim_mid, itab


def fold_conv_plain(conv: ConvTPSpec, xg, emb, sh, ws, w3j, k: int, variant: str):
    """``r4_fold_probe.py:72-141`` in torch, receiver-major, ``(N,
    dim_mid)``."""
    instr, _, dim_mid, _ = _tables(conv)
    n = xg.shape[0] // k
    cst = NORMALIZE2MOM_CST["silu"]
    h = emb
    for li, w in enumerate(ws):
        h = (h @ w) * (1.0 / math.sqrt(w.shape[0]))
        if li < len(ws) - 1:
            h = torch.nn.functional.silu(h) * cst
    tmp = sh @ w3j.t()
    out = torch.zeros(n, dim_mid, dtype=torch.float32, device=xg.device)
    kg = _GROUP.get(variant, k)
    for ins in instr:
        d1, d3, mul = ins["d1"], ins["d3"], ins["mul"]
        x0, w0 = ins["x_start"], ins["w_start"]
        wb = h[:, w0: w0 + mul].reshape(n, k // kg, kg, mul)
        xw = [xg[:, x0 + m * mul: x0 + (m + 1) * mul].reshape(n, k // kg, kg, mul) * wb
              for m in range(d1)]
        tm = tmp.reshape(n, k // kg, kg, -1)
        by_p = {}
        for g in range(k // kg):  # sliceadd: one group of all K slots
            for m, p, r in ins["mp"]:
                term = xw[m][:, g] * tm[:, g, :, r: r + 1]
                by_p[p] = term if p not in by_p else by_p[p] + term
        for p, v in by_p.items():
            start = ins["g_start"] + p * ins["u_tot"] + ins["u_off"]
            out[:, start: start + mul] = kfold_plain(v, 1)  # _fold_sliceadd, :52-65
    return out


def _check(conv, mlp_dims, xg, emb, sh, ws, w3j, k, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    for name, v in (("xg", xg), ("emb", emb), ("sh", sh), ("w3j", w3j), *(
            (f"ws[{i}]", w) for i, w in enumerate(ws))):
        if v.dtype != torch.float32 or not v.is_contiguous() or v.dim() != 2:
            raise ValueError(f"{name}: a contiguous 2-d float32 tensor, got {v.dtype} "
                             f"{tuple(v.shape)}")
    if not ws or mlp_dims[-1] != conv.weight_numel:
        raise ValueError(f"ws: a radial MLP ending in the conv's {conv.weight_numel} weights, "
                         f"got {[tuple(w.shape) for w in ws]}")
    _, w3j_pack, _, _ = _tables(conv)
    if k <= 0 or xg.shape[0] % k or xg.shape[0] == 0:
        raise ValueError(f"xg {tuple(xg.shape)}: a whole number of receivers of K = {k} slots")
    nk = xg.shape[0]
    want = {"xg": (nk, conv.irreps_x.dim), "emb": (nk, mlp_dims[0]),
            "sh": (nk, conv.irreps_filter.dim), "w3j": w3j_pack.shape}
    for name, v in (("xg", xg), ("emb", emb), ("sh", sh), ("w3j", w3j)):
        if tuple(v.shape) != tuple(want[name]):
            raise ValueError(f"{name}: {tuple(want[name])}, got {tuple(v.shape)}")
    if tuple((w.shape[0], w.shape[1]) for w in ws) != tuple(zip(mlp_dims[:-1], mlp_dims[1:])):
        raise ValueError(f"ws: the MLP {mlp_dims}, got {[tuple(w.shape) for w in ws]}")
    if variant in _GROUP and k % _GROUP[variant]:
        raise ValueError(f"{variant} takes K a multiple of {_GROUP[variant]}, got {k}")


def _check_kernel(conv, mlp_dims):
    """The kernel works on float4s and gives a thread four adjacent columns:
    every instruction's mul and every hidden width is a multiple of 4 whose
    quarter divides the CTA's threads; n_basis and dim_x are multiples of 4."""
    widths = [ins["mul"] for ins in _tables(conv)[0]] + list(mlp_dims[1:-1])
    if any(w % 4 or NT % (w // 4) for w in widths) or mlp_dims[0] % 4 or conv.irreps_x.dim % 4:
        raise ValueError(f"the kernel takes multiplicities and hidden widths that are multiples "
                         f"of 4 whose quarter divides {NT}, n_basis and dim_x multiples of 4; "
                         f"got {widths}, {mlp_dims}, dim_x {conv.irreps_x.dim}")
    if not 1 <= len(mlp_dims) - 2 < MAXL:
        raise ValueError(f"the kernel takes 1 to {MAXL - 1} hidden layers, got {mlp_dims}")


def fold_conv(conv: ConvTPSpec, xg, emb, sh, ws, w3j, k: int = K, variant: str = "sliceadd",
              plain: bool = False):
    """``r4_fold_probe.py:make(variant)``'s function, receiver-major, ``(N,
    dim_mid)``. CUDA tensors: the ``probe_fold_conv`` kernel of the variant;
    ``plain=True``: :func:`fold_conv_plain`."""
    ws = list(ws)
    mlp_dims = (ws[0].shape[0], *(w.shape[1] for w in ws)) if ws else ()
    _check(conv, mlp_dims, xg, emb, sh, ws, w3j, k, variant)
    if check_device(plain, xg, emb, sh, w3j, *ws):
        return fold_conv_plain(conv, xg, emb, sh, ws, w3j, k, variant)
    _check_kernel(conv, mlp_dims)
    instr, _, dim_mid, itab = _tables(conv)
    itab_d = _device_itab(conv, xg.device)
    n = xg.shape[0] // k
    out = torch.empty(n, dim_mid, dtype=torch.float32, device=xg.device)
    args = _FoldConvArgs(xg.data_ptr(), emb.data_ptr(), sh.data_ptr(), w3j.data_ptr(),
                         itab_d.data_ptr(), out.data_ptr())
    for i, w in enumerate(ws):
        args.w[i] = w.data_ptr()
        args.inv_sqrt[i] = 1.0 / math.sqrt(w.shape[0])
    for i, d in enumerate(mlp_dims):
        args.dims[i] = d
    args.nl, args.N, args.K = len(ws), n, k
    args.dim_x, args.dim_f, args.R = xg.shape[1], sh.shape[1], w3j.shape[0]
    args.dim_mid, args.n_ins = dim_mid, len(instr)
    args.max_mul = max(ins["mul"] for ins in instr)
    args.max_xw = max(ins["d1"] * ins["mul"] for ins in instr)
    args.max_rows = max(len(ins["mp"]) for ins in instr)
    args.act_cst = NORMALIZE2MOM_CST["silu"]
    call("probe_fold_conv", "probe_fold_conv_launch", ctypes.c_int(VARIANTS.index(variant)), args,
         stream(xg.device))
    fold_conv.launches += 1
    fold_conv.by_variant[variant] += 1
    return out


fold_conv.launches = 0
fold_conv.by_variant = dict.fromkeys(VARIANTS, 0)


@lru_cache(maxsize=None)
def _device_itab(conv, device):
    return torch.as_tensor(_tables(conv)[3], device=device)


def fold_conv_work(conv: ConvTPSpec, mlp_dims, n: int, k: int):
    """(flops, bytes) of one call, counted as ``chip_smoke.py:work`` counts
    B4 fwd's function (the same function): per slot the MLP's products (a sum
    of n products 2n - 1 operations), ``tmp`` over the nonzeros of
    ``w3j_pack``, the uvu terms with the sums over m factored (two
    operations a term, then ``w s``: one per output column), the sum over the
    slots; the gathered ``xg``, ``emb``, ``sh``, the weights and ``w3j_pack``
    read once, the output written once."""
    instr, w3j_pack, dim_mid, _ = _tables(conv)
    d = tuple(mlp_dims)
    mlp = sum(b * (2 * a - 1) for a, b in zip(d[:-1], d[1:]))
    nnz = int((w3j_pack != 0).sum())
    n_terms = sum(ins["mul"] * len(ins["mp"]) for ins in instr)
    flops = n * k * (mlp + 2 * nnz - w3j_pack.shape[0] + 2 * n_terms + dim_mid) - n * dim_mid
    dim_x, dim_f = conv.irreps_x.dim, conv.irreps_filter.dim
    nbytes = 4 * (n * k * (dim_x + d[0] + dim_f) + sum(a * b for a, b in zip(d[:-1], d[1:]))
                  + w3j_pack.size + n * dim_mid)
    return flops, nbytes
