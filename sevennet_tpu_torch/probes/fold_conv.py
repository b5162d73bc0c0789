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
(``r4_fold_probe.py:167-187``).

The kernel's host side: :func:`plan` cuts the last MLP layer's columns into
tiles of 64 (four warps, each 16 channels of one instruction), lists each
warp's instruction record and each tile's Wigner rows, and sizes the shared
memory of a CTA (two warpgroups, a receiver each); :func:`lane_slots` is
where each lane holds each slot of a receiver, the order its K sum takes;
:func:`path_list` the instruction shapes the kernel is compiled for (its
header, ``csrc/probe_fold_conv_paths.cuh``, is :func:`path_header`'s text).
A call runs two kernels: the weights split into TF32 halves in the tensor
cores' register order, then the conv. :func:`cancelling_input` is an input
on which the three orders of the K sum round apart."""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

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

__all__ = ["VARIANTS", "N", "K", "TOL", "KERNEL_K", "sevennet0_conv", "fold_conv_plain",
           "fold_conv", "fold_conv_work", "plan", "lane_slots", "path_list", "path_header",
           "cancelling_input", "occupancy"]

VARIANTS = ("sliceadd", "group4", "group8")
N, K = 10016, 72   # r4_fold_probe.py:26 (A 32 there: the TPU's block, not needed here)
TOL = 1e-4
MAXL = 8           # MLP weight matrices
REC = 10           # ints of an instruction record of _tables
GREC = 8           # ints of a warp's record in the kernel's plan (FC_GREC)
HMAX = 64          # the widest hidden layer and n_basis the kernel takes (FC_HMAX)
UG = 16            # channels of an instruction a warp takes in a tile
KERNEL_K = (24, 72)  # the K the kernel is compiled for (probe_fold_conv_launch)
SMEM_SM = 233472   # shared memory of an H100 SM; 1 KB of it is reserved for each CTA
SMEM_LIMIT = 232448  # a CTA's (fused_conv_common.cuh SMEM_LIMIT)
_GROUP = {"group4": 4, "group8": 8}
PATHS_HEADER = "probe_fold_conv_paths.cuh"


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

    _fields_ = [(f, ctypes.c_void_p) for f in ("xg", "emb", "sh", "w3j", "gtab", "ttab", "frag",
                                               "out")] + [
        ("w", ctypes.c_void_p * MAXL), ("inv_sqrt", ctypes.c_float * MAXL),
        ("dims", ctypes.c_int * (MAXL + 1))] + [
        (f, ctypes.c_int) for f in ("nl", "N", "K", "dim_x", "dim_f", "dim_mid", "n_tiles",
                                    "hk", "nbk", "tw_rows")] + [
        ("act_cst", ctypes.c_float)]


@lru_cache(maxsize=None)
def _tables(conv: ConvTPSpec):
    """(instr, w3j_pack, dim_mid, itab): the port's instruction tables and a
    walk of their terms: REC-int records (x_start, d1, d3, mul, w_start,
    g_start, u_off, u_tot, where the row starts lie, first Wigner row: an
    instruction's rows are consecutive), then per instruction the d3 + 1
    starts of each output row's (m, r) pairs, then the pairs, each row's in
    the table's order (m's, which the kernel's compiled paths follow)."""
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


def _mask(ins) -> int:
    """Bit m d3 + p of an instruction's pairs (m, p)."""
    return sum(1 << (m * ins["d3"] + p) for m, p, _ in ins["mp"])


@lru_cache(maxsize=None)
def path_list():
    """The instruction shapes the kernel is compiled for, ``(d1, d3, mask)``
    (bit ``m d3 + p`` set where the pair (m, p) has a Wigner row): those of
    SevenNet-0's layer, every path of x, filter and output irreps of l <= 2,
    in its instructions' order. An instruction's pairs are in (m, p) order,
    its Wigner rows consecutive in that order, so that a pair's row is its
    instruction's first plus its rank in the mask."""
    conv, _ = sevennet0_conv()
    out = []
    for ins in _tables(conv)[0]:
        key = (ins["d1"], ins["d3"], _mask(ins))
        if key not in out:
            out.append(key)
    return tuple(out)


def path_header() -> str:
    """The text of ``csrc/probe_fold_conv_paths.cuh``: :func:`path_list` as
    the X-macro ``FC_PATHS(X)``, ``X(id, d1, d3, mask)`` per path."""
    rows = [f"  X({i}, {d1}, {d3}, 0x{mask:x}ull)" for i, (d1, d3, mask) in enumerate(path_list())]
    return "\n".join([
        "// The instruction shapes of the conv fold kernel (probe_fold_conv.cu): path id,",
        "// x components d1, output components d3, and bit m d3 + p set where the pair",
        "// (m, p) has a Wigner row. Written by probes/fold_conv.py:path_header();",
        "// tests/test_torch_probe_plans.py holds this file to it.",
        "#pragma once",
        "",
        f"#define FC_NPATH {len(rows)}",
        "#define FC_PATHS(X) \\",
        " \\\n".join(rows),
        ""])


def _sa_top(c: int):
    """The top of the sliceadd fold over c odd-part sums S_0 .. S_{c-1}
    (``_fold_sliceadd``: add the last onto the first while the count is
    odd, halve while it is even) as a post-order walk: the sums' order,
    the additions after each, the stack's size before each is pushed, the
    stack's depth (``csrc/probe_fold_conv.cu:sa_top``)."""
    kids, cur, nid = {}, list(range(c)), c
    while len(cur) > 1:
        if len(cur) % 2 == 0:
            h = len(cur) // 2
            for k in range(h):
                kids[nid] = (cur[k], cur[k + h])
                cur[k] = nid
                nid += 1
            cur = cur[:h]
        else:
            kids[nid] = (cur[0], cur[-1])
            cur[0] = nid
            nid += 1
            cur = cur[:-1]
    order, pops, sp, depth, size = [], [], [], 0, 0

    def walk(v):
        nonlocal depth, size
        if v < c:
            order.append(v)
            pops.append(0)
            sp.append(size)
            size += 1
            depth = max(depth, size)
            return
        walk(kids[v][0])
        walk(kids[v][1])
        pops[-1] += 1
        size -= 1

    walk(cur[0])
    return order, pops, sp, depth


def _ctz(k: int) -> int:
    return (k & -k).bit_length() - 1


def _bitrev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def lane_slots(k: int, variant: str):
    """(4, P) slots: where lane q of a warp (q = lane mod 4) holds each slot of
    a receiver, position i of its K / 4 (a padded last position is -1), the
    order in which it adds them; the tensor cores' column of position i is
    8 (i // 2) + 2 q + i % 2 (``csrc/probe_fold_conv.cu:FcPos``).

    ``group4``: lane q the sum of slots q mod 4, position i group i; ``group8``
    lane q the sums q and q + 4, position 2 g + e group g of sum q + 4 e; both
    in the script's order, the kg sums halved across lanes (lane q with q ^ 2,
    then q ^ 1). ``sliceadd``: K = c 2^a (a >= 2); the first a halvings sum
    each S_r over slots r + c b, b < 2^a, top bit first: lane q holds b = q
    + 4 t (t < 2^(a-2), leaves in bit-reversed order of t, summed as a
    binary counter), then b's bits 1 and 0 across lanes (q ^ 2, q ^ 1); the
    S_r come in :func:`_sa_top`'s order."""
    np_ = -(-k // 8) * 8
    out = np.full((4, np_ // 4), -1, np.int64)
    for q in range(4):
        for i in range(k // 4):
            if variant == "group4":
                out[q, i] = 4 * i + q
            elif variant == "group8":
                out[q, i] = 8 * (i // 2) + 4 * (i % 2) + q
            else:
                a = _ctz(k)
                c, t = k >> a, 1 << (a - 2)
                r = _sa_top(c)[0][i // t]
                out[q, i] = r + c * (q + 4 * _bitrev(i % t, a - 2))
    return out


class Plan(NamedTuple):
    """The kernel's launch plan for one layer, K and variant (:func:`plan`)."""

    np_: int           # wgmma N: a receiver's slots rounded up to 8 (the positions)
    gtab: np.ndarray   # per tile and warp (path, x_start, mul, u0, g_start + u_off, u_tot,
    #                    first Wigner row - the tile's, w_start); path -1: no work
    ttab: np.ndarray   # per tile (first Wigner row, rows)
    hk: int            # k of the hidden activations (8 ceil(widest hidden / 8))
    nbk: int           # k of emb (8 ceil(n_basis / 8))
    tw_rows: int       # rows of the tmp window (the widest tile's)
    carve: int         # floats of shared memory a warpgroup
    smem: int          # bytes of shared memory a CTA (two warpgroups)
    ctas_per_sm: int   # CTAs an SM by shared memory
    frag: int          # floats of the split weights (hidden layers, then W3's tiles)
    slots: np.ndarray  # lane_slots(k, variant)

    @property
    def n_tiles(self) -> int:
        return len(self.ttab) // 2


def _path_of(ins) -> int:
    key = (ins["d1"], ins["d3"], _mask(ins))
    paths = path_list()
    return paths.index(key) if key in paths else -1


@lru_cache(maxsize=None)
def plan(conv: ConvTPSpec, mlp_dims, k: int, variant: str) -> Plan:
    """Tiles of the last MLP layer's columns: each instruction's channels in
    groups of 16 (a warp; an instruction of fewer channels is padded), the
    instructions in the order of their x block (x_start, then their own),
    four groups a tile (the last tile padded with empty groups); a tile's
    tmp window is its instructions' Wigner rows, first to last. A
    warpgroup holds for its receiver the last hidden layer (hi and lo, the
    wgmma B operand), sh and one tile's tmp window, which emb's hi and lo
    share before the first tile."""
    instr = _tables(conv)[0]
    mlp_dims = tuple(mlp_dims)
    np_ = -(-k // 8) * 8
    order = sorted(range(len(instr)), key=lambda i: (instr[i]["x_start"], i))
    groups = [(i, u0) for i in order for u0 in range(0, instr[i]["mul"], UG)]
    groups += [(-1, 0)] * (-len(groups) % 4)
    gtab, ttab = [], []
    for t in range(0, len(groups), 4):
        ins_t = [instr[i] for i, _ in groups[t: t + 4] if i >= 0]
        r_lo = min(min(r for *_, r in ins["mp"]) for ins in ins_t)
        r_hi = max(max(r for *_, r in ins["mp"]) + 1 for ins in ins_t)
        ttab += [r_lo, r_hi - r_lo]
        for i, u0 in groups[t: t + 4]:
            if i < 0:
                gtab += [-1] + [0] * (GREC - 1)
                continue
            ins = instr[i]
            gtab += [_path_of(ins), ins["x_start"], ins["mul"], u0, ins["g_start"] + ins["u_off"],
                     ins["u_tot"], min(r for *_, r in ins["mp"]) - r_lo, ins["w_start"]]
    hidden = mlp_dims[1:-1]
    hk = -(-max(hidden) // 8) * 8
    nbk = -(-mlp_dims[0] // 8) * 8
    tw_rows = max(ttab[1::2])
    dim_f = conv.irreps_filter.dim
    carve = 2 * np_ * hk + np_ * dim_f + max(np_ * tw_rows, 2 * np_ * nbk)
    carve = -(-carve // 32) * 32
    smem = 2 * 4 * carve
    ks = [-(-d // 8) for d in mlp_dims[:-1]]
    frag = 1024 * (sum(ks[:-1]) + len(ttab) // 2 * ks[-1])
    return Plan(np_, np.asarray(gtab, np.int32), np.asarray(ttab, np.int32), hk, nbk, tw_rows,
                carve, smem, SMEM_SM // (smem + 1024), frag, lane_slots(k, variant))




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


def _check_kernel(conv, mlp_dims, k: int, variant: str = "sliceadd"):
    """What the kernel takes: K of :data:`KERNEL_K`; n_basis and every hidden
    width at most :data:`HMAX` (one 64-row wgmma tile a hidden layer), 1 to
    ``MAXL - 1`` hidden layers; instructions of :func:`path_list`'s shapes
    (l <= 2) whose multiplicities, x columns and dim_x are even (x read two
    channels at a time); a carve that fits a CTA."""
    if k not in KERNEL_K:
        raise ValueError(f"the kernel is compiled for K in {KERNEL_K}, got {k}")
    if not 1 <= len(mlp_dims) - 2 < MAXL:
        raise ValueError(f"the kernel takes 1 to {MAXL - 1} hidden layers, got {mlp_dims}")
    if max(mlp_dims[:-1]) > HMAX:
        raise ValueError(f"the kernel takes n_basis and hidden widths of at most {HMAX}, got "
                         f"{mlp_dims}")
    instr = _tables(conv)[0]
    bad = [(ins["d1"], ins["d3"]) for ins in instr if _path_of(ins) < 0]
    if bad:
        raise ValueError(f"the kernel is compiled for instructions of l <= 2 "
                         f"({len(path_list())} shapes); got shapes (d1, d3) {bad}")
    if any(ins["mul"] % 2 or ins["x_start"] % 2 for ins in instr) or conv.irreps_x.dim % 2:
        raise ValueError(f"the kernel takes even multiplicities and x columns; got "
                         f"{[ins['mul'] for ins in instr]}, dim_x {conv.irreps_x.dim}")
    if plan(conv, tuple(mlp_dims), k, variant).smem > SMEM_LIMIT:
        raise ValueError(f"a CTA's shared memory, {plan(conv, tuple(mlp_dims), k, variant).smem} "
                         f"bytes, exceeds {SMEM_LIMIT}")


def _args(conv, mlp_dims, xg, emb, sh, ws, w3j, k, variant, out, frag, tabs):
    pl = plan(conv, tuple(mlp_dims), k, variant)
    _, _, dim_mid, _ = _tables(conv)
    args = _FoldConvArgs(xg.data_ptr(), emb.data_ptr(), sh.data_ptr(), w3j.data_ptr(),
                         tabs[0].data_ptr(), tabs[1].data_ptr(), frag.data_ptr(), out.data_ptr())
    for i, w in enumerate(ws):
        args.w[i] = w.data_ptr()
        args.inv_sqrt[i] = 1.0 / math.sqrt(w.shape[0])
    for i, d in enumerate(mlp_dims):
        args.dims[i] = d
    args.nl, args.N, args.K = len(ws), xg.shape[0] // k, k
    args.dim_x, args.dim_f = xg.shape[1], sh.shape[1]
    args.dim_mid, args.n_tiles = dim_mid, pl.n_tiles
    args.hk, args.nbk, args.tw_rows = pl.hk, pl.nbk, pl.tw_rows
    args.act_cst = NORMALIZE2MOM_CST["silu"]
    return args


def fold_conv(conv: ConvTPSpec, xg, emb, sh, ws, w3j, k: int = K, variant: str = "sliceadd",
              plain: bool = False):
    """``r4_fold_probe.py:make(variant)``'s function, receiver-major, ``(N,
    dim_mid)``. CUDA tensors: the ``probe_fold_conv`` kernel of the variant
    (after the weights' split); ``plain=True``: :func:`fold_conv_plain`."""
    ws = list(ws)
    mlp_dims = (ws[0].shape[0], *(w.shape[1] for w in ws)) if ws else ()
    _check(conv, mlp_dims, xg, emb, sh, ws, w3j, k, variant)
    if check_device(plain, xg, emb, sh, w3j, *ws):
        return fold_conv_plain(conv, xg, emb, sh, ws, w3j, k, variant)
    _check_kernel(conv, mlp_dims, k, variant)
    pl = plan(conv, tuple(mlp_dims), k, variant)
    out = torch.empty(xg.shape[0] // k, _tables(conv)[2], dtype=torch.float32, device=xg.device)
    frag = torch.empty(pl.frag, dtype=torch.float32, device=xg.device)
    args = _args(conv, mlp_dims, xg, emb, sh, ws, w3j, k, variant, out, frag,
                 _device_plan(conv, tuple(mlp_dims), k, variant, xg.device))
    call("probe_fold_conv", "probe_fold_conv_launch", ctypes.c_int(VARIANTS.index(variant)), args,
         stream(xg.device))
    fold_conv.launches += 1
    fold_conv.by_variant[variant] += 1
    return out


fold_conv.launches = 0
fold_conv.by_variant = dict.fromkeys(VARIANTS, 0)


@lru_cache(maxsize=None)
def _device_plan(conv, mlp_dims, k, variant, device):
    pl = plan(conv, mlp_dims, k, variant)
    return torch.as_tensor(pl.gtab, device=device), torch.as_tensor(pl.ttab, device=device)


def occupancy(conv: ConvTPSpec, mlp_dims, k: int, variant: str, device) -> dict:
    """The kernel of ``variant`` at this layer and K on ``device``: shared
    memory a CTA (bytes), CTAs an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers a thread and local memory bytes (``cudaFuncGetAttributes``)."""
    mlp_dims = tuple(mlp_dims)
    _check_kernel(conv, mlp_dims, k, variant)
    dev = torch.device(device)
    nk = 8 * k
    z = torch.zeros(1, device=dev)
    xg = torch.zeros(nk, conv.irreps_x.dim, device=dev)
    ws = [torch.zeros(a, b, device=dev) for a, b in zip(mlp_dims[:-1], mlp_dims[1:])]
    emb = torch.zeros(nk, mlp_dims[0], device=dev)
    sh = torch.zeros(nk, conv.irreps_filter.dim, device=dev)
    w3j = torch.as_tensor(_tables(conv)[1], device=dev)
    args = _args(conv, mlp_dims, xg, emb, sh, ws, w3j, k, variant, z, z,
                 _device_plan(conv, mlp_dims, k, variant, dev))
    res = (ctypes.c_int * 4)()
    call("probe_fold_conv", "probe_fold_conv_occupancy", ctypes.c_int(VARIANTS.index(variant)),
         args, res)
    return dict(smem=res[0], ctas_per_sm=res[1], registers=res[2], local_bytes=res[3])


def cancelling_input(n: int, k: int, conv: ConvTPSpec, seed: int, device, n_basis: int = 8):
    """``(xg, emb, sh)`` of n receivers of K slots on which the three orders
    of the K sum round apart (the fold's ``fold.cancelling_input`` for the
    conv): every slot of a receiver has the receiver's one emb row and one
    sh row, so that w and tmp are the same across its slots, and xg rows of
    small values (0.5 N(0, 1)) but for two slots a and b = a + 8 of each
    receiver (a at random), whose m = 0 column of every x irrep holds +2^60
    and -2^60. A term of those is exactly 2^60 (x w) tmp, so the two cancel
    exactly wherever they meet, and a partial sum that holds one of them
    absorbs every small term added to it (2^60 times |tmp| is far above 2^24
    times the small ones): each order keeps a different set of the small
    terms, whatever rounding the MLP had. a and b share their residue mod 8
    (group8 loses slot a's and b's own small terms, group4 also slot a +
    4's, sliceadd whole subtrees). A kernel held within TOL of its own
    variant's plain version on this input sums in that variant's order."""
    rng = np.random.default_rng(seed)
    dim_x, dim_f = conv.irreps_x.dim, conv.irreps_filter.dim
    emb = np.repeat(rng.normal(size=(n, 1, n_basis)) * 0.3, k, axis=1)
    sh = np.repeat(rng.normal(size=(n, 1, dim_f)) * 0.5, k, axis=1)
    xg = rng.normal(size=(n, k, dim_x)) * 0.5
    cols = [c for sl, mi in zip(conv.irreps_x.slices(), conv.irreps_x)
            for c in range(sl.start, sl.start + mi.mul)]  # m = 0: x_start + u
    for i in range(n):
        a = int(rng.integers(0, k - 8)) if k > 8 else 0
        xg[i, a, cols] = 2.0 ** 60
        xg[i, min(a + 8, k - 1), cols] = -(2.0 ** 60)
    return tuple(torch.tensor(v.reshape(n * k, -1), dtype=torch.float32, device=device)
                 for v in (xg, emb, sh))


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
