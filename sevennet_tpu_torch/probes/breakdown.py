"""Breakdown probe of the emb/sh fused conv forward (``csrc/probe_breakdown.cu``,
``probe_breakdown_k.cu``, ``probe_breakdown_feat.cu``; the kernel template in
``csrc/probe_breakdown.cuh``), the counterpart of the TPU probe
``scripts_dev/r2_fused_breakdown.py``: ``build`` (pallas_call at ``:170``),
``build_feat`` (``:262``) and ``build_featroll`` (``:343``).

Each variant (:data:`VARIANTS`) is a partial or whole forward conv of B4
fwd (:func:`~sevennet_tpu_torch.ops.fused_conv.fused_conv_fwd_embsh`) on
the gathered sender rows: the radial MLP on ``emb`` (``w``), ``tmp = sh
w3j_pack^T``, the uvu terms ``(xg w) tmp[r]`` per (instruction, m, p), the
sum over each receiver's K slots, the stores. ``build``'s variants
(``:59-157``, run at ``:363-390``): ``mlp`` / ``mlp_hi`` (the MLP, slot 0's
``w`` stored), ``tmp`` (the MLP and ``tmp``, slot 0's ``tmp``), ``tp`` (every
slot's messages added over (instruction, p) into 128 padded lanes, slot 0's
row), ``tpred``, ``tpredk``, ``tpredmm``, ``tpredmm_amaj`` (the same per
receiver, K summed by a reshape-sum, the ``kred`` halving chain, a 0/1
product on k-major or a-major rows), ``storek`` (``kred``, each
(instruction, p) stored into the aligned 128 columns ``(g_start // 128) 128
mod (dim_mid - 128)``, last writer wins; columns no window covers are 0
here), ``full`` / ``full_hi`` (the conv, reshape-sum), ``fullk``,
``fullmm``; ``build_feat`` (``:201-250``): ``feat_full`` (the conv, the
0/1 product on feature-major tiles) and ``feat_transpose`` (slot 0's
``xg`` row); ``build_featroll`` (``:273-332``): ``featroll_full`` (the
conv, the roll halving chain; the script's A 32 run at ``:437`` is the same
function) and ``featroll_mlp`` (its ``mlp_only``). ``_hi`` and the
``feat*`` variants run the script's dots at ``Precision.HIGHEST``, the
rest at its default precision (:data:`ONE_PASS`).

What each computes is the TPU kernel's function at A = 1 receiver per grid
step on receiver-major rows, the port's one CTA per receiver: there k-major
and a-major rows are the same and every K-sum method gives the true
per-receiver sum. (The script fed a-major rows to ``fullk``, ``tpredk``,
``storek``, ``tpredmm`` and ``fullmm`` at A = 16, whose chains then add
slots of different receivers: a timing artefact, not reproduced.) Edge
arrays are receiver-major: ``xg (N K, dim_x)``, ``emb (N K, n_basis)``,
``sh (N K, dim_f)``; out ``(N, dim_mid)``.

The wrapper takes the layer's emb/sh-mode op (``fc.conv_op(conv, mlp)``)
and launches the variant's instantiation of B4 fwd's kernel on CUDA
tensors, with ``x = xg`` and the identity gather ``src = arange(N K).view(N,
K)``, so that ``full_hi`` is B4 fwd itself on the same inputs; it raises on
CPU tensors unless ``plain=True`` (the plain version: the script's
operations as torch ops in its order, on any device; TF32 must be off for
its matmuls on the card). It counts its launches in ``.launches`` and, per
variant, in ``.by_variant``. Kernel against plain: :data:`TOL` of max
|plain| at fp32 accuracy (the conv's limit), :data:`TOL_ONE_PASS` for the
one-pass variants, whose MLP layers, ``W3`` product and ``tmp`` run one
TF32 pass (the TPU's one bf16 pass at default precision): four rounded
products on the way to a message, each within 2^-10; ``feat_transpose``
bitwise. Timing: ``diff_ms(fn, *KNOCK_TIME)``, the differential of 9 and 3
calls, best of 3 (``r3_fwd_knockout.py:142-162``; ``r2_fused_breakdown.py``
differs 120 and 20 calls)."""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops import fused_conv as fc
from ..ops.activations import NORMALIZE2MOM_CST
from ..ops.kernels import call
from ._lib import check_device, stream
from .fold import kfold_plain
from .fold_conv import _mask, path_list

__all__ = ["VARIANTS", "ONE_PASS", "N", "K", "LANES", "TOL", "TOL_ONE_PASS", "KNOCK_TIME",
           "EDGE_VW", "breakdown_plain", "breakdown", "breakdown_work", "storek_map", "tol",
           "edge_plan"]

VARIANTS = ("mlp", "mlp_hi", "tmp", "tp", "tpred", "full", "full_hi", "tpredk", "storek",
            "fullk", "tpredmm", "tpredmm_amaj", "fullmm", "feat_full", "feat_transpose",
            "featroll_full", "featroll_mlp")
# at the script's default precision: one TF32 pass in the MLP, W3 and tmp
ONE_PASS = ("mlp", "tmp", "tp", "tpred", "full", "tpredk", "storek", "fullk", "tpredmm",
            "tpredmm_amaj", "fullmm")
N, K = 3072, 96    # r2_fused_breakdown.py:22 (A 16 there: the TPU's block)
LANES = 128        # the TPU's lane width: tp and tpred* add into 128 padded columns
TOL = 1e-4
TOL_ONE_PASS = 2.0 ** -8
KNOCK_TIME = (3, 9, 3)   # (n1, n2, tries) of diff_ms
# variant -> (library, kernel number: csrc/probe_breakdown.cuh, PB_*); a
# library's C entry is <library>_launch
_KERNEL = {v: ("probe_breakdown", i) for i, v in enumerate(VARIANTS[:7])}
_KERNEL.update({v: ("probe_breakdown_k", i) for v, i in (
    ("tpredk", 7), ("storek", 8), ("fullk", 9), ("tpredmm", 10), ("tpredmm_amaj", 10),
    ("fullmm", 11))})
_KERNEL.update({v: ("probe_breakdown_feat", i) for v, i in (
    ("feat_full", 12), ("feat_transpose", 13), ("featroll_full", 14), ("featroll_mlp", 15))})
_KSUM = {"tpred": "sum", "full": "sum", "full_hi": "sum", "tpredk": "kred", "storek": "kred",
         "fullk": "kred", "tpredmm": "mm", "tpredmm_amaj": "mm", "fullmm": "mm",
         "feat_full": "mm", "featroll_full": "kred"}
_WITNESS = {"mlp": "w", "mlp_hi": "w", "featroll_mlp": "w", "tmp": "tmp",
            "feat_transpose": "x"}
# the variants with the per-edge uvu product (PB_UVU_EDGE) -> the mapping of
# its tasks (edge_plan): the most channels a lane holds on edge-major tiles,
# 0 for the feature-major tiles. At most 2 under the 0/1 sum (two staged
# edges must fit a warp's share of the stage) and the halving chain (its
# partial sums must fit the registers); tp 1, whose per-edge atomics into
# the lanes conflict 4 ways at 4 channels a lane; the rest as measured
# best on an H100 (PERF.md).
EDGE_VW = {"tp": 1, "tpred": 2, "tpredk": 2, "storek": 2, "fullk": 2, "tpredmm": 2,
           "tpredmm_amaj": 2, "fullmm": 2, "feat_full": 0, "featroll_full": 0}
EDGE_WARPS = fc.UVU_WARPS  # csrc NWARP
EDGE_RUNS = 2              # csrc PB_ET_RUNS: the table's header ints before the warp runs
FEAT_CHANNELS = 8          # channels of a feature-major task


def tol(variant: str) -> float:
    """Kernel against plain, of max |plain| (0: bitwise)."""
    if variant == "feat_transpose":
        return 0.0
    return TOL_ONE_PASS if variant in ONE_PASS else TOL


class EdgePlan(NamedTuple):
    """The per-edge product's tasks (``csrc/probe_breakdown.cuh:uvu_edges``)
    of a layer: ``tasks`` ``(instruction, first channel, path, channels a
    lane)`` in table order, ``runs`` the first task of each warp (and the
    end) per column block, ``costs`` each task's, ``table`` the ints the
    kernel reads."""

    tasks: Tuple[Tuple[int, int, int, int], ...]
    runs: Tuple[Tuple[int, ...], ...]
    costs: Tuple[int, ...]
    table: np.ndarray


def edge_vw(ins, w0: int, most: int) -> int:
    """Channels a lane of an edge-major task of instruction ``ins`` (its
    column of w in its block ``w0``): the most of 4, 2, 1 up to ``most``
    whose 32 lanes the multiplicity fills and whose 4-, 8- or 16-byte reads
    of x and w stay aligned."""
    for v in (4, 2, 1):
        if (v <= most and 32 * v <= max(ins["mul"], 32) and ins["mul"] % v == 0
                and ins["x_start"] % v == 0 and w0 % v == 0):
            return v
    return 1


def edge_cost(ins, vw: int) -> int:
    """A task's cost on a tile, per edge: on edge-major tiles (``vw``
    channels a lane) its shared-memory reads (w, x, tmp's broadcasts), fp32
    operations and a staged message per (p, channel); on feature-major
    tiles (``vw`` 0) the same for 8 channels over 4 steps."""
    d1, d3, nt = ins["d1"], ins["d3"], len(ins["mp"])
    if vw == 0:
        return 4 * (2 + 2 * d1 + nt + d3) + nt
    return vw * (1 + d1) + nt + vw * (d1 + nt) + vw * d3


@lru_cache(maxsize=None)
def edge_plan(op, vw: int) -> EdgePlan:
    """The per-edge product's task table of layer ``op`` for the mapping
    ``vw`` (:data:`EDGE_VW`): per column block, a task per instruction's
    ``32 vw`` channels (edge-major tiles, :func:`edge_vw` channels a lane)
    or 8 (feature-major, ``vw`` 0), balanced over the warps by
    :func:`edge_cost` (``fused_conv._balanced``: the costliest first, each
    to the least loaded warp).
    Raises ValueError where an instruction's shape is not one the kernel is
    compiled for (``fold_conv.path_list``: the paths of l <= 2) or the
    layer takes more than one CTA a receiver."""
    instr = fc._instr_tables(op.conv)[0]
    if len(op.plan.ranks) != 1:
        raise ValueError("the breakdown probes take a layer of one CTA a receiver")
    paths = {key: i for i, key in enumerate(path_list())}
    tasks, runs, costs = [], [], []
    for ks in op.plan.blocks:
        bt, w0 = [], 0
        for k in ks:
            ins = instr[k]
            key = (ins["d1"], ins["d3"], _mask(ins))
            if key not in paths:
                raise ValueError(f"instruction {k} (d1 {ins['d1']}, d3 {ins['d3']}): the per-edge "
                                 "product is compiled for the paths of l <= 2")
            v = edge_vw(ins, w0, vw) if vw else 0
            width = 32 * v if v else FEAT_CHANNELS
            bt += [(k, u0, paths[key], v) for u0 in range(0, ins["mul"], width)]
            w0 += ins["mul"]
        order, starts = fc._balanced(bt, [edge_cost(instr[t[0]], t[3]) for t in bt])
        runs.append(tuple(len(tasks) + int(s_) for s_ in starts))
        tasks += order
        costs += [edge_cost(instr[t[0]], t[3]) for t in order]
    head = [0, len(tasks)] + [r for rs in runs for r in rs]
    head += [0] * (-len(head) % 4)
    head[0] = len(head)
    table = np.asarray(head + [v for t in tasks for v in t], np.int32)
    return EdgePlan(tuple(tasks), tuple(runs), tuple(costs), table)


@lru_cache(maxsize=None)
def _device_edge_plan(op, vw: int, device: torch.device):
    return torch.as_tensor(edge_plan(op, vw).table, device=device)


def mlp_plain(emb, ws):
    """The script's radial MLP (``:68-72``): each layer ``h W * (1 /
    sqrt(fan_in))``, silu times the normalization constant between layers."""
    cst = NORMALIZE2MOM_CST["silu"]
    h = emb
    for li, w in enumerate(ws):
        h = (h @ w) * (1.0 / math.sqrt(w.shape[0]))
        if li < len(ws) - 1:
            h = torch.nn.functional.silu(h) * cst
    return h


def terms_plain(ins, xg, h, tmp):
    """``by_p`` of one instruction (``:104-112``): per output row p, the sum
    of its terms ``(xg[:, x0 + m mul ..] w[:, w0 ..]) tmp[:, r]`` in the
    table's order, ``(rows, mul)``; a dict in the order p first appears."""
    mul, x0, w0 = ins["mul"], ins["x_start"], ins["w_start"]
    wb = h[:, w0:w0 + mul]
    xw = [xg[:, x0 + m * mul:x0 + (m + 1) * mul] * wb for m in range(ins["d1"])]
    by_p = {}
    for m, p, r in ins["mp"]:
        term = xw[m] * tmp[:, r:r + 1]
        by_p[p] = term if p not in by_p else by_p[p] + term
    return by_p


def ksum_plain(acc, k: int, how: str):
    """The sum over each receiver's k slots of ``acc (n k, mul)``: the
    script's reshape-sum, ``kred`` (the halving chain, at A = 1 the roll
    chain of ``build_featroll`` too) or ``mmred`` (the 0/1 matrix product,
    fp32)."""
    v = acc.view(-1, k, acc.shape[1])
    if how == "sum":
        return v.sum(1)
    if how == "kred":
        return kfold_plain(v, 1)
    ones = torch.ones(1, k, dtype=acc.dtype, device=acc.device)
    return torch.matmul(ones, v)[:, 0]


@lru_cache(maxsize=None)
def storek_map(conv) -> np.ndarray:
    """storek's stores (``:132-139``) as a map of the ``dim_mid`` output
    columns: the grouped column whose K sum each takes from the last window
    written over it, -1 for a window's zero padding, -2 for a column no
    window covers (the TPU leaves it unwritten; the port writes 0)."""
    instr, _, dim_mid, _ = fc._instr_tables(conv)
    omap = np.full(dim_mid, -2, np.int64)
    for ins in instr:
        col = (ins["g_start"] // LANES) * LANES % (dim_mid - LANES)
        for p in dict.fromkeys(p for _, p, _ in ins["mp"]):
            start = ins["g_start"] + p * ins["u_tot"] + ins["u_off"]
            omap[col:col + LANES] = -1
            omap[col:col + ins["mul"]] = np.arange(start, start + ins["mul"])
    return omap.astype(np.int32)


def breakdown_plain(op, xg, emb, sh, ws, k: int, variant: str):
    """The variant's function (the script's operations in torch, its
    order), receiver-major, ``(N, dim_mid)``."""
    instr, w3j_pack, dim_mid, numel = fc._instr_tables(op.conv)
    n = xg.shape[0] // k
    out = torch.zeros(n, dim_mid, dtype=torch.float32, device=xg.device)
    if variant == "feat_transpose":
        out[:, :xg.shape[1]] = xg.view(n, k, -1)[:, 0]
        return out
    h = mlp_plain(emb, ws)
    if _WITNESS.get(variant) == "w":
        out[:, :numel] = h.view(n, k, -1)[:, 0]
        return out
    tmp = sh @ torch.as_tensor(w3j_pack, device=xg.device).t()
    if variant == "tmp":
        out[:, :tmp.shape[1]] = tmp.view(n, k, -1)[:, 0]
        return out
    lanes = torch.zeros(n * k if variant == "tp" else n, LANES, dtype=torch.float32,
                        device=xg.device)
    how = _KSUM.get(variant)
    for ins in instr:
        mul = ins["mul"]
        by_p = terms_plain(ins, xg, h, tmp)
        for p, acc in by_p.items():
            if variant == "tp":
                lanes[:, :mul] += acc
                continue
            red = ksum_plain(acc, k, how)
            if variant.startswith("tpred"):
                lanes[:, :mul] += red
            elif variant == "storek":
                col = (ins["g_start"] // LANES) * LANES % (dim_mid - LANES)
                out[:, col:col + LANES] = 0.0
                out[:, col:col + mul] = red
            else:
                start = ins["g_start"] + p * ins["u_tot"] + ins["u_off"]
                out[:, start:start + mul] = red
    if variant == "tp":
        out[:, :LANES] = lanes.view(n, k, -1)[:, 0]
    elif variant.startswith("tpred"):
        out[:, :LANES] = lanes
    return out


def check_inputs(op, xg, emb, sh, ws, k: int, variant: str, variants):
    """Raises ValueError on a variant not in ``variants`` or inputs the
    variant's kernel or its script's pads do not take."""
    if variant not in variants:
        raise ValueError(f"variant {variant!r}: one of {variants}")
    if op.embed is not None:
        raise ValueError("the probe takes the layer's emb/sh-mode op: fc.conv_op(conv, mlp)")
    for name, v in (("xg", xg), ("emb", emb), ("sh", sh), *((f"ws[{i}]", w)
                                                          for i, w in enumerate(ws))):
        if v.dtype != torch.float32 or not v.is_contiguous() or v.dim() != 2:
            raise ValueError(f"{name}: a contiguous 2-d float32 tensor, got {v.dtype} "
                             f"{tuple(v.shape)}")
    nk = xg.shape[0]
    if k <= 0 or nk == 0 or nk % k:
        raise ValueError(f"xg {tuple(xg.shape)}: a whole number of receivers of K = {k} slots")
    dims = op.mlp_spec.dims
    want = {"xg": (nk, op.dim_x), "emb": (nk, op.n_basis), "sh": (nk, op.dim_f)}
    for name, v in (("xg", xg), ("emb", emb), ("sh", sh)):
        if tuple(v.shape) != want[name]:
            raise ValueError(f"{name}: {want[name]}, got {tuple(v.shape)}")
    if tuple(tuple(w.shape) for w in ws) != tuple(zip(dims[:-1], dims[1:])):
        raise ValueError(f"ws: the radial MLP {dims}, got {[tuple(w.shape) for w in ws]}")
    instr = fc._instr_tables(op.conv)[0]
    if max(ins["mul"] for ins in instr) > LANES or op.dim_mid <= LANES:
        raise ValueError(f"the probes take multiplicities of at most {LANES} and more than "
                         f"{LANES} output columns (the script's lane pads), got "
                         f"{[ins['mul'] for ins in instr]}, dim_mid {op.dim_mid}")
    if max(op.dim_x, op.numel, op.R) > op.dim_mid:
        raise ValueError(f"the witnesses pad dim_x {op.dim_x}, numel {op.numel} and R {op.R} "
                         f"to dim_mid {op.dim_mid}")


@lru_cache(maxsize=None)
def _identity_src(n: int, k: int, device: torch.device):
    return torch.arange(n * k, dtype=torch.int32, device=device).view(n, k)


@lru_cache(maxsize=None)
def _device_omap(conv, device: torch.device):
    return torch.as_tensor(storek_map(conv), device=device)


def launch_args(op, xg, emb, sh, ws, k: int, code: int, omap=None, vw=None):
    """The C entry's arguments (ctypes values) of kernel ``code`` on checked
    CUDA tensors: B4 fwd's with ``x = xg`` and the identity gather, and for
    a per-edge variant (``vw``, :data:`EDGE_VW`) its task table
    (:func:`edge_plan`); and the ``(N, dim_mid)`` output they write."""
    n = xg.shape[0] // k
    src = _identity_src(n, k, xg.device)
    fc.check_conv_inputs(op, True, xg, src, emb, sh, ws)
    out = torch.empty(n, op.dim_mid, dtype=torch.float32, device=xg.device)
    itab, ftab = op.device_tables(xg.device)
    etab = None if vw is None else _device_edge_plan(op, vw, xg.device)
    args = (ctypes.c_int(code), op.dims(n, k), fc._ptr(xg), fc._ptr(src), fc._ptr(emb),
            fc._ptr(sh), fc._mlp_weights(ws), fc._ptr(itab), fc._ptr(ftab),
            ctypes.c_void_p(None if omap is None else omap.data_ptr()),
            ctypes.c_void_p(None if etab is None else etab.data_ptr()), fc._ptr(out),
            stream(xg.device))
    return args, out


def launch(op, xg, emb, sh, ws, k: int, lib: str, code: int, omap=None, vw=None):
    """Launches kernel ``code`` of probe library ``lib`` (its C entry
    ``<lib>_launch``) with :func:`launch_args`. Returns ``(N, dim_mid)``."""
    args, out = launch_args(op, xg, emb, sh, ws, k, code, omap, vw)
    call(lib, f"{lib}_launch", *args, on_load=fc.check_uvu_layout)
    return out


def breakdown(op, xg, emb, sh, ws, k: int = K, variant: str = "full", plain: bool = False):
    """``r2_fused_breakdown.py``'s variant's function, receiver-major, ``(N,
    dim_mid)``. CUDA tensors: its instantiation of B4 fwd's kernel;
    ``plain=True``: :func:`breakdown_plain`."""
    ws = list(ws)
    check_inputs(op, xg, emb, sh, ws, k, variant, VARIANTS)
    if check_device(plain, xg, emb, sh, *ws):
        return breakdown_plain(op, xg, emb, sh, ws, k, variant)
    lib, code = _KERNEL[variant]
    omap = _device_omap(op.conv, xg.device) if variant == "storek" else None
    out = launch(op, xg, emb, sh, ws, k, lib, code, omap, EDGE_VW.get(variant))
    breakdown.launches += 1
    breakdown.by_variant[variant] += 1
    return out


breakdown.launches = 0
breakdown.by_variant = dict.fromkeys(VARIANTS, 0)


def layer_counts(op):
    """Per-slot operation counts of the layer, as ``chip_smoke.py:work``
    counts B4 fwd's: the MLP's products (a sum of n products 2n - 1
    operations), ``tmp`` over the nonzeros of ``w3j_pack``, the uvu messages
    with the sums over m factored (2 per elementary term), and the MLP's
    weight floats."""
    d = op.mlp_spec.dims
    mlp = sum(b * (2 * a - 1) for a, b in zip(d[:-1], d[1:]))
    tmp = 2 * int((op.w3j_pack != 0).sum()) - op.R
    return dict(mlp=mlp, tmp=tmp, msg=2 * op.n_terms,
                weights=sum(a * b for a, b in zip(d[:-1], d[1:])))


def phase_work(op, n: int, k: int, *, mlp: str, tmp: bool, msg: bool, ksum: bool,
               lanes: str, reads_x: bool, one_pass: bool):
    """(flops, bytes, one-pass flops) of one call: what the phases do on all
    n k slots, as the script's operations do. ``mlp``: "full", "knock" (w =
    0.1 emb[:, 0], one product a slot) or "none"; ``tmp``; ``msg``: every
    slot's uvu messages; ``ksum``: each receiver's K sum of every output
    column (K - 1 adds), with ``msg``; ``lanes``: "edge" or "receiver" (the
    columns added over (instruction, p) into the widest multiplicity's
    lanes) or ""; ``one_pass``: the MLP and tmp products run one TF32 pass.
    Bytes: each input the phases read, once, and the (N, dim_mid) output."""
    c = layer_counts(op)
    nk = n * k
    mlp_f = {"full": c["mlp"], "knock": 1, "none": 0}[mlp] * nk
    tmp_f = c["tmp"] * nk if tmp else 0
    flops = mlp_f + tmp_f
    if msg:
        flops += c["msg"] * nk
    if ksum:
        flops += (k - 1) * op.dim_mid * n
    if lanes:
        widest = max(ins["mul"] for ins in fc._instr_tables(op.conv)[0])
        flops += (op.dim_mid - widest) * (nk if lanes == "edge" else n)
    nbytes = 4 * (nk * (op.dim_x if reads_x else 0) + (nk * op.n_basis if mlp != "none" else 0)
                  + (c["weights"] if mlp == "full" else 0)
                  + (nk * op.dim_f + op.w3j_pack.size if tmp else 0) + n * op.dim_mid)
    return flops, nbytes, (mlp_f + tmp_f) if one_pass else 0


def conv_work(op, n: int, k: int, one_pass: bool = False):
    """B4 fwd's function (``chip_smoke.py:work``'s ``fwd_embsh`` on xg):
    every slot's messages scaled by w and summed over the receiver's
    slots."""
    return phase_work(op, n, k, mlp="full", tmp=True, msg=True, ksum=True, lanes="",
                      reads_x=True, one_pass=one_pass)


def breakdown_work(op, variant: str, n: int, k: int):
    """(flops, bytes, one-pass flops) of the variant's call: its phases'
    own work, whatever the method (:func:`phase_work`); the conv variants
    that of B4 fwd's function."""
    one = variant in ONE_PASS
    wit = _WITNESS.get(variant)
    if wit == "x":
        return phase_work(op, n, k, mlp="none", tmp=False, msg=False, ksum=False, lanes="",
                          reads_x=True, one_pass=False)
    if wit is not None:
        return phase_work(op, n, k, mlp="full", tmp=wit == "tmp" or variant == "featroll_mlp",
                          msg=False, ksum=False, lanes="", reads_x=False, one_pass=one)
    if variant == "tp":
        return phase_work(op, n, k, mlp="full", tmp=True, msg=True, ksum=False, lanes="edge",
                          reads_x=True, one_pass=one)
    if variant.startswith("tpred"):
        return phase_work(op, n, k, mlp="full", tmp=True, msg=True, ksum=True,
                          lanes="receiver", reads_x=True, one_pass=one)
    return conv_work(op, n, k, one)
