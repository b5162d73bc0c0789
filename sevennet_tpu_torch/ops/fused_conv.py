"""Fused convolution of the dense ``(N, K)`` layout: radial MLP, uvu tensor
product and the sum over each receiver's neighbour slots, forward and
backward (PyTorch port of ``sevennet_tpu/ops/fused_conv.py``). Two modes,
as in the JAX package:

- vec mode (an :class:`EdgeEmbedSpec`): the kernels compute the radial
  embedding and the spherical harmonics from raw edge vectors
  (:func:`fused_conv_apply_vec`);
- emb/sh mode (``embed=None``): they take a precomputed embedding ``emb``
  and spherical harmonics ``sh`` (:func:`fused_conv_apply`), the path of
  models with unnormalized spherical harmonics and of
  ``SEVENNET_TPU_VEC=0``.

Hand-written CUDA kernels carry it on the card (``csrc/``):

- ``fused_conv_fwd`` (B1) and ``fused_conv_fwd_embsh`` (B4): replace the
  Pallas kernel ``make_fused_conv_fwd`` with ``embed`` set and with
  ``embed=None``; B4's kernel also serves ``dense_conv_pallas``
  (:mod:`.pallas_conv`, B6);
- ``fused_conv_bwd`` (B2) and ``fused_conv_bwd_embsh`` (B4 bwd): replace
  ``make_fused_conv_bwd2`` with ``param_grads=False``; B4's also serves
  ``make_fused_conv_bwd`` (B5), the round-2 factoring of the same pullback;
- ``fused_conv_bwd_pg`` / ``fused_conv_bwd_embsh_pg`` and
  ``param_grad_reduce`` (B2′ / B4′): the same with ``param_grads=True``, in
  two passes (per-edge records, then a reduction over all edges in a fixed
  order, ``csrc/pg_reduce.cu``); :func:`fused_conv_bwd` and
  :func:`fused_conv_bwd_embsh` with ``param_grads=True`` run both;
- ``fused_conv_bwd_slot`` (B3): replaces ``make_fused_conv_bwd2`` with
  ``out_slots > 1``: B2 on one row chunk, writing its ``dxg`` into a slot
  of the ring backward's rolling buffer (:class:`FusedConvChunked`);
  ``fused_conv_bwd_embsh_slot`` is B4 bwd's kernel entered the same way,
  the emb/sh ring's per-chunk kernel.

Large systems (``row_chunk`` of :func:`fused_conv_apply_vec` and
:func:`fused_conv_apply`) run the backward chunk by chunk, in either mode:
the ring backward (B3 / B4 bwd into a slot per chunk and a windowed mirror
gather) or the chunked scatter backward (B2 / B4 bwd per chunk and
``index_add_``); :func:`chunk_threshold` decides where chunking starts.
The ext conv (:func:`fused_conv_apply_ext`, :func:`fused_conv_apply_ext_vec`:
senders in an extended set of owned and ghost rows) always runs the
chunked scatter backward.

Each has a plain PyTorch twin with the same contract
(``*_plain``). The wrappers take the plain version only
for tensors on the CPU; for CUDA tensors they launch the kernel or raise.
Each wrapper counts its launches in ``.launches``.

Layouts follow the JAX package: features ``ir_mul``, conv output in the
grouped mid layout (:func:`~sevennet_tpu_torch.ops.dense_conv.mid_layout`),
edge arrays receiver-major (edge vectors ``(3, N*K)``, padded slots carrying
a sentinel vector past the cutoff; ``emb (N*K, n_basis)``, zero on padded
slots, and ``sh (N*K, dim_f)``). The TPU's k-major lane order stays behind.
The backward's ``dx`` is the mirror gather of the per-edge x-cotangents
plus a sum over K, in plain PyTorch, as the JAX package leaves it to XLA
(``sevennet_tpu/ops/fused_conv.py:1584-1590``).
"""

from __future__ import annotations

import ctypes
import itertools
import math
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..so3.spherical import monomials, sh_coefficients, sh_deriv_tables, spherical_harmonics
from ..so3.wigner import real_wigner_3j
from .activations import NORMALIZE2MOM_CST
from .dense_conv import mid_layout
from .mlp import ScalarMLPSpec, scalar_mlp_apply
from .radial import bessel_basis, poly_cutoff, xplor_cutoff
from .tensor_product import ConvTPSpec, conv_tp_apply

__all__ = [
    "EdgeEmbedSpec",
    "FusedConvOp",
    "conv_op",
    "chunk_threshold",
    "mirror_map_numpy",
    "mirror_map",
    "fused_conv_bwd_slot_plain",
    "fused_conv_bwd_slot",
    "fused_conv_bwd_embsh_slot_plain",
    "fused_conv_bwd_embsh_slot",
    "ring_slot",
    "FusedConvChunked",
    "edge_embedding_plain",
    "fused_conv_fwd_plain",
    "fused_conv_bwd_plain",
    "fused_conv_fwd",
    "fused_conv_bwd",
    "fused_conv_bwd_pg_records",
    "param_grad_reduce_plain",
    "param_grad_reduce",
    "fused_conv_bwd_vjp_plain",
    "FusedConvBwd",
    "FusedConvVec",
    "fused_conv_apply_vec",
    "fused_conv_fwd_embsh_plain",
    "fused_conv_bwd_embsh_plain",
    "fused_conv_bwd_embsh_vjp_plain",
    "check_conv_inputs",
    "launch_fused_conv_fwd",
    "fwd_launch_args",
    "bwd_launch_args",
    "check_uvu_layout",
    "fused_conv_fwd_embsh",
    "fused_conv_bwd_embsh",
    "fused_conv_bwd_embsh_pg_records",
    "FusedConvBwdEmbSh",
    "FusedConvEmbSh",
    "fused_conv_apply",
    "fused_conv_apply_ext",
    "fused_conv_apply_ext_vec",
]


@dataclass(frozen=True)
class EdgeEmbedSpec:
    """The edge embedding the vec-mode conv computes from raw edge vectors:
    Bessel radial basis times cutoff envelope, and real spherical harmonics.
    Padded edge slots must carry a sentinel vector with r > cutoff, so the
    clamped envelope zeroes them."""

    n_basis: int
    cutoff: float
    cutoff_kind: str   # "poly_cut" | "XPLOR"
    cutoff_arg: float  # p (poly) or cutoff_on (XPLOR)
    lmax: int

    @property
    def dim_f(self) -> int:
        return (self.lmax + 1) ** 2


def _instr_tables(conv: ConvTPSpec):
    """Static per-instruction metadata + the packed Wigner matrix (R, dim_f):
    one row per active (instruction, m, p) pair; ``tmp = w3j_pack @ sh``.
    The path weight is folded into the rows."""
    xs = conv.irreps_x.slices()
    fs = conv.irreps_filter.slices()
    layout, dim_mid = mid_layout(conv)

    rows: List[np.ndarray] = []
    instr = []
    w_off = 0
    dim_f = conv.irreps_filter.dim
    for i, j, k, pw in conv.instructions:
        mi_x = conv.irreps_x[i]
        mi_f = conv.irreps_filter[j]
        mi_o = conv.irreps_mid[k]
        d1, d3, mul = mi_x.ir.dim, mi_o.ir.dim, mi_x.mul
        w3j = np.asarray(
            real_wigner_3j(mi_x.ir.l, mi_f.ir.l, mi_o.ir.l), np.float64
        ) * pw
        fsl = fs[j]
        mp = []
        for m in range(d1):
            for p in range(d3):
                colv = w3j[m, :, p]
                if np.any(colv != 0.0):
                    row = np.zeros(dim_f, np.float64)
                    row[fsl.start : fsl.stop] = colv
                    mp.append((m, p, len(rows)))
                    rows.append(row)
        g_start, p_dim, u_off, u_tot = layout[k]
        instr.append(
            dict(
                x_start=xs[i].start, d1=d1, d3=d3, mul=mul,
                w_start=w_off, mp=tuple(mp),
                g_start=g_start, u_off=u_off, u_tot=u_tot,
            )
        )
        w_off += mul
    w3j_pack = np.stack(rows, 0).astype(np.float32)  # (R, dim_f)
    return instr, w3j_pack, dim_mid, w_off


def mirror_map_numpy(src_nk, shift_nk, edge_mask_nk) -> np.ndarray:
    """Flat (receiver-major) index of each edge's mirror: for the edge at
    slot (i, k) = (i <- j, S), the slot (j, k') holding (j <- i, -S).
    Padded or unmatched slots map to themselves (their cotangents are
    zero). Requires a symmetric neighbour list."""
    src = np.asarray(src_nk, np.int64)
    mask = np.asarray(edge_mask_nk, bool)
    N, K = src.shape
    sh = np.rint(np.asarray(shift_nk)).astype(np.int64)
    smax = 4
    base = 2 * smax + 1
    code = ((sh[..., 0] + smax) * base + (sh[..., 1] + smax)) * base + (
        sh[..., 2] + smax
    )
    mcode = ((-sh[..., 0] + smax) * base + (-sh[..., 1] + smax)) * base + (
        -sh[..., 2] + smax
    )
    dst = np.repeat(np.arange(N, dtype=np.int64), K).reshape(N, K)
    big = base ** 3
    key = (dst * N + src) * big + code          # identity of each edge
    want = (src * N + dst) * big + mcode        # identity of its mirror
    flat_self = dst * K + np.tile(np.arange(K, dtype=np.int64), (N, 1))
    kf = np.where(mask, key, -1).reshape(-1)
    order = np.argsort(kf)
    pos = np.searchsorted(kf[order], want.reshape(-1))
    pos = np.clip(pos, 0, N * K - 1)
    hit = kf[order][pos] == want.reshape(-1)
    mir = np.where(hit & mask.reshape(-1), order[pos], flat_self.reshape(-1))
    return mir.reshape(N, K).astype(np.int32)


def mirror_map(src_nk: torch.Tensor, shift_nk: torch.Tensor, edge_mask_nk: torch.Tensor):
    """:func:`mirror_map_numpy` on the inputs' device (the counterpart of
    ``sevennet_tpu/ops/fused_conv.py:mirror_map``, which the MD engine
    calls at every neighbour rebuild): ``(N, K)`` int64 flat mirror
    indices, padded or unmatched slots mapping to themselves. One sort of
    the edge keys and a binary search for each edge's mirror key, in place
    of the JAX package's chunked ``(B, K, K)`` direct search; the key
    ``(dst * N + src) * 729 + code`` passes 2**31 near 2,000 atoms, so it
    is int64."""
    N, K = src_nk.shape
    dev = src_nk.device
    src = src_nk.long()
    sh = torch.round(shift_nk).long()
    smax, base = 4, 9
    code = ((sh[..., 0] + smax) * base + (sh[..., 1] + smax)) * base + (sh[..., 2] + smax)
    mcode = ((smax - sh[..., 0]) * base + (smax - sh[..., 1])) * base + (smax - sh[..., 2])
    dst = torch.arange(N, device=dev)[:, None]
    key = (dst * N + src) * base**3 + code
    want = ((src * N + dst) * base**3 + mcode).reshape(-1)
    mask = edge_mask_nk.reshape(-1)
    keys, order = torch.sort(torch.where(mask, key.reshape(-1), -1))
    pos = torch.searchsorted(keys, want).clamp_(max=N * K - 1)
    hit = (keys[pos] == want) & mask
    return torch.where(hit, order[pos], torch.arange(N * K, device=dev)).view(N, K)


# default of chunk_threshold(), measured (chip_smoke.py --threshold-probe, an
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md): peak memory per byte of the
# largest layer's gathered edge tensor, 2.3137 for an unchunked SevenNet-0
# MD step at 199,998 atoms (52.13 GiB for 24.19 GB), 2.3386 for a 99,999-atom
# request of SevenNet-0 and 2.5362 for its legacy (emb/sh) config; at the
# largest of them a 60 GiB peak is reached at 25.4 GB gathered
CHUNK_THRESHOLD_BYTES = 25_400_000_000


def chunk_threshold() -> int:
    """Size in bytes of a layer's gathered edge tensor (``N * K * dim_x *
    4``) above which the conv runs its backward in row chunks (the ring or
    the chunked scatter path) instead of the unchunked mirror path; the
    counterpart of ``sevennet_tpu/ops/fused_conv.py:chunk_threshold``, with
    the same override ``SEVENNET_TPU_CHUNK_THRESHOLD``. The JAX default
    (3 GB) was sized for a 16 GB chip; this one keeps the unchunked path,
    the fastest, wherever its peak stays under about 60 GiB of the H100's
    80 GB at the largest peak per gathered byte measured (the legacy
    calculator's, :data:`CHUNK_THRESHOLD_BYTES`): about 210k water atoms
    in SevenNet-0 MD. The trainer's peak per gathered byte is not
    measured; training refuses a layer that chunks
    (:func:`~sevennet_tpu_torch.model.model.model_compute`)."""
    return int(os.environ.get("SEVENNET_TPU_CHUNK_THRESHOLD", CHUNK_THRESHOLD_BYTES))


# ---------------------------------------------------------------------------
# static per-layer tables
# ---------------------------------------------------------------------------


class _ConvDims(ctypes.Structure):
    """ctypes mirror of ``struct ConvDims`` (csrc/fused_conv_common.cuh)."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "N", "K", "dim_x", "dim_mid", "numel", "rblk", "dim_f", "n_basis", "nh", "hsum", "hl",
        "wblk", "cutoff_kind",
    )] + [(n, ctypes.c_float) for n in ("cutoff", "cutoff_arg", "act_cst")] + [
        (n, ctypes.c_int) for n in ("sh_terms", "n_sh", "shd_terms", "n_shd", "sh_coef", "shd_coef")
    ]


MAX_MLP = 8  # radial-MLP weight matrices the kernels take (csrc MAX_MLP)


class _MlpWeights(ctypes.Structure):
    """ctypes mirror of ``struct MlpWeights`` (csrc/fused_conv_common.cuh):
    the radial MLP's weight matrices, unused entries null."""

    _fields_ = [("w", ctypes.c_void_p * MAX_MLP)]


_WS_FIELDS = ("stride", "emb", "h", "dz", "dw", "dc")


class _WsLayout(ctypes.Structure):
    """ctypes mirror of ``struct WsLayout`` (csrc/fused_conv_bwd.cu)."""

    _fields_ = [(n, ctypes.c_int) for n in _WS_FIELDS]


def _workspace_layout(dims, dcoef: bool = True) -> Dict[str, int]:
    """Columns of the per-edge record that kernels B2′ and B4′ write for the
    parameter gradients (``csrc/fused_conv_bwd.cu``): the MLP's input
    ``emb``, its hidden activations ``h`` (the layers in order), their
    cotangents ``dz`` (in the same order), the last layer's cotangent ``dw``
    and, with ``dcoef`` (vec mode), the per-edge ``dcoef`` terms, in this
    order (without, ``dc`` is the end of the record); the row ``stride`` is
    rounded up to 4 floats."""
    nb, hidden, numel = dims[0], dims[1:-1], dims[-1]
    out, col = {}, 0
    for name, width in zip(_WS_FIELDS[1:], (nb, sum(hidden), sum(hidden), numel,
                                            nb if dcoef else 0)):
        out[name] = col
        col += width
    out["stride"] = -(-col // 4) * 4
    return out


def _reduce_products(dims, layout, dcoef: bool):
    """The sums over edges of B2′'s reduction, ``dW_l = A_lᵀ B_l /
    sqrt(d_in)``, as ``(a_off, d_in, b_off, d_out)`` record columns per
    weight matrix (``A_0`` the embedding, ``A_l`` hidden layer l; ``B_l``
    the next layer's cotangent), then with ``dcoef`` the column sums of the
    ``dc`` terms (``a_off = -1``: a column of ones, d_in 1)."""
    hid = dims[1:-1]
    a_offs = [layout["emb"]] + [layout["h"] + sum(hid[:l]) for l in range(len(hid))]
    b_offs = [layout["dz"] + sum(hid[:l]) for l in range(len(hid))] + [layout["dw"]]
    prods = [(a, din, b, dout) for a, b, din, dout in zip(a_offs, b_offs, dims[:-1], dims[1:])]
    if dcoef:
        prods.append((-1, 1, layout["dc"], dims[0]))
    return prods


# the reduction kernel's layout (csrc/pg_reduce.cu; check_reduce_layout):
# threads, output tile rows and columns, rows per stage, staged row strides,
# largest chunk, tiles and products of a call
REDUCE_NT, REDUCE_TM, REDUCE_TN, REDUCE_RK = 640, 128, 64, 16
REDUCE_SA, REDUCE_SB = REDUCE_TM + 8, REDUCE_TN + 8
REDUCE_MAX_CHUNK, REDUCE_MAX_TILES = 4096, 64
REDUCE_SMS = 132        # SMs of an H100 SXM: the chunk plan's target of chunks
REDUCE_MIN_CHUNK = 64   # rows


def reduce_chunk(rows: int) -> int:
    """Workspace rows per chunk of the reduction: about ``REDUCE_SMS``
    chunks, each a whole number of stages (``REDUCE_RK`` rows), within
    ``[REDUCE_MIN_CHUNK, REDUCE_MAX_CHUNK]``. A function of the row count
    alone, so the order of the sums depends on the shape only."""
    per_sm = -(-rows // REDUCE_SMS)
    return min(REDUCE_MAX_CHUNK, max(REDUCE_MIN_CHUNK, -(-per_sm // REDUCE_RK) * REDUCE_RK))


def _staged(col: int, width: int):
    """(first column, shift, columns) by which the reduction kernel copies
    the record field ``[col, col + width)``: the aligned superset of its
    columns (16-byte boundaries, whole 16 bytes), the fragments reading
    from ``col = first + shift`` on."""
    c0 = col - col % 4
    return c0, col - c0, -(-(col + width - c0) // 4) * 4


def _split_width(n: int, most: int) -> int:
    """The width of the equal parts, a multiple of 8, that cut ``n``
    columns into as few parts of at most ``most`` as there can be."""
    per = -(-n // -(-n // most))
    return -(-per // 8) * 8


def reduce_tiles(prods):
    """The reduction kernel's output tiles over the products ``prods``
    (:func:`_reduce_products`), and where each product's outputs start in
    the concatenated output (``begins``, one more than the products):
    ``(tiles, begins)``. Product ``(a, da, b, db)`` gives the ``(da, db)``
    matrix ``A^T B`` (dcoef: ``a = -1``, a ones column, ``(db,)``), entry
    ``(i, j)`` at ``i * db + j``. A tile's M operand is the wider of A and B
    (B on a tie; never the ones column), its N operand the other: the
    kernel loads M into registers and transposes N through shared memory.
    Tiles of at most ``REDUCE_TM`` rows (M's columns) and ``REDUCE_TN``
    columns, each side split into equal widths (a multiple of 8). A tile is
    ``(m_col, m_sh, m_cols, m_len, n_col, n_sh, n_cols, n_len, out, sm,
    sn)`` (``struct PgTile``): each operand copied as :func:`_staged` says
    (``n_col = -1``: the ones column, not copied), entry (m, n) at ``out +
    m * sm + n * sn``."""
    tiles, begins = [], [0]
    for a, da, b, db in prods:
        out0 = begins[-1]
        transposed = a < 0 or db >= da
        (m_off, m_n), (n_off, n_n) = ((b, db), (a, da)) if transposed else ((a, da), (b, db))
        sm, sn = (1, db) if transposed else (db, 1)
        m_width, n_width = _split_width(m_n, REDUCE_TM), _split_width(n_n, REDUCE_TN)
        for m0 in range(0, m_n, m_width):
            ml = min(m_width, m_n - m0)
            for n0 in range(0, n_n, n_width):
                nl = min(n_width, n_n - n0)
                n_st = (-1, 0, 0) if n_off < 0 else _staged(n_off + n0, nl)
                tiles.append((*_staged(m_off + m0, ml), ml, *n_st, nl, out0 + m0 * sm + n0 * sn,
                              sm, sn))
        begins.append(out0 + da * db)
    return tiles, begins


UVU_HEADER = 24   # ints at the start of a rank's table: task tables' places, MLP widths, rank
UVU_INS = 64      # ints per instruction record
UVU_BLK = 12      # ints per column-block record
UVU_MAX_D = 7     # irrep dimensions the uvu tables take (l <= 3)
UVU_WARPS = 8     # warps per CTA of the kernels (csrc NWARP; check_uvu_layout)
# the rank fields of a table's header (csrc H_NEXT ..; _rank_itab): the next
# rank's table, the rank's x columns, its output columns, the place of its x
# column map in the table, its instructions
H_NEXT, H_XW, H_MW, H_XMAP, H_NK = 10, 11, 19, 20, 21
# the layer's place of an instruction's outputs in its record (a cluster's
# ranks hold theirs one after another): first mid column, group channels
UVU_GY, UVU_GUT = 57, 58
CLUSTER_SIZES = (2, 4)  # CTAs of a cluster the planner tries, in turn (4: presets.WIDE4_LAYER)
GMAP = 8          # W3 columns per entry of a cluster block's column map
XMAP = 4          # x columns per entry of a rank's x column map


def _balanced(tasks, costs):
    """``tasks`` reordered so that warp w takes the run ``[starts[w],
    starts[w + 1])``: the costliest task first, each to the warp with the
    least work so far (ties to the lower warp). Returns (tasks, starts)."""
    load = [0] * UVU_WARPS
    runs: List[list] = [[] for _ in range(UVU_WARPS)]
    for i in sorted(range(len(tasks)), key=lambda i: -costs[i]):
        w = min(range(UVU_WARPS), key=lambda w: load[w])
        load[w] += costs[i]
        runs[w].append(tasks[i])
    starts = np.cumsum([0] + [len(r) for r in runs])
    return [t for r in runs for t in r], starts


def _column_blocks(instr, ks, budget: int) -> List[List[int]]:
    """The instructions ``ks`` (in order) grouped into blocks of ``w``'s
    columns at most ``budget`` wide (an instruction's uvu weights are
    ``mul`` consecutive columns; each block starts at an instruction
    boundary)."""
    blocks: List[List[int]] = [[]]
    width = 0
    for k in ks:
        if blocks[-1] and width + instr[k]["mul"] > budget:
            blocks.append([])
            width = 0
        blocks[-1].append(k)
        width += instr[k]["mul"]
    return blocks


@dataclass(frozen=True)
class ConvRank:
    """One CTA's share of a layer: the x irreps ``xi`` (indices into
    ``irreps_x``) whose columns of ``x`` and ``dxg`` it holds, the
    instructions ``ks`` that read them (in order), its ``xw`` columns of x
    and its ``mw`` output columns (each instruction's ``d3 * mul``). A layer
    that fits one CTA is one rank of every irrep; a cluster's ranks split
    the irreps, so that each output column, ``w`` column and ``dxg`` column
    belongs to one rank."""

    xi: Tuple[int, ...]
    ks: Tuple[int, ...]
    xw: int
    mw: int


def _conv_rank(conv: ConvTPSpec, instr, xi) -> ConvRank:
    xs = conv.irreps_x.slices()
    starts = {xs[j].start for j in xi}
    ks = tuple(k for k, ins in enumerate(instr) if ins["x_start"] in starts)
    return ConvRank(tuple(xi), ks, sum(xs[j].stop - xs[j].start for j in xi),
                    sum(instr[k]["d3"] * instr[k]["mul"] for k in ks))


# a rank's work counted in W3 columns (its columns of the two W3 products
# are most of it): each uvu term (an instruction's channel and (m, p) pair)
# adds TERM_COST of a column, rank 0's sums over the ranks and its chain
# LEAD_COST columns. Fitted to conv_breakdown.py's sections per rank at
# mf-ompa's layer 2 on an H100; `conv_breakdown.py --splits` times the
# split they pick against the most even W3 columns (PERF.md, Findings).
TERM_COST, LEAD_COST = 1 / 16, 176


def _rank_cost(instr, rank: ConvRank) -> float:
    return sum(instr[k]["mul"] * (1 + TERM_COST * len(instr[k]["mp"])) for k in rank.ks)


def _rank_splits(conv: ConvTPSpec, instr, n: int) -> List[List[ConvRank]]:
    """Every split of the x irreps over ``n`` ranks, each rank with at least
    one instruction, the most even first: by the largest rank's work
    (:func:`_rank_cost`: the W3 products' columns and the uvu terms; rank 0,
    which also sums the ranks' shares and runs the chain, is the rank of
    least work), then x columns, then output columns. Each split appears
    once."""
    n_ir = len(conv.irreps_x)
    out = []
    for tail in itertools.product(range(n), repeat=n_ir - 1):
        assign = (0, *tail)
        if any(r not in assign for r in range(n)) or any(
                assign.index(r) > assign.index(r + 1) for r in range(n - 1)):
            continue
        ranks = [_conv_rank(conv, instr, [j for j in range(n_ir) if assign[j] == r])
                 for r in range(n)]
        if all(r.ks for r in ranks):
            out.append(sorted(ranks, key=lambda r: _rank_cost(instr, r)))

    def key(ranks):
        costs = [_rank_cost(instr, r) + (LEAD_COST if i == 0 else 0) for i, r in enumerate(ranks)]
        return max(costs), max(r.xw for r in ranks), max(r.mw for r in ranks)

    return sorted(out, key=key)


def _uvu_tables(conv: ConvTPSpec, instr, blocks: List[List[int]], hidden, rank: ConvRank,
                row_of: Dict[int, int], cluster: bool) -> np.ndarray:
    """Task tables of the kernels' uvu steps on the tensor cores
    (``csrc/fused_conv_common.cuh``, ``uvu_*``) for one rank, the table its
    CTA copies to shared memory. The kernels form the per-edge weights ``w``
    one column block at a time (``blocks``: the rank's instructions in
    order, :func:`plan_blocks`) and run that block's tasks before the next
    block overwrites it.

    A header of UVU_HEADER ints ``[off_ins, n_dt, off_dt, n_dx, off_dx,
    off_list, n_fw, off_fw, off_blk, n_blk, next, xw]``, the radial MLP's
    hidden widths (at ints 12 .., so that the kernels read them and the
    block records without a chain of loads), the rank's output columns
    (``H_MW``), the place of its x column map (``H_XMAP``) and its number
    of instructions (``H_NK``); the block records right after it; per
    instruction of the rank (numbered from 0 in order) a record of UVU_INS
    ints ``[x_start, d1, d3, mul, w_start (from its block's first column),
    ybar start, u_tot, 0]``, the Wigner row of each (m, p) counted from its
    block's first row, ``rtab[m * 7 + p]`` (-1 where the pair has no row;
    rows in the kernels' order, ``row_of``, a block's rows consecutive, so
    that ``tmp`` and ``dtmp`` hold one block's rows), and at ``UVU_GY``,
    ``UVU_GUT`` the layer's first mid column of its outputs
    (``g_start + u_off``) and its group's channels; ``dtmp`` tasks ``(instruction, m,
    0, 0)``; ``dxg``/``dw`` tasks ``(x_start, d1, mul, list start, list
    length, u0, 0, 0)``, one per x irrep of the rank, 8 channels from
    ``u0`` and block, over the block's instructions that read the irrep
    (listed at ``off_list``): block 0 has tasks for every irrep of the
    rank, with an empty list where none of its instructions reads it (they
    write the irrep's zeros), and the later blocks' tasks add to ``dxg``;
    forward tasks ``(instruction, u0, 0, 0)``, 16 channels each. Each task
    list is ordered by block, then by warp; per block a record of UVU_BLK
    ints ``[first column of w, width, first Wigner row, rows, runs_dt,
    runs_dx, runs_fw, gmap, first instruction, instructions, first output
    column, output columns]``: warp w of the block takes tasks ``runs[w] ..
    runs[w + 1]`` of each list, the ``runs_*`` offsets of UVU_WARPS + 1
    ints each (:func:`_balanced`, costs in tensor-core steps). Offsets in
    ints from the table's start, each part on 4 ints.

    One CTA (not ``cluster``): x, the output and ``ybar`` columns are the
    layer's (``ybar start`` the instruction's ``g_start + u_off``, ``u_tot``
    its group's channels), a block's first column is its W3 column and
    ``gmap`` is 0. A cluster rank: x columns are the rank's, its irreps'
    columns one after another, in x order (the x column map at ``H_XMAP``
    gives the layer's column of every XMAP of them); output and ``ybar``
    columns are the rank's, each instruction's ``d3 * mul`` in turn (``ybar
    start`` their first, ``u_tot`` its ``mul``), so a block's are a run
    that the backward reads from ``ybar`` for the block alone; a block's
    columns of ``w`` start at 0 and ``gmap`` is the place of its column map,
    the W3 column of every GMAP of its columns."""
    irreps = list(zip(conv.irreps_x.slices(), conv.irreps_x))
    x_loc, col = {}, 0
    for j in rank.xi:
        x_loc[irreps[j][0].start] = col
        col += irreps[j][1].dim
    if not cluster:
        x_loc = {sl.start: sl.start for sl, _ in irreps}
    ks_all = [k for ks in blocks for k in ks]
    assert ks_all == list(rank.ks)
    local = {k: i for i, k in enumerate(ks_all)}
    y_loc, col = {}, 0
    for k in ks_all:
        y_loc[k] = col
        col += instr[k]["d3"] * instr[k]["mul"]
    rows = [[row_of[r] for k in ks for _, _, r in instr[k]["mp"]] for ks in blocks]
    r0 = [min(rs) for rs in rows]
    assert all(rs == list(range(a, a + len(rs))) for rs, a in zip(rows, r0))
    recs = np.full((len(ks_all), UVU_INS), -1, np.int64)
    gmaps = []
    for b, ks in enumerate(blocks):
        w0 = 0
        for k in ks:
            ins = instr[k]
            d1, d3 = ins["d1"], ins["d3"]
            if max(d1, d3) > UVU_MAX_D:
                raise ValueError(f"the fused conv takes irreps up to l = 3, got dimensions {d1}, {d3}")
            y0, ut = ((y_loc[k], ins["mul"]) if cluster
                      else (ins["g_start"] + ins["u_off"], ins["u_tot"]))
            recs[local[k], :8] = [x_loc[ins["x_start"]], d1, d3, ins["mul"], w0, y0, ut, 0]
            for m, p, r in ins["mp"]:
                recs[local[k], 8 + m * UVU_MAX_D + p] = row_of[r] - r0[b]
            recs[local[k], [UVU_GY, UVU_GUT]] = ins["g_start"] + ins["u_off"], ins["u_tot"]
            gmaps += [ins["w_start"] + j for j in range(0, ins["mul"], GMAP)]
            w0 += ins["mul"]
    xmap = [sl.start + c for j in rank.xi for sl in [irreps[j][0]]
            for c in range(0, sl.stop - sl.start, XMAP)] if cluster else []
    dt, dx, fw, lists, runs, blk = [], [], [], [], [[], [], []], []
    gm = 0
    for b, ks in enumerate(blocks):
        bdt = [(local[k], m, 0, 0) for k in ks for m in range(instr[k]["d1"])]
        bfw = [(local[k], u0, 0, 0) for k in ks for u0 in range(0, instr[k]["mul"], 16)]
        bdx, bdx_cost = [], []
        for j in rank.xi:
            sl, mi = irreps[j]
            readers = [local[k] for k in ks if instr[k]["x_start"] == sl.start]
            if not readers and b > 0:
                continue
            for u0 in range(0, mi.mul, 8):
                bdx.append((x_loc[sl.start], mi.ir.dim, mi.mul, len(lists), len(readers), u0, 0, 0))
                bdx_cost.append(1 + mi.ir.dim * len(readers))
            lists += readers
        width = sum(instr[k]["mul"] for k in ks)
        rec = [0 if cluster else instr[ks[0]]["w_start"], width, r0[b], len(rows[b])]
        y_rec = [local[ks[0]], len(ks), y_loc[ks[0]],
                 sum(instr[k]["d3"] * instr[k]["mul"] for k in ks)]
        for i, (lst, tasks, starts) in enumerate((
                (dt, *_balanced(bdt, [-(-instr[ks_all[kk]]["mul"] // 8) for kk, _, _, _ in bdt])),
                (dx, *_balanced(bdx, bdx_cost)),
                (fw, *_balanced(bfw, [2 * instr[ks_all[kk]]["d1"] for kk, _, _, _ in bfw])))):
            runs[i].append(np.asarray(starts) + len(lst))
            lst += tasks
        blk.append((rec, gm, y_rec))
        gm += width // GMAP
    parts = [np.zeros(UVU_HEADER, np.int64), np.zeros((len(blocks), UVU_BLK), np.int64), recs,
             dt, dx, lists, fw, *runs, gmaps if cluster else [], xmap]
    parts = [np.asarray(a, np.int64).reshape(-1) for a in parts]
    parts = [np.concatenate([a, np.zeros(-a.size % 4, np.int64)]) for a in parts]
    offs = np.cumsum([0] + [a.size for a in parts[:-1]])
    for b, (rec, g, y_rec) in enumerate(blk):
        parts[1][b * UVU_BLK : (b + 1) * UVU_BLK] = rec + [
            offs[7 + i] + b * (UVU_WARPS + 1) for i in range(3)] + [
            offs[10] + g if cluster else 0] + y_rec
    parts[0][:12] = [offs[2], len(dt), offs[3], len(dx), offs[4], offs[5], len(fw), offs[6],
                     offs[1], len(blocks), 0, rank.xw]
    # the widths the kernels take (at most MAX_MLP - 1 hidden layers;
    # check_conv_inputs raises for a deeper MLP on CUDA tensors)
    parts[0][12:H_MW][: len(hidden)] = hidden[: H_MW - 12]
    parts[0][H_MW] = rank.mw
    parts[0][H_XMAP] = offs[11] if cluster else 0
    parts[0][H_NK] = len(ks_all)
    return np.concatenate(parts)


def _kernel_rows(instr, rank_blocks) -> Dict[int, int]:
    """The Wigner rows in the kernels' order (rank by rank, block by block,
    instruction by instruction): row -> its place. The identity for one
    CTA, whose blocks take the instructions in order."""
    order = [r for blocks in rank_blocks for ks in blocks for k in ks
             for _, _, r in instr[k]["mp"]]
    return {r: i for i, r in enumerate(order)}


def _rank_itab(conv: ConvTPSpec, instr, ranks, rank_blocks, hidden, terms):
    """The int table of a layer's ranks: rank 0's table, the monomial terms
    ``terms`` (sh, then dsh), then the later ranks' tables, each table
    padded to the largest. A rank's CTA copies its table and the terms to
    shared memory. Each table's header links the next rank's (``H_NEXT``, 0
    after the last); a layer of one CTA is its table and the terms. Returns
    ``(itab, ints before the terms, row_of)`` (:func:`_kernel_rows`)."""
    cluster = len(ranks) > 1
    row_of = _kernel_rows(instr, rank_blocks)
    tabs = [_uvu_tables(conv, instr, bl, hidden, r, row_of, cluster)
            for r, bl in zip(ranks, rank_blocks)]
    tabw = max(t.size for t in tabs)
    tabs = [np.concatenate([t, np.zeros(tabw - t.size, np.int64)]) for t in tabs]
    parts = [tabs[0], terms, *tabs[1:]]
    starts = np.cumsum([0] + [a.size for a in parts])
    for p, tab in enumerate(tabs):
        tab[H_NEXT] = starts[2 + p] if p + 1 < len(ranks) else 0
    return np.concatenate(parts), tabw, row_of


# ---------------------------------------------------------------------------
# shared-memory plan of the kernels (mirror of csrc/fused_conv_common.cuh:carve)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448  # dynamic shared memory a CTA may have on sm_90 (csrc SMEM_LIMIT)
TE, BN, SBF, OG, MAX_STAGES = 16, 64, 72, 64, 4  # csrc TE, BN, SBF, OG, MAX_STAGES
NWARP = UVU_WARPS
# neighbour slots a row may have for the block plan to fit: each slot takes
# 5 bytes of a CTA's shared memory (its index and validity byte)
PLAN_K = 256


def _bank_stride(n: int, rem: int) -> int:
    return n + (rem - n) % 32


def _round8(n: int) -> int:
    return (n + 7) & ~7


def carve_bytes(d: _ConvDims, bwd: bool, mblk: Optional[int] = None,
                xw: Optional[int] = None) -> Tuple[int, int]:
    """``(bytes, W3 stages)`` of one CTA's shared memory for the layer ``d``
    whose CTA holds ``mblk`` output columns (default ``dim_mid``; the
    forward's accumulator, the backward's ``ybar``) and, on a cluster, ``xw``
    columns of x (default: one CTA, all of x): the host's copy of ``carve``
    in ``csrc/fused_conv_common.cuh``, which the kernels'
    ``fused_conv_smem_bytes`` must match (checked at the first launch of
    each layer shape, :func:`check_carve`). A cluster's backward also holds
    its ``dxg`` tile."""
    def take(nbytes):
        nonlocal off
        off += (nbytes + 15) & ~15

    mblk = d.dim_mid if mblk is None else mblk
    off = 0
    rem = 4 if bwd else 8
    SX = _bank_stride(d.dim_x if xw is None else xw, rem)
    SW, SR = _bank_stride(d.wblk, rem), d.rblk | 1
    for nbytes in (4 * d.K, d.K, 16, 4 * TE, 4 * TE, 32 * TE, 4 * TE * d.n_basis,
                   4 * TE * d.dim_f, 4 * TE * SR, 8 * TE * d.hsum, 4 * TE * SX, 4 * TE * SW,
                   4 * (d.shd_terms + 5 * d.n_shd)):
        take(nbytes)
    if not bwd:
        take(4 * mblk)
    else:
        for nbytes in (4 * (mblk + (mblk >> 5) + 1), 4 * TE * SR, 4 * TE * d.hl,
                       4 * TE * d.n_basis, 4 * TE * d.dim_f):
            take(nbytes)
        if xw is not None:
            take(4 * TE * SX)

    def stage(n):
        return 4 * max(n * max(_round8(d.hl), OG) * SBF, NWARP * TE * SBF)

    off = (off + 127) & ~127  # the staged W3 blocks on a 128-byte boundary
    nstage = MAX_STAGES
    while nstage > 2 and off + stage(nstage) > SMEM_LIMIT:
        nstage -= 1
    take(stage(nstage))
    return off, nstage


@dataclass(frozen=True)
class BlockPlan:
    """How the kernels walk a layer: one CTA per receiver row, or a cluster
    of ``cluster`` CTAs per row (:class:`ConvRank`: each rank its x irreps,
    their instructions and output columns, every rank over all of the row's
    edges once); rank by rank, the column blocks of the per-edge weights
    ``w``: each block's instructions and width (``blocks``, ``widths``: the
    ranks' blocks in order; ``rank_blocks``: how many belong to each rank);
    ``wblk`` the widest block, ``mblk`` the widest rank's output columns
    (the forward's accumulator), ``yblk`` the ``ybar`` columns the backward
    holds (one CTA: the row's, ``mblk``; a cluster: the widest block's,
    which it reads block by block), ``xw`` the widest rank's x columns, and
    the shared-memory bytes and W3 stages of both kernels at ``PLAN_K``
    slots (per CTA)."""

    blocks: Tuple[Tuple[int, ...], ...]
    widths: Tuple[int, ...]
    wblk: int
    fwd: Tuple[int, int]
    bwd: Tuple[int, int]
    ranks: Tuple[ConvRank, ...]
    rank_blocks: Tuple[int, ...]
    mblk: int
    yblk: int
    xw: int

    @property
    def cluster(self) -> int:
        return len(self.ranks)

    def carve_xw(self) -> Optional[int]:
        """``xw`` of :func:`carve_bytes`: None for one CTA."""
        return self.xw if self.cluster > 1 else None

    def launch_args(self, bwd: bool):
        """The plan's ctypes arguments of a kernel's entry: the output
        columns its CTA holds (``yblk`` for the backward, ``mblk`` for the
        forward), ``xw`` (-1 for one CTA) and the CTAs of a cluster."""
        xw = self.carve_xw()
        return (ctypes.c_int(self.yblk if bwd else self.mblk),
                ctypes.c_int(-1 if xw is None else xw), ctypes.c_int(self.cluster))


def _describe(conv: ConvTPSpec, mlp_dims) -> str:
    return (f"x {conv.irreps_x}, filter {conv.irreps_filter}, out {conv.irreps_mid}, radial MLP "
            f"{list(mlp_dims)}")


def _fit_blocks(ranks, instr, table_fn):
    """The widest column blocks of the ranks ``ranks`` for which both
    kernels' carve fits at ``PLAN_K`` slots: ``(fit, floor)``, each a tuple
    ``(rank_blocks, dims, fwd, bwd, yblk)``, ``fit`` None where not even blocks of
    one instruction (``floor``) fit. The budget of a block's columns starts
    at the widest rank and falls to below the widest block that did not
    fit."""
    widest = max(instr[k]["mul"] for r in ranks for k in r.ks)
    mblk = max(r.mw for r in ranks)
    xw = max(r.xw for r in ranks) if len(ranks) > 1 else None

    def carve_at(budget):
        rank_blocks = [_column_blocks(instr, r.ks, budget) for r in ranks]
        d = table_fn(ranks, rank_blocks)
        yblk = mblk if xw is None else max(sum(instr[k]["d3"] * instr[k]["mul"] for k in ks)
                                           for bl in rank_blocks for ks in bl)
        return (rank_blocks, d, carve_bytes(d, False, mblk, xw), carve_bytes(d, True, yblk, xw),
                yblk)

    def fits(r):
        return max(r[2][0], r[3][0]) <= SMEM_LIMIT

    floor = carve_at(widest)
    if not fits(floor):
        return None, floor
    r = carve_at(max(sum(instr[k]["mul"] for k in rk.ks) for rk in ranks))
    while not fits(r) and r[1].wblk > widest:
        r = carve_at(r[1].wblk - 1)
    return (r if fits(r) else floor), floor


def _cluster_ok(conv: ConvTPSpec, instr) -> bool:
    """Whether a cluster can take the layer: its column maps step by GMAP
    columns of w and XMAP columns of x."""
    return (all(ins["mul"] % GMAP == 0 for ins in instr)
            and all(sl.start % XMAP == 0 and sl.stop % XMAP == 0
                    for sl in conv.irreps_x.slices()))


def plan_blocks(conv: ConvTPSpec, mlp_dims, instr, table_fn) -> BlockPlan:
    """The ranks and column blocks for which both kernels' shared memory
    fits (``carve_bytes`` at ``PLAN_K`` slots, at least 2 W3 stages): one
    CTA when the layer's output accumulator, ybar and tables fit whole;
    else a cluster of ``CLUSTER_SIZES`` CTAs (2, then 4), its ranks the
    most even split of the x irreps that fits (:func:`_rank_splits`); within
    the ranks the widest blocks (:func:`_fit_blocks`), one block per rank
    when its columns of ``w`` fit. ``table_fn(ranks, rank_blocks)`` builds a
    plan's tables and gives its ``_ConvDims`` (the tables and the widest
    block's Wigner rows change with the blocks); the last call is the
    plan's. Raises ValueError, naming the layer's widths, the bytes and the
    limit, when not even a cluster of the largest size with blocks of one
    instruction fits."""
    ranks = [_conv_rank(conv, instr, range(len(conv.irreps_x)))]
    fit, smallest = _fit_blocks(ranks, instr, table_fn)
    splits = (r for n in CLUSTER_SIZES for r in _rank_splits(conv, instr, n))
    while fit is None and _cluster_ok(conv, instr):
        ranks = next(splits, None)
        if ranks is None:
            break
        fit, floor = _fit_blocks(ranks, instr, table_fn)
        if max(floor[2][0], floor[3][0]) < max(smallest[2][0], smallest[3][0]):
            smallest = floor
    if fit is not None:
        rank_blocks, d, fwd, bwd, yblk = fit
        table_fn(ranks, rank_blocks)
        blocks = tuple(tuple(b) for bl in rank_blocks for b in bl)
        return BlockPlan(blocks, tuple(int(sum(instr[k]["mul"] for k in b)) for b in blocks),
                         d.wblk, fwd, bwd, tuple(ranks), tuple(map(len, rank_blocks)),
                         max(r.mw for r in ranks), yblk, max(r.xw for r in ranks))
    _, d, fwd, bwd, _ = smallest
    raise ValueError(
        "the fused-conv kernels cannot fit this layer in the shared memory of a CTA or of a "
        f"cluster of up to {CLUSTER_SIZES[-1]} CTAs ({_describe(conv, mlp_dims)}): at best, with "
        f"blocks of one instruction's {d.wblk} columns, the forward needs {fwd[0]} B and the "
        f"backward {bwd[0]} B a CTA at {PLAN_K} neighbour slots, over the limit of {SMEM_LIMIT} B")


class FusedConvOp:
    """Static tables of one conv layer: the instruction tables of the JAX
    kernels, and for the CUDA kernels the CTAs of a receiver row and the
    column blocks of ``w`` (:func:`plan_blocks`), the uvu product's
    instruction records and task lists (:func:`_uvu_tables`,
    :func:`_rank_itab`), ``w3j_pack``'s rows in the kernels' order
    (``ftab``) and, in vec mode, the
    spherical harmonics and their derivatives as monomial terms.
    ``embed=None`` is emb/sh mode. Device copies are cached per device."""

    def __init__(self, conv: ConvTPSpec, mlp_spec: ScalarMLPSpec,
                 embed: Optional[EdgeEmbedSpec]):
        instr, w3j_pack, dim_mid, numel = _instr_tables(conv)
        assert numel == mlp_spec.dims[-1], (numel, mlp_spec.dims)
        assert mlp_spec.act == "silu", "the fused conv's radial MLP is silu"
        self.n_basis, self.dim_f = mlp_spec.dims[0], conv.irreps_filter.dim
        if embed is not None:
            assert (embed.dim_f, embed.n_basis) == (self.dim_f, self.n_basis)
            assert embed.lmax <= 3
        self.conv, self.mlp_spec, self.embed = conv, mlp_spec, embed
        self.dim_x = conv.irreps_x.dim
        self.dim_mid, self.numel, self.R = dim_mid, numel, w3j_pack.shape[0]
        self.w3j_pack = w3j_pack

        # elementary uvu products (c, xc, wc, r) of the layer
        self.n_terms = sum(ins["mul"] * len(ins["mp"]) for ins in instr)

        # spherical harmonics and their u-derivatives as monomial terms (vec
        # mode only)
        sh_t, sh_c, shd_t, shd_comp, shd_c = [], [], [], [], []
        for l in range(embed.lmax + 1 if embed is not None else 0):
            C = sh_coefficients(l)
            for m, k in zip(*np.nonzero(C)):
                sh_t.append((l * l + m, *monomials(l)[k]))
                sh_c.append(C[m, k])
            if l >= 1:
                G = sh_deriv_tables(l)
                for comp, m, k in zip(*np.nonzero(G)):
                    shd_t.append((l * l + m, *monomials(l - 1)[k]))
                    shd_comp.append(comp)
                    shd_c.append(G[comp, m, k])
        hidden = tuple(mlp_spec.dims[1:-1])
        # the monomial terms: sh (int4 each, on a 16-byte boundary, as the
        # tables end on one), then dsh and each dsh term's component
        sh_ints = np.asarray(sh_t, np.int64).reshape(-1)
        sh_ints = np.concatenate([sh_ints, np.zeros(-sh_ints.size % 4, np.int64)])
        terms = np.concatenate([sh_ints, np.asarray(shd_t, np.int64).reshape(-1),
                                np.asarray(shd_comp, np.int64)])
        tables = {}

        def table_fn(ranks, rank_blocks):
            itab, tabw, tables["row_of"] = _rank_itab(conv, instr, ranks, rank_blocks, hidden,
                                                      terms)
            assert itab.max() < 2**31
            blocks = [ks for bl in rank_blocks for ks in bl]
            wblk = max(sum(instr[k]["mul"] for k in ks) for ks in blocks)
            rblk = max(sum(len(instr[k]["mp"]) for k in ks) for ks in blocks)
            tables["itab"], tables["offs"] = itab.astype(np.int32), dict(
                sh_terms=tabw, shd_terms=tabw + sh_ints.size, n_sh=len(sh_c), n_shd=len(shd_c),
                sh_coef=w3j_pack.size, shd_coef=w3j_pack.size + len(sh_c), wblk=wblk, rblk=rblk)
            return self.dims(1, PLAN_K, tables["offs"])

        self.plan = plan_blocks(conv, mlp_spec.dims, instr, table_fn)
        self.itab, self._offs = tables["itab"], tables["offs"]
        w3j_kernel = np.empty_like(w3j_pack)
        w3j_kernel[[tables["row_of"][r] for r in range(self.R)]] = w3j_pack
        self.ftab = np.concatenate([w3j_kernel.reshape(-1), np.asarray(sh_c, np.float32),
                                    np.asarray(shd_c, np.float32)]).astype(np.float32)
        self.ws_layout = _workspace_layout(mlp_spec.dims, dcoef=embed is not None)
        self.reduce_products = _reduce_products(mlp_spec.dims, self.ws_layout, embed is not None)
        self._reduce_args: Optional[tuple] = None
        self._device_tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def carve(self, d: _ConvDims, bwd: bool) -> Tuple[int, int]:
        """:func:`carve_bytes` of this layer's plan at the shape of ``d``."""
        return carve_bytes(d, bwd, self.plan.yblk if bwd else self.plan.mblk,
                           self.plan.carve_xw())

    def device_tables(self, device: torch.device):
        if device not in self._device_tables:
            self._device_tables[device] = (
                torch.as_tensor(self.itab, device=device),
                torch.as_tensor(self.ftab, device=device),
            )
        return self._device_tables[device]

    def reduce_args(self):
        """ctypes arrays of the reduction's launch: ``(tiles, n_tiles,
        begins, scales, n_prod)`` (:func:`reduce_tiles`; scales ``1 /
        sqrt(d_in)``), cached."""
        if self._reduce_args is None:
            tiles, begins = reduce_tiles(self.reduce_products)
            if len(tiles) > REDUCE_MAX_TILES:
                raise ValueError(f"the reduction kernel takes {REDUCE_MAX_TILES} tiles, got "
                                 f"{len(tiles)}")
            flat = [v for t in tiles for v in t]
            scales = [1.0 / math.sqrt(da) for _, da, _, _ in self.reduce_products]
            self._reduce_args = (
                ctypes.cast((ctypes.c_int * len(flat))(*flat), ctypes.POINTER(ctypes.c_int)),
                ctypes.c_int(len(tiles)),
                ctypes.cast((ctypes.c_int * len(begins))(*begins), ctypes.POINTER(ctypes.c_int)),
                ctypes.cast((ctypes.c_float * len(scales))(*scales),
                            ctypes.POINTER(ctypes.c_float)),
                ctypes.c_int(len(scales)))
        return self._reduce_args

    def dims(self, N: int, K: int, offs=None) -> _ConvDims:
        e, d = self.embed, self.mlp_spec.dims
        geometry = {} if e is None else dict(
            cutoff_kind=0 if e.cutoff_kind == "poly_cut" else 1,
            cutoff=e.cutoff, cutoff_arg=e.cutoff_arg)
        return _ConvDims(
            N=N, K=K, dim_x=self.dim_x, dim_mid=self.dim_mid, numel=self.numel,
            dim_f=self.dim_f, n_basis=self.n_basis, nh=len(d) - 2, hsum=sum(d[1:-1]),
            hl=d[-2], act_cst=NORMALIZE2MOM_CST["silu"], **geometry,
            **(self._offs if offs is None else offs),
        )


@lru_cache(maxsize=None)
def conv_op(conv: ConvTPSpec, mlp_spec: ScalarMLPSpec,
            embed: Optional[EdgeEmbedSpec] = None) -> FusedConvOp:
    return FusedConvOp(conv, mlp_spec, embed)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference of the kernels)
# ---------------------------------------------------------------------------


def edge_embedding_plain(op: FusedConvOp, vec: torch.Tensor, coef: torch.Tensor):
    """(3, E) edge vectors -> ``emb (E, n_basis)``, ``sh (E, dim_f)`` (vec
    mode: normalized spherical harmonics of the unit vectors)."""
    es = op.embed
    r = torch.clamp(torch.sqrt(torch.sum(vec * vec, dim=0)), min=1e-12)
    u = vec / r
    if es.cutoff_kind == "poly_cut":
        env = poly_cutoff(r, es.cutoff, p=int(es.cutoff_arg))
    else:
        env = xplor_cutoff(r, es.cutoff, es.cutoff_arg)
    emb = bessel_basis(r, coef, es.cutoff) * env[:, None]
    sh = spherical_harmonics(es.lmax, u.T, normalize=False)
    return emb, sh


def _conv_from_xg(op, xg, a, b, ws, N, K):
    """The conv on the gathered sender features ``xg (N*K, dim_x)``:
    ``(N, dim_mid)``. ``(a, b)`` is ``(vec, coef)`` in vec mode and
    ``(emb, sh)`` in emb/sh mode."""
    emb, sh = (a, b) if op.embed is None else edge_embedding_plain(op, a, b)
    w = scalar_mlp_apply(op.mlp_spec, {"w": list(ws)}, emb)
    msg = conv_tp_apply(op.conv, xg, sh, w)
    return msg.view(N, K, -1).sum(1)


def _pullback_plain(op, x, src, a, b, ws, ybar, n_wrt):
    """Gradients of the conv at ``ybar`` with respect to the first ``n_wrt``
    of ``(xg, a, b, *ws)``."""
    N, K = src.shape
    with torch.enable_grad():
        prims = [x[src.reshape(-1).long()].detach(), a.detach(), b.detach(),
                 *[w.detach() for w in ws]]
        for t in prims[:n_wrt]:
            t.requires_grad_(True)
        out = _conv_from_xg(op, *prims[:3], prims[3:], N, K)
        return torch.autograd.grad(out, prims[:n_wrt], ybar)


def fused_conv_fwd_plain(op: FusedConvOp, x, src, vec, coef, ws):
    """Plain twin of the vec-mode forward kernel: ``x (N, dim_x)``,
    ``src (N, K)``, ``vec (3, N*K)``, ``coef (n_basis,)``, MLP weights ->
    ``(N, dim_mid)``."""
    N, K = src.shape
    return _conv_from_xg(op, x[src.reshape(-1).long()], vec, coef, ws, N, K)


def fused_conv_bwd_plain(op: FusedConvOp, x, src, vec, coef, ws, ybar, param_grads=False):
    """Plain twin of the vec-mode backward kernels: the pullback of
    :func:`fused_conv_fwd_plain` at ``ybar (N, dim_mid)``, returning the
    per-edge x-cotangents ``dxg (N*K, dim_x)`` and ``dvec (3, N*K)`` (B2);
    with ``param_grads`` also the MLP-weight gradients ``dws`` and
    ``dcoef (n_basis,)`` (B2′): ``(dxg, dvec, dws, dcoef)``."""
    grads = _pullback_plain(op, x, src, vec, coef, ws, ybar, 3 + len(ws) if param_grads else 2)
    if not param_grads:
        return grads
    dxg, dvec, dcoef, *dws = grads
    return dxg, dvec, dws, dcoef


def fused_conv_fwd_embsh_plain(op: FusedConvOp, x, src, emb, sh, ws):
    """Plain twin of the emb/sh-mode forward kernel (B4, B6): ``x (N,
    dim_x)``, ``src (N, K)``, ``emb (N*K, n_basis)``, ``sh (N*K, dim_f)``,
    MLP weights -> ``(N, dim_mid)``."""
    N, K = src.shape
    return _conv_from_xg(op, x[src.reshape(-1).long()], emb, sh, ws, N, K)


def fused_conv_bwd_embsh_plain(op: FusedConvOp, x, src, emb, sh, ws, ybar, param_grads=False):
    """Plain twin of the emb/sh-mode backward kernels (B4 bwd, B5): the
    pullback of :func:`fused_conv_fwd_embsh_plain` at ``ybar``:
    ``(dxg, demb, dsh)``, and with ``param_grads`` (B4′)
    ``(dxg, demb, dsh, dws)``. A zero ``emb`` row (a padded slot) gets zero
    ``dxg`` and ``dsh`` but a nonzero ``demb``, as from the JAX kernels;
    the model masks it."""
    grads = _pullback_plain(op, x, src, emb, sh, ws, ybar, 3 + len(ws) if param_grads else 3)
    if not param_grads:
        return grads
    dxg, demb, dsh, *dws = grads
    return dxg, demb, dsh, dws


def param_grad_reduce_plain(op: FusedConvOp, work, valid):
    """Plain twin of the reduction kernel of B2′ and B4′: from the per-edge
    records ``work (N*K, stride)`` (rows with ``valid == 0`` are ignored,
    whatever they hold) the sums over edges ``dW_l = h_lᵀ g_l / sqrt(d_l)``
    and, in vec mode, ``dcoef`` (``None`` in emb/sh mode): ``(dws, dcoef)``."""
    rows = torch.where(valid.bool()[:, None], work, torch.zeros((), dtype=work.dtype,
                                                                device=work.device))
    sums = [rows[:, b:b + db].sum(0) if a < 0 else
            (rows[:, a:a + da].T @ rows[:, b:b + db]) / math.sqrt(da)
            for a, da, b, db in op.reduce_products]
    n_w = len(op.mlp_spec.dims) - 1
    return sums[:n_w], None if op.embed is None else sums[n_w]


def _pullback_vjp(op, x, src, a, b, ws, ybar, cots):
    """VJP of the pullback ``(dxg, da[, db, *dws]) = bwd(x, a, b, ybar,
    ws)`` at ``cots`` with respect to ``(x, a, b, ybar, *ws)``, where the
    pullback's outputs are the gradients of the conv with respect to
    ``(xg, a, b, *ws)``, as many as there are cotangents."""
    N, K = src.shape
    prims = (x, a, b, ybar, *ws)
    if all(c is None for c in cots):
        return (None,) * len(prims)
    with torch.enable_grad():
        prims = [t.detach().requires_grad_(True) for t in prims]
        xd, ad, bd, yd, *wd = prims
        xg = xd[src.reshape(-1).long()]
        out = _conv_from_xg(op, xg, ad, bd, wd, N, K)
        wrt, cots = zip(*[(t, c) for t, c in zip((xg, ad, bd, *wd), cots) if c is not None])
        pullback = torch.autograd.grad(out, wrt, yd, create_graph=True)
        return torch.autograd.grad(pullback, prims, cots, allow_unused=True)


def fused_conv_bwd_vjp_plain(op: FusedConvOp, x, src, vec, coef, ws, ybar, cots):
    """The vec-mode conv's second-order rule, plain PyTorch on any device:
    the VJP of the pullback ``(dxg, dvec[, dcoef, *dws]) = bwd(x, vec, coef,
    ybar, ws)`` at the cotangents ``cots`` (one per output), with respect to
    ``(x, vec, coef, ybar, *ws)``; ``None`` where an input gets nothing.
    An output whose cotangent is ``None`` is not formed: a force loss sends
    none to the parameter gradients of the force pass."""
    return _pullback_vjp(op, x, src, vec, coef, ws, ybar, cots)


def fused_conv_bwd_embsh_vjp_plain(op: FusedConvOp, x, src, emb, sh, ws, ybar, cots):
    """The emb/sh-mode conv's second-order rule (the port of the emb/sh
    branch of ``_make_bwd_op``, ``sevennet_tpu/ops/fused_conv.py:1301-1335``):
    the VJP of the pullback ``(dxg, demb, dsh[, *dws])`` at ``cots`` with
    respect to ``(x, emb, sh, ybar, *ws)``, as
    :func:`fused_conv_bwd_vjp_plain`."""
    return _pullback_vjp(op, x, src, emb, sh, ws, ybar, cots)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def check_conv_inputs(op: FusedConvOp, embsh: bool, x, src, a, b, ws, ybar=None):
    """Raises ValueError on inputs the kernels do not take. ``(a, b)`` is
    ``(vec, coef)`` in vec mode and ``(emb, sh)`` in emb/sh mode. ``src``,
    the edge arrays and ``ybar`` cover the receivers (all atoms, or one row
    chunk of them); ``x`` holds every atom ``src`` may name, at least as
    many rows as there are receivers."""
    if embsh != (op.embed is None):
        raise ValueError(f"this wrapper takes an op of {'emb/sh' if embsh else 'vec'} mode")
    dev = x.device
    N, K = src.shape
    edge = ([("emb", a, (N * K, op.n_basis)), ("sh", b, (N * K, op.dim_f))] if embsh
            else [("vec", a, (3, N * K)), ("coef", b, (op.n_basis,))])
    shapes = [
        ("x", x, (max(x.shape[0], N), op.dim_x), torch.float32),
        ("src", src, (N, K), torch.int32),
    ] + [(name, t, shape, torch.float32) for name, t, shape in edge] + [
        (f"w{i}", w, (a, b), torch.float32)
        for i, (w, a, b) in enumerate(zip(ws, op.mlp_spec.dims[:-1], op.mlp_spec.dims[1:]))
    ]
    if len(ws) != len(op.mlp_spec.dims) - 1:
        raise ValueError(f"expected {len(op.mlp_spec.dims) - 1} MLP weights, got {len(ws)}")
    if ybar is not None:
        shapes.append(("ybar", ybar, (N, op.dim_mid), torch.float32))
    for name, t, shape, dtype in shapes:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and len(ws) > MAX_MLP:
        raise ValueError(f"the CUDA fused conv takes a radial MLP of at most {MAX_MLP} layers, "
                         f"got {len(ws)}")


_P = ctypes.c_void_p


UVU_LAYOUT = (UVU_WARPS, UVU_INS, UVU_MAX_D, UVU_BLK, MAX_MLP, UVU_HEADER)


def check_uvu_layout(lib: ctypes.CDLL):
    """Raises unless the kernels of ``lib`` read the uvu task tables and the
    MLP weights as :func:`_uvu_tables` and :class:`_MlpWeights` lay them out
    (warps per CTA, ints per instruction record, largest irrep dimension,
    ints per column-block record, MLP weight slots, header ints), which
    ``csrc/fused_conv_common.cuh`` defines."""
    got = (ctypes.c_int * len(UVU_LAYOUT))()
    lib.fused_conv_uvu_layout(got)
    if tuple(got) != UVU_LAYOUT:
        raise RuntimeError(f"the kernels' uvu table layout (warps, ints per record, largest "
                           f"dimension, ints per block record, MLP weights, header ints) is "
                           f"{tuple(got)}, "
                           f"the host's {UVU_LAYOUT}")


_CARVE_CHECKED = set()


def check_carve(lib_name: str, op: FusedConvOp, dims: _ConvDims, bwd: bool):
    """Raises ValueError, before any launch, when the layer's CTA layout
    (:func:`carve_bytes`) exceeds the shared memory a CTA may have, naming
    the layer's widths, the bytes and the limit; and, at the first launch of
    each layer shape, RuntimeError unless the kernels of ``lib_name`` lay it
    out in as many bytes (their ``fused_conv_smem_bytes``)."""
    nbytes, _ = op.carve(dims, bwd)
    if nbytes > SMEM_LIMIT:
        raise ValueError(
            f"the fused-conv {'backward' if bwd else 'forward'} kernel needs {nbytes} B of shared "
            f"memory per CTA for this layer ({_describe(op.conv, op.mlp_spec.dims)}, "
            f"{dims.K} neighbour slots, column blocks of {dims.wblk}), over the limit of "
            f"{SMEM_LIMIT} B")
    xw = op.plan.carve_xw()
    mblk = op.plan.yblk if bwd else op.plan.mblk
    key = (lib_name, bwd, mblk, xw) + tuple(getattr(dims, f) for f, _ in _ConvDims._fields_[1:])
    if key in _CARVE_CHECKED:
        return
    from .kernels import library

    fn = library(lib_name).fused_conv_smem_bytes
    fn.argtypes = [_ConvDims, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    got = fn(dims, int(bwd), mblk, -1 if xw is None else xw)
    if got != nbytes:
        raise RuntimeError(f"the kernels of {lib_name} lay a CTA out in {got} B, the host's "
                           f"carve_bytes in {nbytes} B: the two copies of carve disagree")
    _CARVE_CHECKED.add(key)


def _ptr(t: torch.Tensor):
    return _P(t.data_ptr())


def _mlp_weights(ws) -> _MlpWeights:
    return _MlpWeights((_P * MAX_MLP)(*[w.data_ptr() for w in ws]))


def _call(lib: str, fn_name: str, *args):
    """Calls C entry ``fn_name`` of library ``lib`` (:func:`.kernels.call`),
    the uvu table layout checked before an entry's first call."""
    from .kernels import call

    call(lib, fn_name, *args, on_load=check_uvu_layout)


def _stream(dev: torch.device):
    return _P(torch.cuda.current_stream(dev).cuda_stream)


def fwd_launch_args(op: FusedConvOp, x, src, a, b, ws):
    """``(library, entry, ctypes arguments, output)`` of the forward
    kernel's launch on checked CUDA tensors: B1 on ``(vec, coef)`` in vec
    mode, B4 on ``(emb, sh)`` in emb/sh mode; the output is ``(N,
    dim_mid)``. ``conv_breakdown.py`` launches the same arguments on the
    profile build."""
    N, K = src.shape
    dims = op.dims(N, K)
    check_carve("fused_conv_fwd", op, dims, bwd=False)
    out = torch.empty((N, op.dim_mid), dtype=torch.float32, device=x.device)
    itab, ftab = op.device_tables(x.device)
    entry = "fused_conv_fwd_launch" if op.embed is not None else "fused_conv_fwd_embsh_launch"
    return ("fused_conv_fwd", entry, (dims, *op.plan.launch_args(False), _ptr(x), _ptr(src),
                                      _ptr(a), _ptr(b),
                                      _mlp_weights(ws), _ptr(itab), _ptr(ftab), _ptr(out),
                                      _stream(x.device)), out)


def bwd_launch_args(op: FusedConvOp, x, src, a, b, ws, ybar, records: bool):
    """``(library, entry, ctypes arguments, outputs)`` of the backward
    kernel's launch on checked CUDA tensors: B2 / B4 bwd, or with
    ``records`` the first pass of B2′ / B4′. The outputs are ``dxg`` and
    ``dvec`` (vec mode) or ``demb, dsh`` (emb/sh mode), then with
    ``records`` the workspace ``work (N*K, stride)`` and ``valid (N*K,)``
    (:func:`_workspace_layout`)."""
    N, K = src.shape
    dev = x.device
    dims = op.dims(N, K)
    check_carve("fused_conv_bwd", op, dims, bwd=True)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty((N * K, op.dim_x), **f32)]
    if op.embed is None:
        outs += [torch.empty((N * K, op.n_basis), **f32), torch.empty((N * K, op.dim_f), **f32)]
    else:
        outs.append(torch.empty((3, N * K), **f32))
    if records:
        outs += [torch.empty((N * K, op.ws_layout["stride"]), **f32),
                 torch.empty(N * K, dtype=torch.uint8, device=dev)]
    name = "fused_conv_bwd" + ("_embsh" if op.embed is None else "") + ("_pg" if records else "")
    layout = [_WsLayout(**op.ws_layout)] if records else []
    itab, ftab = op.device_tables(dev)
    args = (dims, *op.plan.launch_args(True), *layout, _ptr(x), _ptr(src), _ptr(a), _ptr(b),
            _mlp_weights(ws), _ptr(ybar), _ptr(itab), _ptr(ftab),
            *[_ptr(t) for t in outs], _stream(dev))
    return "fused_conv_bwd", name + "_launch", args, tuple(outs)


def launch_fused_conv_fwd(op: FusedConvOp, x, src, a, b, ws):
    """Launches the forward kernel on checked CUDA tensors, without counting
    (its callers count): :func:`fwd_launch_args`. Returns ``(N, dim_mid)``."""
    lib, entry, args, out = fwd_launch_args(op, x, src, a, b, ws)
    _call(lib, entry, *args)
    return out


def _launch_bwd(op: FusedConvOp, x, src, a, b, ws, ybar, records: bool):
    """Launches the backward kernel on checked CUDA tensors:
    :func:`bwd_launch_args`. Returns its outputs."""
    lib, entry, args, outs = bwd_launch_args(op, x, src, a, b, ws, ybar, records)
    _call(lib, entry, *args)
    return outs


def fused_conv_fwd(op: FusedConvOp, x, src, vec, coef, ws):
    """Vec-mode forward conv. CPU tensors: the plain version. CUDA tensors:
    the ``fused_conv_fwd`` kernel (B1, ``csrc/fused_conv_fwd.cu``)."""
    check_conv_inputs(op, False, x, src, vec, coef, ws)
    if x.device.type == "cpu":
        return fused_conv_fwd_plain(op, x, src, vec, coef, ws)
    out = launch_fused_conv_fwd(op, x, src, vec, coef, ws)
    fused_conv_fwd.launches += 1
    return out


fused_conv_fwd.launches = 0


def fused_conv_bwd(op: FusedConvOp, x, src, vec, coef, ws, ybar, param_grads=False):
    """Vec-mode backward conv: ``(dxg, dvec)`` (B2), and with
    ``param_grads`` ``(dxg, dvec, dws, dcoef)``, a gradient per MLP weight (B2′). CPU
    tensors: the plain version. CUDA tensors: the ``fused_conv_bwd`` kernel
    (``csrc/fused_conv_bwd.cu``); with ``param_grads``, its records pass
    :func:`fused_conv_bwd_pg_records` and then :func:`param_grad_reduce`."""
    check_conv_inputs(op, False, x, src, vec, coef, ws, ybar)
    if x.device.type == "cpu":
        return fused_conv_bwd_plain(op, x, src, vec, coef, ws, ybar, param_grads=param_grads)
    if param_grads:
        dxg, dvec, work, valid = fused_conv_bwd_pg_records(op, x, src, vec, coef, ws, ybar)
        dws, dcoef = param_grad_reduce(op, work, valid, *src.shape)
        return dxg, dvec, dws, dcoef
    out = _launch_bwd(op, x, src, vec, coef, ws, ybar, records=False)
    fused_conv_bwd.launches += 1
    return out


fused_conv_bwd.launches = 0


def fused_conv_bwd_pg_records(op: FusedConvOp, x, src, vec, coef, ws, ybar):
    """First pass of B2′ on the card, the ``fused_conv_bwd_pg`` kernel:
    ``(dxg, dvec, work, valid)``, with ``work (N*K, stride)`` the
    per-edge records (:func:`_workspace_layout`) and ``valid (N*K,)`` the
    slots inside the cutoff."""
    check_conv_inputs(op, False, x, src, vec, coef, ws, ybar)
    if x.device.type != "cuda":
        raise ValueError(f"the records of B2′ are made on the card, not on {x.device}")
    out = _launch_bwd(op, x, src, vec, coef, ws, ybar, records=True)
    fused_conv_bwd_pg_records.launches += 1
    return out


fused_conv_bwd_pg_records.launches = 0


def _check_slot(op: FusedConvOp, src_c, buf, slot: int, dev) -> int:
    """Raises ValueError unless ``buf`` is a contiguous fp32 ``(S * RC * K,
    dim_x)`` rolling buffer on ``dev`` for chunks of ``src_c (RC, K)`` and
    ``0 <= slot < S``; returns S."""
    rck = src_c.numel()
    if (buf.dim() != 2 or buf.shape[1] != op.dim_x or rck == 0 or buf.shape[0] % rck
            or buf.dtype != torch.float32 or not buf.is_contiguous() or buf.device != dev):
        raise ValueError(f"buf: expected a contiguous float32 (S * {rck}, {op.dim_x}) tensor on "
                         f"{dev}, got {buf.dtype} {tuple(buf.shape)} on {buf.device}")
    n_slots = buf.shape[0] // rck
    if not 0 <= slot < n_slots:
        raise ValueError(f"slot {slot} outside the buffer's {n_slots} slots")
    return n_slots


def fused_conv_bwd_slot_plain(op: FusedConvOp, x, src_c, vec_c, coef, ws, ybar_c, buf, slot: int):
    """Plain twin of B3: :func:`fused_conv_bwd_plain` on the rows of one
    chunk (``src_c (RC, K)``, ``vec_c (3, RC*K)``, ``ybar_c (RC, dim_mid)``;
    ``x`` holds every atom), its ``dxg`` written into rows ``[slot * RC*K,
    (slot + 1) * RC*K)`` of ``buf`` in place, the other rows untouched.
    Returns the chunk's ``dvec (3, RC*K)``."""
    _check_slot(op, src_c, buf, slot, x.device)
    dxg, dvec = fused_conv_bwd_plain(op, x, src_c, vec_c, coef, ws, ybar_c)
    rck = src_c.numel()
    buf[slot * rck:(slot + 1) * rck] = dxg
    return dvec


def fused_conv_bwd_slot(op: FusedConvOp, x, src_c, vec_c, coef, ws, ybar_c, buf, slot: int):
    """B3, the ring backward's per-chunk kernel: B2 on one row chunk with
    its ``dxg`` written in place into slot ``slot`` of the rolling buffer
    ``buf (S * RC*K, dim_x)``; returns ``dvec (3, RC*K)``. CPU tensors:
    :func:`fused_conv_bwd_slot_plain`. CUDA tensors: the
    ``fused_conv_bwd_slot`` kernel (``csrc/fused_conv_bwd.cu``), B2's
    kernel launched on the chunk with its output at the slot."""
    check_conv_inputs(op, False, x, src_c, vec_c, coef, ws, ybar_c)
    _check_slot(op, src_c, buf, slot, x.device)
    if x.device.type == "cpu":
        return fused_conv_bwd_slot_plain(op, x, src_c, vec_c, coef, ws, ybar_c, buf, slot)
    RC, K = src_c.shape
    dims = op.dims(RC, K)
    check_carve("fused_conv_bwd", op, dims, bwd=True)
    dvec = torch.empty((3, RC * K), dtype=torch.float32, device=x.device)
    itab, ftab = op.device_tables(x.device)
    _call("fused_conv_bwd", "fused_conv_bwd_slot_launch", dims, *op.plan.launch_args(True),
          _ptr(x), _ptr(src_c),
          _ptr(vec_c), _ptr(coef), _mlp_weights(ws), _ptr(ybar_c), _ptr(itab), _ptr(ftab),
          _ptr(buf), ctypes.c_int(slot), _ptr(dvec), _stream(x.device))
    fused_conv_bwd_slot.launches += 1
    return dvec


fused_conv_bwd_slot.launches = 0


def fused_conv_fwd_embsh(op: FusedConvOp, x, src, emb, sh, ws):
    """Emb/sh-mode forward conv. CPU tensors: the plain version. CUDA
    tensors: the ``fused_conv_fwd_embsh`` kernel (B4,
    ``csrc/fused_conv_fwd.cu``)."""
    check_conv_inputs(op, True, x, src, emb, sh, ws)
    if x.device.type == "cpu":
        return fused_conv_fwd_embsh_plain(op, x, src, emb, sh, ws)
    out = launch_fused_conv_fwd(op, x, src, emb, sh, ws)
    fused_conv_fwd_embsh.launches += 1
    return out


fused_conv_fwd_embsh.launches = 0


def fused_conv_bwd_embsh(op: FusedConvOp, x, src, emb, sh, ws, ybar, param_grads=False):
    """Emb/sh-mode backward conv: ``(dxg, demb, dsh)`` (B4 bwd, also serving
    B5), and with ``param_grads`` ``(dxg, demb, dsh, dws)``
    (B4′). CPU tensors: the plain version. CUDA tensors: the
    ``fused_conv_bwd_embsh`` kernel (``csrc/fused_conv_bwd.cu``); with
    ``param_grads``, its records pass :func:`fused_conv_bwd_embsh_pg_records`
    and then :func:`param_grad_reduce`."""
    check_conv_inputs(op, True, x, src, emb, sh, ws, ybar)
    if x.device.type == "cpu":
        return fused_conv_bwd_embsh_plain(op, x, src, emb, sh, ws, ybar, param_grads=param_grads)
    if param_grads:
        dxg, demb, dsh, work, valid = fused_conv_bwd_embsh_pg_records(op, x, src, emb, sh, ws, ybar)
        dws, _ = param_grad_reduce(op, work, valid, *src.shape)
        return dxg, demb, dsh, dws
    out = _launch_bwd(op, x, src, emb, sh, ws, ybar, records=False)
    fused_conv_bwd_embsh.launches += 1
    return out


fused_conv_bwd_embsh.launches = 0


def fused_conv_bwd_embsh_pg_records(op: FusedConvOp, x, src, emb, sh, ws, ybar):
    """First pass of B4′ on the card, the ``fused_conv_bwd_embsh_pg``
    kernel: ``(dxg, demb, dsh, work, valid)``; every slot is valid."""
    check_conv_inputs(op, True, x, src, emb, sh, ws, ybar)
    if x.device.type != "cuda":
        raise ValueError(f"the records of B4′ are made on the card, not on {x.device}")
    out = _launch_bwd(op, x, src, emb, sh, ws, ybar, records=True)
    fused_conv_bwd_embsh_pg_records.launches += 1
    return out


fused_conv_bwd_embsh_pg_records.launches = 0


def fused_conv_bwd_embsh_slot_plain(op: FusedConvOp, x, src_c, emb_c, sh_c, ws, ybar_c, buf,
                                    slot: int):
    """Plain twin of B4 bwd's slot entry: :func:`fused_conv_bwd_embsh_plain`
    on the rows of one chunk (``src_c (RC, K)``, ``emb_c (RC*K, n_basis)``,
    ``sh_c (RC*K, dim_f)``, ``ybar_c (RC, dim_mid)``; ``x`` holds every
    atom), its ``dxg`` written into rows ``[slot * RC*K, (slot + 1) *
    RC*K)`` of ``buf`` in place, the other rows untouched. Returns the
    chunk's ``(demb, dsh)``."""
    _check_slot(op, src_c, buf, slot, x.device)
    dxg, demb, dsh = fused_conv_bwd_embsh_plain(op, x, src_c, emb_c, sh_c, ws, ybar_c)
    rck = src_c.numel()
    buf[slot * rck:(slot + 1) * rck] = dxg
    return demb, dsh


def fused_conv_bwd_embsh_slot(op: FusedConvOp, x, src_c, emb_c, sh_c, ws, ybar_c, buf,
                              slot: int):
    """The emb/sh ring backward's per-chunk kernel: B4 bwd on one row chunk
    with its ``dxg`` written in place into slot ``slot`` of the rolling
    buffer ``buf (S * RC*K, dim_x)``; returns ``(demb, dsh)`` of the chunk.
    CPU tensors: :func:`fused_conv_bwd_embsh_slot_plain`. CUDA tensors: the
    ``fused_conv_bwd_embsh_slot`` entry (``csrc/fused_conv_bwd.cu``), B4
    bwd's kernel launched on the chunk with its output at the slot."""
    check_conv_inputs(op, True, x, src_c, emb_c, sh_c, ws, ybar_c)
    _check_slot(op, src_c, buf, slot, x.device)
    if x.device.type == "cpu":
        return fused_conv_bwd_embsh_slot_plain(op, x, src_c, emb_c, sh_c, ws, ybar_c, buf, slot)
    RC, K = src_c.shape
    dims = op.dims(RC, K)
    check_carve("fused_conv_bwd", op, dims, bwd=True)
    f32 = dict(dtype=torch.float32, device=x.device)
    demb = torch.empty((RC * K, op.n_basis), **f32)
    dsh = torch.empty((RC * K, op.dim_f), **f32)
    itab, ftab = op.device_tables(x.device)
    _call("fused_conv_bwd", "fused_conv_bwd_embsh_slot_launch", dims,
          *op.plan.launch_args(True),
          _ptr(x), _ptr(src_c), _ptr(emb_c), _ptr(sh_c), _mlp_weights(ws), _ptr(ybar_c),
          _ptr(itab), _ptr(ftab), _ptr(buf), ctypes.c_int(slot), _ptr(demb), _ptr(dsh),
          _stream(x.device))
    fused_conv_bwd_embsh_slot.launches += 1
    return demb, dsh


fused_conv_bwd_embsh_slot.launches = 0


REDUCE_LAYOUT = (REDUCE_NT, REDUCE_TM, REDUCE_TN, REDUCE_RK, REDUCE_SA, REDUCE_SB,
                 REDUCE_MAX_CHUNK, REDUCE_MAX_TILES, MAX_MLP + 1)


def check_reduce_layout(lib: ctypes.CDLL):
    """Raises unless the reduction kernel of ``lib`` (``csrc/pg_reduce.cu``)
    has the layout :func:`reduce_tiles` and :func:`reduce_chunk` build for
    (``REDUCE_LAYOUT``)."""
    got = (ctypes.c_int * len(REDUCE_LAYOUT))()
    lib.pg_reduce_layout(got)
    if tuple(got) != REDUCE_LAYOUT:
        raise RuntimeError(f"csrc/pg_reduce.cu has layout {tuple(got)}, the host builds for "
                           f"{REDUCE_LAYOUT}")


def param_grad_reduce(op: FusedConvOp, work, valid, N: int, K: int):
    """Second pass of B2′ and B4′: ``(dws, dcoef)`` summed over the valid
    rows of the workspace (``dcoef`` is ``None`` in emb/sh mode). CPU
    tensors: the plain version. CUDA tensors: the ``pg_reduce`` kernels
    (``csrc/pg_reduce.cu``): one launch over every product's output tiles
    (:func:`reduce_tiles`) and row chunks (:func:`reduce_chunk`), one that
    adds the chunks in turn. The sums run in an order fixed by the shapes:
    two calls give the same bits."""
    shapes = (("work", work, (N * K, op.ws_layout["stride"]), torch.float32),
              ("valid", valid, (N * K,), torch.uint8))
    for name, t, shape, dtype in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if valid.device != work.device:
        raise ValueError(f"valid is on {valid.device}, work on {work.device}")
    if work.device.type == "cpu":
        return param_grad_reduce_plain(op, work, valid)
    if work.device.type != "cuda":
        raise ValueError(f"unsupported device {work.device}")
    from .kernels import call

    if work.data_ptr() % 16:
        raise ValueError("the reduction kernel copies whole 16 bytes: work must start on a "
                         "16-byte boundary")
    dev, rows = work.device, N * K
    prods = op.reduce_products
    tiles, n_tiles, begins, scales, n_prod = op.reduce_args()
    chunk = reduce_chunk(rows)
    partial = torch.empty(-(-rows // chunk) * begins[n_prod.value], dtype=torch.float32,
                          device=dev)
    outs = [torch.empty((da, db) if a >= 0 else (db,), dtype=torch.float32, device=dev)
            for a, da, _, db in prods]
    call("pg_reduce", "pg_reduce_launch", tiles, n_tiles, begins, scales,
         ctypes.cast((_P * len(outs))(*[o.data_ptr() for o in outs]), ctypes.POINTER(_P)),
         n_prod, _ptr(work), _ptr(valid), ctypes.c_int(rows),
         ctypes.c_int(op.ws_layout["stride"]), ctypes.c_int(chunk), _ptr(partial), _stream(dev),
         on_load=check_reduce_layout)
    param_grad_reduce.launches += 1
    n_w = len(op.mlp_spec.dims) - 1
    return outs[:n_w], None if op.embed is None else outs[n_w]


param_grad_reduce.launches = 0


def mirror_gather(dxg: torch.Tensor, mir: torch.Tensor) -> torch.Tensor:
    """``dx[n] = sum_k dxg[mir[n, k]]``: the edges sending from atom n are
    exactly the mirrors of row n's edges, so the scatter of the x-cotangents
    becomes a gather (padded slots point at themselves and carry zeros)."""
    N, K = mir.shape
    return dxg[mir.reshape(-1)].view(N, K, -1).sum(1)


class FusedConvBwd(torch.autograd.Function):
    """The conv's backward as an op of its own, so that the backward is
    itself differentiable: the grad-of-grad a force or stress loss needs in
    training (the port of ``_make_bwd_op``,
    ``sevennet_tpu/ops/fused_conv.py:1250-1298``).

    Forward: B2′ (``(dxg, dvec, dcoef, *dws)``) when ``param_grads``, else
    B2 (``(dxg, dvec)``). Backward: :func:`fused_conv_bwd_vjp_plain`, the
    VJP of the plain pullback with respect to ``(x, vec, coef, ybar, *ws)``
    by ``torch.autograd.grad``.
    That second-order rule is plain PyTorch on purpose, not a fallback: the
    JAX package differentiates its Pallas backward the same way, through
    ``jax.vjp`` of an XLA reference (``:1263-1296``), not through a kernel.
    Its own backward is not differentiable again."""

    @staticmethod
    def forward(ctx, op, param_grads, x, src, vec, coef, ybar, *ws):
        ctx.op = op
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, src, vec, coef, ybar, *ws)
        if not param_grads:
            return fused_conv_bwd(op, x, src, vec, coef, ws, ybar)
        dxg, dvec, dws, dcoef = fused_conv_bwd(op, x, src, vec, coef, ws, ybar, param_grads=True)
        return (dxg, dvec, dcoef, *dws)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cots):
        x, src, vec, coef, ybar, *ws = ctx.saved_tensors
        gx, gvec, gcoef, gybar, *gws = fused_conv_bwd_vjp_plain(
            ctx.op, x, src, vec, coef, ws, ybar, cots)
        return (None, None, gx, None, gvec, gcoef, gybar, *gws)


class FusedConvBwdEmbSh(torch.autograd.Function):
    """The emb/sh-mode backward as a differentiable op, as
    :class:`FusedConvBwd`. Forward: B4′ (``(dxg, demb, dsh, *dws)``) when
    ``param_grads``, else B4 bwd (``(dxg, demb, dsh)``). Backward:
    :func:`fused_conv_bwd_embsh_vjp_plain`, the VJP of the plain pullback
    with respect to ``(x, emb, sh, ybar, *ws)``."""

    @staticmethod
    def forward(ctx, op, param_grads, x, src, emb, sh, ybar, *ws):
        ctx.op = op
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, src, emb, sh, ybar, *ws)
        outs = fused_conv_bwd_embsh(op, x, src, emb, sh, ws, ybar, param_grads=param_grads)
        return (*outs[:3], *outs[3]) if param_grads else outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *cots):
        x, src, emb, sh, ybar, *ws = ctx.saved_tensors
        gx, gemb, gsh, gybar, *gws = fused_conv_bwd_embsh_vjp_plain(
            ctx.op, x, src, emb, sh, ws, ybar, cots)
        return (None, None, gx, None, gemb, gsh, gybar, *gws)


class FusedConvVec(torch.autograd.Function):
    """Vec-mode fused conv with the mirror-gather backward. Forward: B1.
    Backward: :class:`FusedConvBwd`, which runs B2′ when the Bessel
    coefficients or an MLP weight need a gradient (training) and B2
    otherwise (serving, MD); its history is kept, so forces and stress
    computed with ``create_graph=True`` can be differentiated again."""

    @staticmethod
    def forward(ctx, op, x, vec, coef, src, mir, *ws):
        ctx.op = op
        ctx.save_for_backward(x, vec, coef, src, mir, *ws)
        return fused_conv_fwd(op, x, src, vec, coef, ws)

    @staticmethod
    def backward(ctx, ybar):
        x, vec, coef, src, mir, *ws = ctx.saved_tensors
        need = ctx.needs_input_grad   # (op, x, vec, coef, src, mir, *ws)
        param_grads = bool(need[3] or any(need[6:]))
        outs = FusedConvBwd.apply(ctx.op, param_grads, x, src, vec, coef, ybar.contiguous(), *ws)
        dcoef, dws = (outs[2], outs[3:]) if param_grads else (None, (None,) * len(ws))
        return (None, mirror_gather(outs[0], mir), outs[1], dcoef, None, None, *dws)


class FusedConvEmbSh(torch.autograd.Function):
    """Emb/sh-mode fused conv with the mirror-gather backward. Forward: B4.
    Backward: :class:`FusedConvBwdEmbSh`, which runs B4′ when an MLP weight
    needs a gradient (training) and B4 bwd otherwise (serving); ``emb`` and
    ``sh`` get their cotangents either way (the model differentiates them
    to the edge vectors and the Bessel coefficients in plain PyTorch, as
    the JAX package does in XLA)."""

    @staticmethod
    def forward(ctx, op, x, emb, sh, src, mir, *ws):
        ctx.op = op
        ctx.save_for_backward(x, emb, sh, src, mir, *ws)
        return fused_conv_fwd_embsh(op, x, src, emb, sh, ws)

    @staticmethod
    def backward(ctx, ybar):
        x, emb, sh, src, mir, *ws = ctx.saved_tensors
        param_grads = any(ctx.needs_input_grad[6:])   # (op, x, emb, sh, src, mir, *ws)
        outs = FusedConvBwdEmbSh.apply(ctx.op, param_grads, x, src, emb, sh, ybar.contiguous(),
                                       *ws)
        dws = outs[3:] if param_grads else (None,) * len(ws)
        return (None, mirror_gather(outs[0], mir), outs[1], outs[2], None, None, *dws)


def _chunk(RC: int, K: int, j: int, src, vec, ybar):
    """Rows ``[j * RC, (j + 1) * RC)``: ``src_c``, a contiguous copy of the
    chunk's ``(3, RC*K)`` edge-vector columns (as the JAX package slices
    them, ``sevennet_tpu/ops/fused_conv.py:2048``) and ``ybar_c``."""
    a = j * RC
    return src[a:a + RC], vec[:, a * K:(a + RC) * K].contiguous(), ybar[a:a + RC]


def ring_slot(c: int, W: int) -> int:
    """Slot of chunk ``c`` in the ring backward's buffer of ``4W + 1``
    slots (``sevennet_tpu/ops/fused_conv.py:2032-2033``): chunks 0 ..
    2W-1 pinned in slots 2W+1 .. 4W, the others cycling through slot
    ``c % (2W + 1)``."""
    span = 2 * W + 1
    return span + c if c < 2 * W else c % span


def _summed(total, part):
    """``total + part`` entrywise (``part`` when ``total`` is None): the
    per-chunk parameter gradients summed in chunk order."""
    return list(part) if total is None else [a + b for a, b in zip(total, part)]


def _scatter_loop(x, src, RC: int, chunk_bwd):
    """The chunked scatter backward's loop, for either mode: chunk by chunk,
    ``chunk_bwd(j)`` gives the chunk's ``dxg (RC*K, dim_x)`` and parameter
    gradients (None without), and ``dxg`` is added into ``dx`` at the
    chunk's senders with ``index_add_``. ``dx`` has ``x``'s rows, which may
    be more than the receivers (the ext conv's ghost senders). Returns
    ``(dx, parameter gradients summed in chunk order)``."""
    dx = torch.zeros_like(x)
    pg = None
    for j in range(src.shape[0] // RC):
        dxg, pg_c = chunk_bwd(j)
        dx.index_add_(0, src[j * RC:(j + 1) * RC].reshape(-1).long(), dxg)
        if pg_c is not None:
            pg = _summed(pg, pg_c)
    return dx, pg


def _ring_loop(x, mir, RC: int, W: int, chunk_bwd):
    """The ring backward's loop, for either mode: a buffer of ``S = 4W + 1``
    slots of ``RC*K`` rows keeps the window's ``dxg`` live. Chunks 0 ..
    2W-1 sit pinned in slots ``2W+1 .. 4W`` (the wrapped windows of the
    first and last W destinations need them at the end); the others cycle
    through slot ``c % (2W + 1)`` (:func:`ring_slot`). Iteration ``j`` runs
    ``chunk_bwd(j, (buf, slot))``, which writes chunk ``j``'s ``dxg`` into
    its slot and gives its parameter gradients (None without), and, once
    ``j >= 2W``, emits destination ``j - W``, whose window is then
    computed: ``dx`` of its rows is the sum of the buffer rows of its
    mirrors, each gathered once. A gather-only epilogue emits the 2W
    wrapped destinations. Returns ``(dx, parameter gradients summed in
    chunk order)``."""
    N, K = mir.shape
    nb, rck = N // RC, RC * K
    slots = torch.tensor([ring_slot(c, W) for c in range(nb)], device=x.device)
    buf = torch.empty(((4 * W + 1) * rck, x.shape[1]), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)

    def emit(i):
        m = mir[i * RC:(i + 1) * RC].reshape(-1)
        q = m // rck
        rows = slots[q] * rck + (m - q * rck)
        dx[i * RC:(i + 1) * RC] = buf[rows].view(RC, K, -1).sum(1)

    pg = None
    for j in range(nb):
        pg_c = chunk_bwd(j, (buf, ring_slot(j, W)))
        if pg_c is not None:
            pg = _summed(pg, pg_c)
        if j >= 2 * W:
            emit(j - W)
    for d in [*range(W), *range(nb - W, nb)]:
        emit(d)
    return dx, pg


class FusedConvChunked(torch.autograd.Function):
    """The conv of a large system with its backward chunk by chunk, in
    either mode: ``(a, b)`` is ``(vec, coef)`` in vec mode (the port of
    ``_fused_conv_chunked_v`` and ``_fused_conv_ring_v``,
    ``sevennet_tpu/ops/fused_conv.py:1606-1691`` and ``:1962-2157``) and
    ``(emb, sh)`` in emb/sh mode (``_fused_conv_chunked`` and
    ``_fused_conv_ring``, ``:1704-1781`` and ``:1803-1918``). The row count
    must be a multiple of ``RC``.

    Forward: one B1 / B4 launch over all rows (the JAX chunk loop bounds an
    XLA gather of ``x[src]`` that the kernel does itself; the function is
    the same). Backward, chunk by chunk, on the chunk's own ``src``,
    ``ybar`` and edge rows (the chunk's ``emb``/``sh`` rows pair with its
    ``src`` rows: the port has no k-major block layout to mismatch):

    - ``W == 0``, the chunked scatter backward (:func:`_scatter_loop`): B2
      / B4 bwd, and ``dxg`` added into ``dx`` at the chunk's senders; it
      takes any atom order and a sender set larger than the receivers (the
      ext conv);
    - ``W > 0``, the ring backward (:func:`_ring_loop`) of a cell-sorted
      system: ``N = nb * RC``, ``nb >= 2W + 1``, and the mirror of every
      edge of chunk ``i`` in chunks ``i - W .. i + W``, circularly
      (:func:`fused_conv_apply_vec` raises on a call that breaks it). B3 /
      B4 bwd's slot entry write ``dxg`` into the chunk's slot.

    With parameter gradients each chunk runs B2′ / B4′ (summed in chunk
    order; in the ring its ``dxg`` is copied into the slot). The edge
    cotangents (``dvec`` columns, ``demb``/``dsh`` rows) are copied out per
    chunk: no ``(N*K, dim_x)`` tensor exists at once. The JAX package's
    window-local gather of ``x`` (``_windowed_xg``, ``:1937-1958``) speeds
    up an XLA row gather; the kernels gather ``x[src]`` themselves and have
    no counterpart of it. First order only: a second backward raises, as
    the JAX chunked and ring paths offer no grad-of-grad."""

    @staticmethod
    def forward(ctx, op, RC, W, x, a, b, src, mir, *ws):
        ctx.op, ctx.RC, ctx.W = op, RC, W
        ctx.save_for_backward(x, a, b, src, mir, *ws)
        fwd = fused_conv_fwd if op.embed is not None else fused_conv_fwd_embsh
        return fwd(op, x, src, a, b, ws)

    @staticmethod
    @once_differentiable
    def backward(ctx, ybar):
        x, a, b, src, mir, *ws = ctx.saved_tensors
        op, RC, W = ctx.op, ctx.RC, ctx.W
        vec = op.embed is not None
        need = ctx.needs_input_grad  # (op, RC, W, x, a, b, src, mir, *ws)
        param_grads = bool(any(need[8:]) or (vec and need[5]))
        ybar = ybar.contiguous()
        K = src.shape[1]
        rck = RC * K
        da = torch.empty_like(a)
        db = None if vec else torch.empty_like(b)

        def chunk_bwd(j, slot=None):
            rows = slice(j * rck, (j + 1) * rck)
            src_c, yb = src[j * RC:(j + 1) * RC], ybar[j * RC:(j + 1) * RC]
            if vec:
                a_c, b_c = a[:, rows].contiguous(), b
            else:
                a_c, b_c = a[rows], b[rows]
            if slot is not None and not param_grads:
                slot_fn = fused_conv_bwd_slot if vec else fused_conv_bwd_embsh_slot
                edge = slot_fn(op, x, src_c, a_c, b_c, ws, yb, *slot)
                dxg, pg = None, None
            else:
                bwd = fused_conv_bwd if vec else fused_conv_bwd_embsh
                outs = bwd(op, x, src_c, a_c, b_c, ws, yb, param_grads=param_grads)
                dxg, edge = outs[0], outs[1] if vec else outs[1:3]
                pg = ([outs[3], *outs[2]] if vec else list(outs[3])) if param_grads else None
                if slot is not None:
                    buf, s = slot
                    buf[s * rck:(s + 1) * rck] = dxg
            if vec:
                da[:, rows] = edge
            else:
                da[rows], db[rows] = edge
            return pg if slot is not None else (dxg, pg)

        if W:
            dx, pg = _ring_loop(x, mir, RC, W, chunk_bwd)
        else:
            dx, pg = _scatter_loop(x, src, RC, chunk_bwd)
        if vec:
            db, *dws = pg or [None] * (1 + len(ws))
        else:
            dws = pg or [None] * len(ws)
        return (None, None, None, dx, da, db, None, None, *dws)


def _weights(mlp_params):
    return tuple(mlp_params["w"]) if isinstance(mlp_params, dict) else tuple(mlp_params)


def _apply_chunked(op, x, a, b, src, mir, ws, row_chunk: int, ring: int, cutoff=None):
    """:class:`FusedConvChunked` as both modes' apply functions call it:
    ``(a, b)`` is ``(vec, coef)`` (vec mode) or ``(emb, sh)``, all
    contiguous, ``src`` int32, ``mir`` int64 (None for the scatter
    backward). ``ring = W > 0`` runs the ring backward after checking its
    contract: the rows split into ``nb >= 2W + 1`` chunks of ``RC``, and
    every edge's mirror within W chunks of its row (one host read; a call
    that breaks it raises). Otherwise the chunked scatter backward, the rows
    padded to a multiple of ``RC`` with zero features, sender 0 and inert
    edges (sentinel vectors past ``cutoff`` in vec mode, zero ``emb`` and
    ``sh`` in emb/sh mode; ``sevennet_tpu/ops/fused_conv.py:2196-2216``,
    ``:2267-2289``), whose senders get exact zeros; ``x`` is padded only
    where it has fewer rows than the padded receivers. Returns the
    receivers' ``(n, dim_mid)``."""
    n, K = src.shape
    RC = int(row_chunk)
    if ring:
        W = int(ring)
        if n % RC or n // RC < 2 * W + 1:
            raise ValueError(f"the ring backward needs row_chunk ({RC}) to divide the row count "
                             f"({n}) into >= 2W+1 = {2 * W + 1} chunks")
        # a mirror farther than W chunks from its row would be read from a
        # slot that already holds another chunk; unmatched and padded slots
        # are their own mirrors
        nb = n // RC
        rows = torch.arange(n, device=mir.device)[:, None] // RC
        d = torch.remainder(mir // K // RC - rows, nb)
        if bool(((d > W) & (d < nb - W)).any()):
            raise ValueError(f"the ring backward needs every edge's mirror within W = {W} chunks "
                             f"of {RC} rows of its own row: sort the atoms by cell (MDEngine "
                             "does), or run with conv_ring 0 (the chunked scatter backward)")
        return FusedConvChunked.apply(op, RC, W, x, a, b, src, mir, *ws)
    pad = -n % RC
    if pad:
        if op.embed is not None:
            sentinel = torch.zeros((3, pad * K), dtype=a.dtype, device=a.device)
            sentinel[0] = 2.0 * cutoff
            a = torch.cat([a, sentinel], 1)
        else:
            a, b = (torch.cat([t, t.new_zeros((pad * K, t.shape[1]))]) for t in (a, b))
        src = torch.cat([src, src.new_zeros((pad, K))])
    if x.shape[0] < n + pad:
        x = torch.cat([x, x.new_zeros((n + pad - x.shape[0], x.shape[1]))])
    return FusedConvChunked.apply(op, RC, 0, x, a, b, src, None, *ws)[:n]


def _int32(src: torch.Tensor) -> torch.Tensor:
    return (src if src.dtype == torch.int32 else src.to(torch.int32)).contiguous()


def fused_conv_apply_vec(
    conv: ConvTPSpec,
    mlp_spec: ScalarMLPSpec,
    mlp_params,
    bessel_coef: torch.Tensor,   # (n_basis,) or (n_basis, 1)
    embed: EdgeEmbedSpec,
    x: torch.Tensor,             # (N, dim_x)
    vec_rows: torch.Tensor,      # (3, N*K) receiver-major, sentinel on padding
    src_nk: torch.Tensor,        # (N, K)
    mir_nk: torch.Tensor,        # (N, K) flat mirror indices
    *,
    plain: bool = False,
    row_chunk: int = 0,
    ring: int = 0,
) -> torch.Tensor:
    """The vec-mode fused conv as the model calls it: ``(N, dim_mid)`` (the
    port of ``sevennet_tpu/ops/fused_conv.py:fused_conv_apply_vec``).

    ``row_chunk = RC`` (rows, any positive count) below the row count runs
    the backward chunk by chunk (:class:`FusedConvChunked`): with ``ring =
    W > 0`` the ring backward (the rows must split into ``nb >= 2W + 1``
    chunks of ``RC``, and every edge's mirror must lie within W chunks of
    its row, as the MD engine's cell sort makes it: a call that breaks this
    raises), else the chunked scatter backward, the rows padded to a
    multiple of ``RC`` with zero features and sentinel edge vectors.
    Without it, the unchunked mirror backward (:class:`FusedConvVec`).

    ``plain=True`` runs :func:`fused_conv_fwd_plain` under ordinary autograd
    instead of the kernels, on any device: the reference the kernels are
    held against."""
    op = conv_op(conv, mlp_spec, embed)
    ws = _weights(mlp_params)
    coef = bessel_coef.reshape(-1)
    if plain:
        return fused_conv_fwd_plain(op, x, src_nk, vec_rows, coef, ws)
    args = (x.contiguous(), vec_rows.contiguous(), coef.contiguous())
    ws = [w.contiguous() for w in ws]
    if row_chunk and row_chunk < src_nk.shape[0]:
        return _apply_chunked(op, *args, _int32(src_nk), mir_nk.long(), ws, row_chunk, ring,
                              embed.cutoff)
    return FusedConvVec.apply(op, *args, _int32(src_nk), mir_nk.long(), *ws)


def fused_conv_apply(
    conv: ConvTPSpec,
    mlp_spec: ScalarMLPSpec,
    mlp_params,
    x: torch.Tensor,             # (N, dim_x)
    emb_nk: torch.Tensor,        # (N, K, n_basis), zero on padded slots
    sh_nk: torch.Tensor,         # (N, K, dim_f)
    src_nk: torch.Tensor,        # (N, K)
    mir_nk: torch.Tensor,        # (N, K) flat mirror indices
    *,
    plain: bool = False,
    row_chunk: int = 0,
    ring: int = 0,
) -> torch.Tensor:
    """The emb/sh-mode fused conv as the model calls it: ``(N, dim_mid)``
    (the port of ``sevennet_tpu/ops/fused_conv.py:fused_conv_apply``).
    Gradients reach ``x``, ``emb``, ``sh`` and the MLP weights.

    ``row_chunk`` and ``ring`` as in :func:`fused_conv_apply_vec`: the
    chunked scatter backward (rows padded with zero ``x``, ``emb`` and
    ``sh`` and sender 0) or, with ``ring = W``, the ring backward on B4
    bwd's slot entry (the JAX package's emb/sh ring is W = 1, which the MD
    engine sizes). Without ``row_chunk``, the unchunked mirror backward
    (:class:`FusedConvEmbSh`).

    ``plain=True`` runs :func:`fused_conv_fwd_embsh_plain` under ordinary
    autograd instead of the kernels, on any device."""
    op = conv_op(conv, mlp_spec, None)
    ws = _weights(mlp_params)
    N, K = src_nk.shape
    emb, sh = emb_nk.reshape(N * K, -1), sh_nk.reshape(N * K, -1)
    if plain:
        return fused_conv_fwd_embsh_plain(op, x, src_nk, emb, sh, ws)
    args = (x.contiguous(), emb.contiguous(), sh.contiguous())
    ws = [w.contiguous() for w in ws]
    if row_chunk and row_chunk < N:
        return _apply_chunked(op, *args, _int32(src_nk), mir_nk.long(), ws, row_chunk, ring)
    return FusedConvEmbSh.apply(op, *args, _int32(src_nk), mir_nk.long(), *ws)


def fused_conv_apply_ext_vec(
    conv: ConvTPSpec,
    mlp_spec: ScalarMLPSpec,
    mlp_params,
    bessel_coef: torch.Tensor,   # (n_basis,) or (n_basis, 1)
    embed: EdgeEmbedSpec,
    x_ext: torch.Tensor,         # (N_ext, dim_x): owned rows first, then ghosts
    vec_rows: torch.Tensor,      # (3, N*K) receiver-major, sentinel on padding
    src_nk: torch.Tensor,        # (N, K) indices into x_ext
    *,
    plain: bool = False,
    row_chunk: int = 0,
) -> torch.Tensor:
    """Vec-mode fused conv whose senders index an extended feature set
    (owned and ghost rows, distributed MD): ``(N, dim_mid)`` for the ``N``
    receivers of ``src_nk`` (the port of
    ``sevennet_tpu/ops/fused_conv.py:fused_conv_apply_ext_vec``). Always
    the chunked scatter backward (chunks of ``row_chunk`` rows, or one of
    all rows), so the x-cotangent covers the ghost rows too; see
    :func:`fused_conv_apply_ext`."""
    op = conv_op(conv, mlp_spec, embed)
    ws = _weights(mlp_params)
    coef = bessel_coef.reshape(-1)
    if plain:
        return fused_conv_fwd_plain(op, x_ext, src_nk, vec_rows, coef, ws)
    return _apply_chunked(op, x_ext.contiguous(), vec_rows.contiguous(), coef.contiguous(),
                          _int32(src_nk), None, [w.contiguous() for w in ws],
                          min(row_chunk or src_nk.shape[0], src_nk.shape[0]), 0, embed.cutoff)


def fused_conv_apply_ext(
    conv: ConvTPSpec,
    mlp_spec: ScalarMLPSpec,
    mlp_params,
    x_ext: torch.Tensor,         # (N_ext, dim_x): owned rows first, then ghosts
    emb_nk: torch.Tensor,        # (N, K, n_basis), zero on padded slots
    sh_nk: torch.Tensor,         # (N, K, dim_f)
    src_nk: torch.Tensor,        # (N, K) indices into x_ext
    *,
    plain: bool = False,
    row_chunk: int = 0,
) -> torch.Tensor:
    """Emb/sh-mode fused conv whose senders index an extended feature set
    (owned and ghost rows, distributed domain decomposition): ``(N,
    dim_mid)`` for the ``N`` receivers of ``src_nk`` (the port of
    ``sevennet_tpu/ops/fused_conv.py:fused_conv_apply_ext``). Always the
    chunked scatter backward: the mirror reduction assumes a symmetric
    neighbour list, which domain boundaries break (a ghost sender's reverse
    edge lives on another rank), so ``dx`` covers every row of ``x_ext``
    and flows back through the halo exchange's transpose."""
    op = conv_op(conv, mlp_spec, None)
    ws = _weights(mlp_params)
    N, K = src_nk.shape
    emb, sh = emb_nk.reshape(N * K, -1), sh_nk.reshape(N * K, -1)
    if plain:
        return fused_conv_fwd_embsh_plain(op, x_ext, src_nk, emb, sh, ws)
    return _apply_chunked(op, x_ext.contiguous(), emb.contiguous(), sh.contiguous(),
                          _int32(src_nk), None, [w.contiguous() for w in ws],
                          min(row_chunk or N, N), 0)
