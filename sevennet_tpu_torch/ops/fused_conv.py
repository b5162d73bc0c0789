"""Fused convolution of the dense ``(N, K)`` layout: radial MLP, uvu tensor
product and the sum over each receiver's neighbour slots, forward and
backward (PyTorch port of ``sevennet_tpu/ops/fused_conv.py``; the chunked
and ring paths of large systems are ported for vec mode only). Two modes,
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
  order); :func:`fused_conv_bwd` and :func:`fused_conv_bwd_embsh` with
  ``param_grads=True`` run both;
- ``fused_conv_bwd_slot`` (B3): replaces ``make_fused_conv_bwd2`` with
  ``out_slots > 1``: B2 on one row chunk, writing its ``dxg`` into a slot
  of the ring backward's rolling buffer (:class:`FusedConvRingVec`).

Large systems (vec mode, :func:`fused_conv_apply_vec` with ``row_chunk``)
run the backward chunk by chunk: the ring backward (B3 per chunk and a
windowed mirror gather) or the chunked scatter backward (B2 per chunk and
``index_add_``); :func:`chunk_threshold` decides where chunking starts.

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
    "ring_slot",
    "FusedConvChunkedVec",
    "FusedConvRingVec",
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


# default of chunk_threshold(), a projection: the unchunked MD step's peak
# memory at 99,999 atoms is 2.34 x the gathered edge tensor (26.33 GiB for
# 12.10 GB, SevenNet-0 on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md, MD);
# scaled linearly, a 60 GiB peak is reached at 27.6 GB. No step near that
# size has been measured (ROADMAP A2)
CHUNK_THRESHOLD_BYTES = 27_500_000_000


def chunk_threshold() -> int:
    """Size in bytes of a layer's gathered edge tensor (``N * K * dim_x *
    4``) above which the conv runs its backward in row chunks (the ring or
    the chunked scatter path) instead of the unchunked mirror path; the
    counterpart of ``sevennet_tpu/ops/fused_conv.py:chunk_threshold``, with
    the same override ``SEVENNET_TPU_CHUNK_THRESHOLD``. The JAX default
    (3 GB) was sized for a 16 GB chip; this one keeps the unchunked path,
    the faster, wherever its peak, projected linearly from one MD step
    measured at 99,999 atoms, stays under about 60 GiB of the H100's 80
    GB: about 225k water atoms with SevenNet-0 (derivation and measured
    peaks: PERF.md, MD). It is a projection: no unchunked step near the
    threshold has been measured, and the calculator's and the trainer's
    peaks per gathered byte not at all. Training refuses a layer that
    chunks (:func:`~sevennet_tpu_torch.model.model.model_compute`)."""
    return int(os.environ.get("SEVENNET_TPU_CHUNK_THRESHOLD", CHUNK_THRESHOLD_BYTES))


# ---------------------------------------------------------------------------
# static per-layer tables
# ---------------------------------------------------------------------------


class _ConvDims(ctypes.Structure):
    """ctypes mirror of ``struct ConvDims`` (csrc/fused_conv_common.cuh)."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "N", "K", "dim_x", "dim_mid", "numel", "R", "dim_f", "n_basis", "h1", "h2",
        "lmax", "cutoff_kind",
    )] + [(n, ctypes.c_float) for n in ("cutoff", "cutoff_arg", "act_cst")] + [
        (n, ctypes.c_int) for n in (
            "sh_terms", "n_sh", "shd_terms", "n_shd",
            "w3j", "sh_coef", "shd_coef",
        )
    ]


_WS_FIELDS = ("stride", "emb", "h1", "h2", "dz1", "dz2", "dw", "dc")


class _WsLayout(ctypes.Structure):
    """ctypes mirror of ``struct WsLayout`` (csrc/fused_conv_bwd.cu)."""

    _fields_ = [(n, ctypes.c_int) for n in _WS_FIELDS]


def _workspace_layout(dims, dcoef: bool = True) -> Dict[str, int]:
    """Columns of the per-edge record that kernels B2′ and B4′ write for the
    parameter gradients (``csrc/fused_conv_bwd.cu``): the MLP's input and
    hidden activations ``emb, h1, h2``, their cotangents ``dz1, dz2, dw``
    and, with ``dcoef`` (vec mode), the per-edge ``dcoef`` terms, in this
    order (without, ``dc`` is the end of the record); the row ``stride`` is
    rounded up to 4 floats. Zeros for an MLP the kernels do not take."""
    if len(dims) != 4:
        return dict.fromkeys(_WS_FIELDS, 0)
    nb, h1, h2, numel = dims
    out, col = {}, 0
    for name, width in zip(_WS_FIELDS[1:], (nb, h1, h2, h1, h2, numel, nb if dcoef else 0)):
        out[name] = col
        col += width
    out["stride"] = -(-col // 4) * 4
    return out


UVU_HEADER = 12   # ints at the start of the int table: the uvu task tables' places
UVU_INS = 64      # ints per instruction record
UVU_MAX_D = 7     # irrep dimensions the uvu tables take (l <= 3)
UVU_WARPS = 8     # warps per CTA of the kernels (csrc NWARP; check_uvu_layout)


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


def _uvu_tables(conv: ConvTPSpec, instr) -> np.ndarray:
    """Task tables of the kernels' uvu steps on the tensor cores
    (``csrc/fused_conv_common.cuh``, ``uvu_*``), at the start of the int
    table: a header ``[off_ins, n_dt, off_dt, n_dx, off_dx, off_list, n_fw,
    off_fw, runs_dt, runs_dx, runs_fw, 0]``; per instruction a record of
    UVU_INS ints ``[x_start, d1, d3, mul, w_start, ybar start (g_start +
    u_off), u_tot, 0]`` and the Wigner row r of each (m, p), ``rtab[m * 7 +
    p]`` (-1 where the pair has no row); ``dtmp`` tasks ``(instruction, m,
    0, 0)``; ``dxg``/``dw`` tasks ``(x_start, d1, mul, list start, list
    length, u0, 0, 0)``, one per x irrep and 8 channels from ``u0``, over
    the instructions that read the irrep (listed at ``off_list``); forward
    tasks ``(instruction, u0, 0, 0)``, 16 channels each. Each task list is
    ordered by warp: warp w takes tasks ``runs[w] .. runs[w + 1]`` of the
    list (:func:`_balanced`, costs in tensor-core steps; ``runs_*`` are
    UVU_WARPS + 1 ints). Offsets in ints, each table on 4 ints."""
    recs = np.full((len(instr), UVU_INS), -1, np.int64)
    dt, fw = [], []
    for k, ins in enumerate(instr):
        d1, d3, mul = ins["d1"], ins["d3"], ins["mul"]
        if max(d1, d3) > UVU_MAX_D:
            raise ValueError(f"the fused conv takes irreps up to l = 3, got dimensions {d1}, {d3}")
        recs[k, :8] = [ins["x_start"], d1, d3, mul, ins["w_start"],
                       ins["g_start"] + ins["u_off"], ins["u_tot"], 0]
        for m, p, r in ins["mp"]:
            recs[k, 8 + m * UVU_MAX_D + p] = r
        dt += [(k, m, 0, 0) for m in range(d1)]
        fw += [(k, u0, 0, 0) for u0 in range(0, mul, 16)]
    dx, dx_cost, lists = [], [], []
    for sl, mi in zip(conv.irreps_x.slices(), conv.irreps_x):
        readers = [k for k, ins in enumerate(instr) if ins["x_start"] == sl.start]
        for u0 in range(0, mi.mul, 8):
            dx.append((sl.start, mi.ir.dim, mi.mul, len(lists), len(readers), u0, 0, 0))
            dx_cost.append(1 + mi.ir.dim * len(readers))
        lists += readers
    dt, dt_runs = _balanced(dt, [-(-instr[k]["mul"] // 8) for k, _, _, _ in dt])
    dx, dx_runs = _balanced(dx, dx_cost)
    fw, fw_runs = _balanced(fw, [2 * instr[k]["d1"] for k, _, _, _ in fw])
    parts = [np.zeros(UVU_HEADER, np.int64), recs, dt, dx, lists, fw, dt_runs, dx_runs, fw_runs]
    parts = [np.asarray(a, np.int64).reshape(-1) for a in parts]
    parts = [np.concatenate([a, np.zeros(-a.size % 4, np.int64)]) for a in parts]
    offs = np.cumsum([0] + [a.size for a in parts[:-1]])
    parts[0][:] = [offs[1], len(dt), offs[2], len(dx), offs[3], offs[4], len(fw), offs[5],
                   offs[6], offs[7], offs[8], 0]
    return np.concatenate(parts)


class FusedConvOp:
    """Static tables of one conv layer: the instruction tables of the JAX
    kernels, and for the CUDA kernels the uvu product's instruction records
    and task lists (:func:`_uvu_tables`) and, in vec mode, the spherical
    harmonics and their derivatives as monomial terms. ``embed=None`` is
    emb/sh mode. Device copies are cached per device."""

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

        ints: List[np.ndarray] = [_uvu_tables(conv, instr)]
        offs: Dict[str, int] = {}

        def put(name, arr):
            offs[name] = sum(a.size for a in ints)
            ints.append(np.asarray(arr, np.int64).reshape(-1))

        # int4 arrays start on a 16-byte boundary (the uvu tables end on one)
        put("sh_terms", np.asarray(sh_t).reshape(-1, 4))
        pad = (-sum(a.size for a in ints)) % 4
        if pad:
            ints.append(np.zeros(pad, np.int64))
        put("shd_terms", np.concatenate([np.asarray(shd_t).reshape(-1), shd_comp]))
        itab = np.concatenate(ints)
        assert itab.max() < 2**31
        self.itab = itab.astype(np.int32)
        floats = [w3j_pack.reshape(-1), np.asarray(sh_c, np.float32),
                  np.asarray(shd_c, np.float32)]
        self.ftab = np.concatenate(floats).astype(np.float32)
        self._offs = dict(offs, n_sh=len(sh_c), n_shd=len(shd_c), w3j=0,
                          sh_coef=w3j_pack.size, shd_coef=w3j_pack.size + len(sh_c))
        self.ws_layout = _workspace_layout(mlp_spec.dims, dcoef=embed is not None)
        self._device_tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def device_tables(self, device: torch.device):
        if device not in self._device_tables:
            self._device_tables[device] = (
                torch.as_tensor(self.itab, device=device),
                torch.as_tensor(self.ftab, device=device),
            )
        return self._device_tables[device]

    def dims(self, N: int, K: int) -> _ConvDims:
        e, d = self.embed, self.mlp_spec.dims
        geometry = {} if e is None else dict(
            lmax=e.lmax, cutoff_kind=0 if e.cutoff_kind == "poly_cut" else 1,
            cutoff=e.cutoff, cutoff_arg=e.cutoff_arg)
        return _ConvDims(
            N=N, K=K, dim_x=self.dim_x, dim_mid=self.dim_mid, numel=self.numel,
            R=self.R, dim_f=self.dim_f, n_basis=self.n_basis, h1=d[1], h2=d[2],
            act_cst=NORMALIZE2MOM_CST["silu"], **geometry, **self._offs,
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
    cols = op.ws_layout
    rows = torch.where(valid.bool()[:, None], work, torch.zeros((), dtype=work.dtype,
                                                                device=work.device))
    nb, h1, h2, numel = op.mlp_spec.dims

    def take(name, width):
        return rows[:, cols[name] : cols[name] + width]

    dws = [
        (take(h, a).T @ take(g, b)) / math.sqrt(a)
        for h, a, g, b in (("emb", nb, "dz1", h1), ("h1", h1, "dz2", h2), ("h2", h2, "dw", numel))
    ]
    return dws, None if op.embed is None else take("dc", nb).sum(0)


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
    if dev.type == "cuda" and len(ws) != 3:
        raise ValueError("the CUDA fused conv takes a radial MLP with two hidden layers")


_P = ctypes.c_void_p
# workspace rows per CTA of the reduction kernel's first pass
REDUCE_CHUNK = 1024


def check_uvu_layout(lib: ctypes.CDLL):
    """Raises unless the kernels of ``lib`` read the uvu task tables as
    :func:`_uvu_tables` lays them out (warps per CTA, record size, largest
    irrep dimension), which ``csrc/fused_conv_common.cuh`` defines."""
    got = (ctypes.c_int * 3)()
    lib.fused_conv_uvu_layout(got)
    if tuple(got) != (UVU_WARPS, UVU_INS, UVU_MAX_D):
        raise RuntimeError(f"the kernels' uvu table layout (warps, ints per record, largest "
                           f"dimension) is {tuple(got)}, the host's "
                           f"{(UVU_WARPS, UVU_INS, UVU_MAX_D)}")


def _entry(name: str, fn_name: str, argtypes):
    from .kernels import library

    lib = library(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        check_uvu_layout(lib)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor):
    return _P(t.data_ptr())


def _call(lib: str, fn_name: str, *args):
    """Calls C entry ``fn_name`` of library ``lib`` with ``args`` (ctypes
    structs and pointers; the argument types are theirs) and raises if the
    launch failed."""
    rc = _entry(lib, fn_name, [type(a) for a in args])(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {rc}")


def _stream(dev: torch.device):
    return _P(torch.cuda.current_stream(dev).cuda_stream)


def fwd_launch_args(op: FusedConvOp, x, src, a, b, ws):
    """``(library, entry, ctypes arguments, output)`` of the forward
    kernel's launch on checked CUDA tensors: B1 on ``(vec, coef)`` in vec
    mode, B4 on ``(emb, sh)`` in emb/sh mode; the output is ``(N,
    dim_mid)``. ``conv_breakdown.py`` launches the same arguments on the
    profile build."""
    N, K = src.shape
    out = torch.empty((N, op.dim_mid), dtype=torch.float32, device=x.device)
    itab, ftab = op.device_tables(x.device)
    entry = "fused_conv_fwd_launch" if op.embed is not None else "fused_conv_fwd_embsh_launch"
    return ("fused_conv_fwd", entry, (op.dims(N, K), _ptr(x), _ptr(src), _ptr(a), _ptr(b),
                                      *[_ptr(w) for w in ws], _ptr(itab), _ptr(ftab), _ptr(out),
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
    args = (op.dims(N, K), *layout, _ptr(x), _ptr(src), _ptr(a), _ptr(b),
            *[_ptr(w) for w in ws], _ptr(ybar), _ptr(itab), _ptr(ftab),
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
    ``param_grads`` ``(dxg, dvec, [dW1, dW2, dW3], dcoef)`` (B2′). CPU
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
    dvec = torch.empty((3, RC * K), dtype=torch.float32, device=x.device)
    itab, ftab = op.device_tables(x.device)
    _call("fused_conv_bwd", "fused_conv_bwd_slot_launch", op.dims(RC, K), _ptr(x), _ptr(src_c),
          _ptr(vec_c), _ptr(coef), *[_ptr(w) for w in ws], _ptr(ybar_c), _ptr(itab), _ptr(ftab),
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
    B5), and with ``param_grads`` ``(dxg, demb, dsh, [dW1, dW2, dW3])``
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


def param_grad_reduce(op: FusedConvOp, work, valid, N: int, K: int):
    """Second pass of B2′ and B4′: ``(dws, dcoef)`` summed over the valid
    rows of the workspace (``dcoef`` is ``None`` in emb/sh mode). CPU
    tensors: the plain version. CUDA tensors: the ``param_grad_reduce``
    kernels (``csrc/fused_conv_bwd.cu``), whose sums run in a fixed order
    (chunks of ``REDUCE_CHUNK`` rows, then the chunks in turn): the result
    does not depend on the launch."""
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
    dev = work.device
    nb, h1, h2, numel = op.mlp_spec.dims
    n_dc = 0 if op.embed is None else nb
    n_chunks = -(-N * K // REDUCE_CHUNK)
    partial = torch.empty(n_chunks * (nb * h1 + h1 * h2 + h2 * numel + n_dc),
                          dtype=torch.float32, device=dev)
    dws = [torch.empty((a, b), dtype=torch.float32, device=dev)
           for a, b in ((nb, h1), (h1, h2), (h2, numel))]
    dcoef = torch.empty(nb, dtype=torch.float32, device=dev) if n_dc else None
    _call("fused_conv_bwd", "param_grad_reduce_launch", op.dims(N, K),
          _WsLayout(**op.ws_layout), _ptr(work), _ptr(valid), ctypes.c_int(REDUCE_CHUNK),
          _ptr(partial), *[_ptr(w) for w in dws], _P(dcoef.data_ptr() if n_dc else None),
          _stream(dev))
    param_grad_reduce.launches += 1
    return dws, dcoef


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
    per-chunk parameter gradients ``[dcoef, *dws]`` summed in chunk order."""
    return list(part) if total is None else [a + b for a, b in zip(total, part)]


class FusedConvChunkedVec(torch.autograd.Function):
    """Vec-mode conv of a large system with the chunked scatter backward
    (the port of ``_fused_conv_chunked_v``,
    ``sevennet_tpu/ops/fused_conv.py:1606-1691``). The row count must be a
    multiple of ``RC``.

    Forward: one B1 launch over all rows (the JAX chunk loop bounds an XLA
    gather of ``x[src]`` that B1 does inside the kernel; the function is
    the same). Backward, chunk by chunk: B2 (B2′ when a parameter needs a
    gradient, summed in chunk order), then ``dxg`` added into ``dx`` at
    the chunk's senders with ``index_add_``, and the chunk's ``dvec``
    columns copied out: no ``(N*K, dim_x)`` tensor exists at once. The
    MD engine falls back to it when the ring cannot be sized. First order
    only: a second backward raises, as the JAX path offers no
    grad-of-grad."""

    @staticmethod
    def forward(ctx, op, RC, x, vec, coef, src, *ws):
        ctx.op, ctx.RC = op, RC
        ctx.save_for_backward(x, vec, coef, src, *ws)
        return fused_conv_fwd(op, x, src, vec, coef, ws)

    @staticmethod
    @once_differentiable
    def backward(ctx, ybar):
        x, vec, coef, src, *ws = ctx.saved_tensors
        op, RC = ctx.op, ctx.RC
        need = ctx.needs_input_grad  # (op, RC, x, vec, coef, src, *ws)
        param_grads = bool(need[4] or any(need[6:]))
        ybar = ybar.contiguous()
        N, K = src.shape
        dx = torch.zeros_like(x)
        dvec = torch.empty_like(vec)
        pg = None
        for j in range(N // RC):
            src_c, vec_c, yb = _chunk(RC, K, j, src, vec, ybar)
            outs = fused_conv_bwd(op, x, src_c, vec_c, coef, ws, yb, param_grads=param_grads)
            if param_grads:
                pg = _summed(pg, [outs[3], *outs[2]])
            dx.index_add_(0, src_c.reshape(-1).long(), outs[0])
            dvec[:, j * RC * K:(j + 1) * RC * K] = outs[1]
        dcoef, *dws = pg or [None] * (1 + len(ws))
        return (None, None, dx, dvec, dcoef, None, *dws)


class FusedConvRingVec(torch.autograd.Function):
    """Vec-mode conv of a large, cell-sorted system with the rolling-buffer
    ring backward (the port of ``_fused_conv_ring_v`` and
    ``_fused_conv_ring_v_bwd``, ``sevennet_tpu/ops/fused_conv.py:1962-2157``).
    Contract (the MD engine sizes it and re-checks it at every rebuild;
    :func:`fused_conv_apply_vec` raises on a call that breaks it):
    ``N = nb * RC`` rows, ``nb >= 2W + 1``, and the mirror of every edge of
    chunk ``i`` lies in chunks ``i - W .. i + W``, circularly.

    Forward: one B1 launch over all rows. Backward: a buffer of ``S = 4W +
    1`` slots of ``RC*K`` rows keeps the window's ``dxg`` live. Chunks 0 ..
    2W-1 sit pinned in slots ``2W+1 .. 4W`` (the wrapped windows of the
    first and last W destinations need them at the end); the others cycle
    through slot ``c % (2W + 1)``. Iteration ``j`` runs B3 on chunk ``j``
    into its slot and, once ``j >= 2W``, emits destination ``j - W``,
    whose window is then computed: ``dx`` of its rows is the sum of the
    buffer rows of its mirrors, each gathered once. A gather-only epilogue
    emits the 2W wrapped destinations. With parameter gradients each chunk
    runs B2′ (summed in chunk order) and its ``dxg`` is copied into the
    slot. The JAX package's window-local gather of ``x``
    (``_windowed_xg``, ``:1937-1958``) speeds up an XLA row gather; the
    kernels here gather ``x[src]`` themselves and have no counterpart of
    it. First order only: a second backward raises, as the JAX ring path
    offers no grad-of-grad."""

    @staticmethod
    def forward(ctx, op, RC, W, x, vec, coef, src, mir, *ws):
        ctx.op, ctx.RC, ctx.W = op, RC, W
        ctx.save_for_backward(x, vec, coef, src, mir, *ws)
        return fused_conv_fwd(op, x, src, vec, coef, ws)

    @staticmethod
    @once_differentiable
    def backward(ctx, ybar):
        x, vec, coef, src, mir, *ws = ctx.saved_tensors
        op, RC, W = ctx.op, ctx.RC, ctx.W
        need = ctx.needs_input_grad  # (op, RC, W, x, vec, coef, src, mir, *ws)
        param_grads = bool(need[5] or any(need[8:]))
        ybar = ybar.contiguous()
        N, K = src.shape
        nb, rck = N // RC, RC * K
        slots = torch.tensor([ring_slot(c, W) for c in range(nb)], device=x.device)
        buf = torch.empty(((4 * W + 1) * rck, op.dim_x), dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        dvec = torch.empty_like(vec)

        def emit(i):
            m = mir[i * RC:(i + 1) * RC].reshape(-1)
            q = m // rck
            rows = slots[q] * rck + (m - q * rck)
            dx[i * RC:(i + 1) * RC] = buf[rows].view(RC, K, -1).sum(1)

        pg = None
        for j in range(nb):
            src_c, vec_c, yb = _chunk(RC, K, j, src, vec, ybar)
            s = ring_slot(j, W)
            if param_grads:
                dxg, dvec_c, dws_c, dcoef_c = fused_conv_bwd(op, x, src_c, vec_c, coef, ws, yb,
                                                             param_grads=True)
                buf[s * rck:(s + 1) * rck] = dxg
                pg = _summed(pg, [dcoef_c, *dws_c])
            else:
                dvec_c = fused_conv_bwd_slot(op, x, src_c, vec_c, coef, ws, yb, buf, s)
            dvec[:, j * rck:(j + 1) * rck] = dvec_c
            if j >= 2 * W:
                emit(j - W)
        for d in [*range(W), *range(nb - W, nb)]:
            emit(d)
        dcoef, *dws = pg or [None] * (1 + len(ws))
        return (None, None, None, dx, dvec, dcoef, None, None, *dws)


def _weights(mlp_params):
    return tuple(mlp_params["w"]) if isinstance(mlp_params, dict) else tuple(mlp_params)


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
    the backward chunk by chunk: with ``ring = W > 0`` the ring backward
    (:class:`FusedConvRingVec`; the rows must split into ``nb >= 2W + 1``
    chunks of ``RC``, and every edge's mirror must lie within W chunks of
    its row, as the MD engine's cell sort makes it: a call that breaks this
    raises), else the chunked
    scatter backward (:class:`FusedConvChunkedVec`), the rows padded to a
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
    src = src_nk if src_nk.dtype == torch.int32 else src_nk.to(torch.int32)
    args = (x.contiguous(), vec_rows.contiguous(), coef.contiguous(), src.contiguous())
    ws = [w.contiguous() for w in ws]
    n, K = src_nk.shape
    if not (row_chunk and row_chunk < n):
        return FusedConvVec.apply(op, *args, mir_nk.long(), *ws)
    RC = int(row_chunk)
    if ring:
        W = int(ring)
        if n % RC or n // RC < 2 * W + 1:
            raise ValueError(f"the ring backward needs row_chunk ({RC}) to divide the row count "
                             f"({n}) into >= 2W+1 = {2 * W + 1} chunks")
        mir = mir_nk.long()
        # the ring's contract, checked on every call (one host read): a
        # mirror farther than W chunks from its row would be read from a
        # slot that already holds another chunk. Unmatched and padded slots
        # are their own mirrors.
        nb = n // RC
        rows = torch.arange(n, device=mir.device)[:, None] // RC
        d = torch.remainder(mir // K // RC - rows, nb)
        if bool(((d > W) & (d < nb - W)).any()):
            raise ValueError(f"the ring backward needs every edge's mirror within W = {W} chunks "
                             f"of {RC} rows of its own row: sort the atoms by cell (MDEngine "
                             "does), or run with conv_ring 0 (the chunked scatter backward)")
        return FusedConvRingVec.apply(op, RC, W, *args, mir, *ws)
    pad = -n % RC
    if pad:
        # padded rows: zero features, sentinel vectors past the cutoff
        # (sevennet_tpu/ops/fused_conv.py:2267-2289); their senders (atom 0)
        # get exact zeros
        x_p, vec_p, coef_c, src_p = args
        sentinel = torch.zeros((3, pad * K), dtype=vec_p.dtype, device=vec_p.device)
        sentinel[0] = 2.0 * embed.cutoff
        args = (torch.cat([x_p, x_p.new_zeros((pad, x_p.shape[1]))]),
                torch.cat([vec_p, sentinel], 1), coef_c,
                torch.cat([src_p, src_p.new_zeros((pad, K))]))
    return FusedConvChunkedVec.apply(op, RC, *args, *ws)[:n]


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
) -> torch.Tensor:
    """The emb/sh-mode fused conv as the model calls it: ``(N, dim_mid)``
    (the port of ``sevennet_tpu/ops/fused_conv.py:fused_conv_apply``
    without its chunked and ring paths, ``:1704-1781`` and ``:1803-1918``,
    which are still to port: the model refuses to chunk in emb/sh mode).
    Gradients reach ``x``, ``emb``, ``sh`` and the MLP weights.

    ``plain=True`` runs :func:`fused_conv_fwd_embsh_plain` under ordinary
    autograd instead of the kernels, on any device."""
    op = conv_op(conv, mlp_spec, None)
    ws = _weights(mlp_params)
    N, K = src_nk.shape
    emb, sh = emb_nk.reshape(N * K, -1), sh_nk.reshape(N * K, -1)
    if plain:
        return fused_conv_fwd_embsh_plain(op, x, src_nk, emb, sh, ws)
    src = src_nk if src_nk.dtype == torch.int32 else src_nk.to(torch.int32)
    return FusedConvEmbSh.apply(
        op, x.contiguous(), emb.contiguous(), sh.contiguous(), src.contiguous(),
        mir_nk.long(), *[w.contiguous() for w in ws],
    )
