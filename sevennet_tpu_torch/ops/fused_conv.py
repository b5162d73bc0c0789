"""Fused convolution of the dense ``(N, K)`` layout, vec mode: radial
embedding, radial MLP, uvu tensor product and the sum over each receiver's
neighbour slots, forward and backward (PyTorch port of the vec-mode path of
``sevennet_tpu/ops/fused_conv.py``).

Hand-written CUDA kernels carry it on the card (``csrc/``):

- ``fused_conv_fwd`` (B1): replaces the Pallas kernel
  ``make_fused_conv_fwd`` with ``embed`` set;
- ``fused_conv_bwd`` (B2): replaces ``make_fused_conv_bwd2`` with ``embed``
  set, ``param_grads=False``;
- ``fused_conv_bwd_pg`` and ``param_grad_reduce`` (B2′): the same with
  ``param_grads=True``, in two passes (per-edge records, then a reduction
  over all edges in a fixed order); :func:`fused_conv_bwd` with
  ``param_grads=True`` runs both.

Each has a plain PyTorch twin with the same contract
(:func:`fused_conv_fwd_plain`, :func:`fused_conv_bwd_plain`,
:func:`param_grad_reduce_plain`). The wrappers take the plain version only
for tensors on the CPU; for CUDA tensors they launch the kernel or raise.
Each wrapper counts its launches in ``.launches``.

Layouts follow the JAX package: features ``ir_mul``, conv output in the
grouped mid layout (:func:`~sevennet_tpu_torch.ops.dense_conv.mid_layout`),
edge vectors ``(3, N*K)`` receiver-major, padded slots carrying a sentinel
vector past the cutoff. The backward's ``dx`` is the mirror gather of the
per-edge x-cotangents plus a sum over K, in plain PyTorch, as the JAX
package leaves it to XLA (``sevennet_tpu/ops/fused_conv.py:1584-1590``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

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
    "mirror_map_numpy",
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
            "f_ptr", "f_terms", "dx_ptr", "dx_terms", "dw_ptr", "dw_terms",
            "dt_ptr", "dt_terms", "sh_terms", "n_sh", "shd_terms", "n_shd",
            "w3j", "sh_coef", "shd_coef",
        )
    ]


_WS_FIELDS = ("stride", "emb", "h1", "h2", "dz1", "dz2", "dw", "dc")


class _WsLayout(ctypes.Structure):
    """ctypes mirror of ``struct WsLayout`` (csrc/fused_conv_bwd.cu)."""

    _fields_ = [(n, ctypes.c_int) for n in _WS_FIELDS]


def _csr(keys: np.ndarray, n_rows: int, cols: np.ndarray):
    """Rows of ``cols`` grouped by ``keys`` (stable): (row_ptr, int4 terms)."""
    order = np.argsort(keys, kind="stable")
    ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n_rows), out=ptr[1:])
    terms = np.zeros((len(keys), 4), np.int64)
    terms[:, : cols.shape[1]] = cols[order]
    return ptr, terms


def _workspace_layout(dims) -> Dict[str, int]:
    """Columns of the per-edge record that kernel B2′ writes for the
    parameter gradients (``csrc/fused_conv_bwd.cu``): the MLP's input and
    hidden activations ``emb, h1, h2``, their cotangents ``dz1, dz2, dw``
    and the per-edge ``dcoef`` terms, in this order; the row ``stride`` is
    rounded up to 4 floats. Zeros for an MLP the kernels do not take."""
    if len(dims) != 4:
        return dict.fromkeys(_WS_FIELDS, 0)
    nb, h1, h2, numel = dims
    out, col = {}, 0
    for name, width in zip(_WS_FIELDS[1:], (nb, h1, h2, h1, h2, numel, nb)):
        out[name] = col
        col += width
    out["stride"] = -(-col // 4) * 4
    return out


class FusedConvOp:
    """Static tables of one conv layer: the instruction tables of the JAX
    kernels, and the elementary uvu terms ``(c, xc, wc, r)`` (output column
    ``c`` gets ``x[xc] * w[wc] * tmp[r]``) sorted four ways for the CUDA
    kernels. Device copies are cached per device."""

    def __init__(self, conv: ConvTPSpec, mlp_spec: ScalarMLPSpec, embed: EdgeEmbedSpec):
        instr, w3j_pack, dim_mid, numel = _instr_tables(conv)
        assert numel == mlp_spec.dims[-1], (numel, mlp_spec.dims)
        assert embed.dim_f == conv.irreps_filter.dim
        assert embed.n_basis == mlp_spec.dims[0]
        assert mlp_spec.act == "silu", "the fused conv's radial MLP is silu"
        assert embed.lmax <= 3
        self.conv, self.mlp_spec, self.embed = conv, mlp_spec, embed
        self.dim_x = conv.irreps_x.dim
        self.dim_mid, self.numel, self.R = dim_mid, numel, w3j_pack.shape[0]
        self.w3j_pack = w3j_pack

        terms = []
        for ins in instr:
            mul, x0, w0 = ins["mul"], ins["x_start"], ins["w_start"]
            g0, u_off, u_tot = ins["g_start"], ins["u_off"], ins["u_tot"]
            u = np.arange(mul)
            for m, p, r in ins["mp"]:
                terms.append(np.stack([
                    g0 + p * u_tot + u_off + u, x0 + m * mul + u, w0 + u,
                    np.full(mul, r),
                ], 1))
        t = np.concatenate(terms, 0).astype(np.int64)
        self.n_terms = len(t)
        c, xc, wc, r = t.T
        f_ptr, f_terms = _csr(c, dim_mid, t[:, [1, 2, 3]])
        dx_ptr, dx_terms = _csr(xc, self.dim_x, t[:, [0, 2, 3]])
        dw_ptr, dw_terms = _csr(wc, numel, t[:, [0, 1, 3]])
        dt_ptr, dt_terms = _csr(r, self.R, t[:, [0, 1, 2]])

        # spherical harmonics and their u-derivatives as monomial terms
        sh_t, sh_c, shd_t, shd_comp, shd_c = [], [], [], [], []
        for l in range(embed.lmax + 1):
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

        ints: List[np.ndarray] = []
        offs: Dict[str, int] = {}

        def put(name, arr):
            offs[name] = sum(a.size for a in ints)
            ints.append(np.asarray(arr, np.int64).reshape(-1))

        for name, arr in (
            ("f_ptr", f_ptr), ("f_terms", f_terms), ("dx_ptr", dx_ptr),
            ("dx_terms", dx_terms), ("dw_ptr", dw_ptr), ("dw_terms", dw_terms),
            ("dt_ptr", dt_ptr), ("dt_terms", dt_terms),
            ("sh_terms", np.asarray(sh_t).reshape(-1, 4)),
        ):
            # int4 arrays start on a 16-byte boundary
            pad = (-sum(a.size for a in ints)) % 4
            if pad:
                ints.append(np.zeros(pad, np.int64))
            put(name, arr)
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
        self.ws_layout = _workspace_layout(mlp_spec.dims)
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
        return _ConvDims(
            N=N, K=K, dim_x=self.dim_x, dim_mid=self.dim_mid, numel=self.numel,
            R=self.R, dim_f=e.dim_f, n_basis=e.n_basis, h1=d[1], h2=d[2],
            lmax=e.lmax, cutoff_kind=0 if e.cutoff_kind == "poly_cut" else 1,
            cutoff=e.cutoff, cutoff_arg=e.cutoff_arg,
            act_cst=NORMALIZE2MOM_CST["silu"], **self._offs,
        )


@lru_cache(maxsize=None)
def conv_op(conv: ConvTPSpec, mlp_spec: ScalarMLPSpec, embed: EdgeEmbedSpec) -> FusedConvOp:
    return FusedConvOp(conv, mlp_spec, embed)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference of the kernels)
# ---------------------------------------------------------------------------


def edge_embedding_plain(op: FusedConvOp, vec: torch.Tensor, coef: torch.Tensor):
    """(3, E) edge vectors -> ``emb (E, n_basis)``, ``sh (E, dim_f)``."""
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


def _fwd_plain_from_xg(op, xg, vec, coef, ws, N, K):
    emb, sh = edge_embedding_plain(op, vec, coef)
    w = scalar_mlp_apply(op.mlp_spec, {"w": list(ws)}, emb)
    msg = conv_tp_apply(op.conv, xg, sh, w)
    return msg.view(N, K, -1).sum(1)


def fused_conv_fwd_plain(op: FusedConvOp, x, src, vec, coef, ws):
    """Plain twin of the forward kernel: ``x (N, dim_x)``, ``src (N, K)``,
    ``vec (3, N*K)``, ``coef (n_basis,)``, MLP weights -> ``(N, dim_mid)``."""
    N, K = src.shape
    return _fwd_plain_from_xg(op, x[src.reshape(-1).long()], vec, coef, ws, N, K)


def fused_conv_bwd_plain(op: FusedConvOp, x, src, vec, coef, ws, ybar, param_grads=False):
    """Plain twin of the backward kernels: the pullback of
    :func:`fused_conv_fwd_plain` at ``ybar (N, dim_mid)``, returning the
    per-edge x-cotangents ``dxg (N*K, dim_x)`` and ``dvec (3, N*K)`` (B2);
    with ``param_grads`` also the MLP-weight gradients ``dws`` and
    ``dcoef (n_basis,)`` (B2′): ``(dxg, dvec, dws, dcoef)``."""
    N, K = src.shape
    with torch.enable_grad():
        xg = x[src.reshape(-1).long()].detach().requires_grad_(True)
        v = vec.detach().requires_grad_(True)
        c = coef.detach().requires_grad_(param_grads)
        wl = [w.detach().requires_grad_(param_grads) for w in ws]
        out = _fwd_plain_from_xg(op, xg, v, c, wl, N, K)
        inputs = (xg, v, c, *wl) if param_grads else (xg, v)
        grads = torch.autograd.grad(out, inputs, ybar)
    if not param_grads:
        return grads
    dxg, dvec, dcoef, *dws = grads
    return dxg, dvec, dws, dcoef


def param_grad_reduce_plain(op: FusedConvOp, work, valid):
    """Plain twin of the reduction kernel of B2′: from the per-edge records
    ``work (N*K, stride)`` (rows with ``valid == 0`` are ignored, whatever
    they hold) the sums over edges ``dW_l = h_lᵀ g_l / sqrt(d_l)`` and
    ``dcoef``: ``(dws, dcoef)``."""
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
    return dws, take("dc", nb).sum(0)


def fused_conv_bwd_vjp_plain(op: FusedConvOp, x, src, vec, coef, ws, ybar, cots):
    """The conv's second-order rule, plain PyTorch on any device: the VJP of
    the pullback ``(dxg, dvec[, dcoef, *dws]) = bwd(x, vec, coef, ybar, ws)``
    at the cotangents ``cots`` (one per output), with respect to
    ``(x, vec, coef, ybar, *ws)``; ``None`` where an input gets nothing.
    An output whose cotangent is ``None`` is not formed: a force loss sends
    none to the parameter gradients of the force pass."""
    N, K = src.shape
    prims = (x, vec, coef, ybar, *ws)
    if all(c is None for c in cots):
        return (None,) * len(prims)
    with torch.enable_grad():
        prims = [t.detach().requires_grad_(True) for t in prims]
        xd, vd, cd, yd, *wd = prims
        xg = xd[src.reshape(-1).long()]
        out = _fwd_plain_from_xg(op, xg, vd, cd, wd, N, K)
        wrt, cots = zip(*[(t, c) for t, c in zip((xg, vd, cd, *wd), cots) if c is not None])
        pullback = torch.autograd.grad(out, wrt, yd, create_graph=True)
        return torch.autograd.grad(pullback, prims, cots, allow_unused=True)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(op: FusedConvOp, x, src, vec, coef, ws, ybar=None):
    dev = x.device
    N, K = src.shape
    shapes = [
        ("x", x, (N, op.dim_x), torch.float32),
        ("src", src, (N, K), torch.int32),
        ("vec", vec, (3, N * K), torch.float32),
        ("coef", coef, (op.embed.n_basis,), torch.float32),
    ] + [
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


def _library(name: str, argc: int):
    """Entry ``{name}_launch`` of library ``name``, taking a ``ConvDims``
    and ``argc`` pointers."""
    return _entry(name, f"{name}_launch", [_ConvDims] + [_P] * argc)


def _entry(name: str, fn_name: str, argtypes):
    from .kernels import library

    fn = getattr(library(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor):
    return _P(t.data_ptr())


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def fused_conv_fwd(op: FusedConvOp, x, src, vec, coef, ws):
    """Forward conv. CPU tensors: the plain version. CUDA tensors: the
    ``fused_conv_fwd`` kernel (``csrc/fused_conv_fwd.cu``)."""
    _check(op, x, src, vec, coef, ws)
    if x.device.type == "cpu":
        return fused_conv_fwd_plain(op, x, src, vec, coef, ws)
    N, K = src.shape
    out = torch.empty((N, op.dim_mid), dtype=torch.float32, device=x.device)
    itab, ftab = op.device_tables(x.device)
    fn = _library("fused_conv_fwd", 11)
    rc = fn(op.dims(N, K), _ptr(x), _ptr(src), _ptr(vec), _ptr(coef),
            *[_ptr(w) for w in ws], _ptr(itab), _ptr(ftab), _ptr(out),
            _P(torch.cuda.current_stream(x.device).cuda_stream))
    _raise_on(rc, "fused_conv_fwd")
    fused_conv_fwd.launches += 1
    return out


fused_conv_fwd.launches = 0


def fused_conv_bwd(op: FusedConvOp, x, src, vec, coef, ws, ybar, param_grads=False):
    """Backward conv: ``(dxg, dvec)`` (B2), and with ``param_grads``
    ``(dxg, dvec, [dW1, dW2, dW3], dcoef)`` (B2′). CPU tensors: the plain
    version. CUDA tensors: the ``fused_conv_bwd`` kernel
    (``csrc/fused_conv_bwd.cu``); with ``param_grads``, its records pass
    :func:`fused_conv_bwd_pg_records` and then :func:`param_grad_reduce`."""
    _check(op, x, src, vec, coef, ws, ybar)
    if x.device.type == "cpu":
        return fused_conv_bwd_plain(op, x, src, vec, coef, ws, ybar, param_grads=param_grads)
    if param_grads:
        dxg, dvec, work, valid = fused_conv_bwd_pg_records(op, x, src, vec, coef, ws, ybar)
        dws, dcoef = param_grad_reduce(op, work, valid, *src.shape)
        return dxg, dvec, dws, dcoef
    N, K = src.shape
    dxg = torch.empty((N * K, op.dim_x), dtype=torch.float32, device=x.device)
    dvec = torch.empty((3, N * K), dtype=torch.float32, device=x.device)
    itab, ftab = op.device_tables(x.device)
    fn = _library("fused_conv_bwd", 13)
    rc = fn(op.dims(N, K), _ptr(x), _ptr(src), _ptr(vec), _ptr(coef),
            *[_ptr(w) for w in ws], _ptr(ybar), _ptr(itab), _ptr(ftab),
            _ptr(dxg), _ptr(dvec),
            _P(torch.cuda.current_stream(x.device).cuda_stream))
    _raise_on(rc, "fused_conv_bwd")
    fused_conv_bwd.launches += 1
    return dxg, dvec


fused_conv_bwd.launches = 0


def fused_conv_bwd_pg_records(op: FusedConvOp, x, src, vec, coef, ws, ybar):
    """First pass of B2′ on the card, the ``fused_conv_bwd_pg`` kernel:
    ``(dxg, dvec, work, valid)``, with ``work (N*K, stride)`` the
    per-edge records (:func:`_workspace_layout`) and ``valid (N*K,)`` the
    slots inside the cutoff."""
    _check(op, x, src, vec, coef, ws, ybar)
    if x.device.type != "cuda":
        raise ValueError(f"the records of B2′ are made on the card, not on {x.device}")
    N, K = src.shape
    dev = x.device
    dxg = torch.empty((N * K, op.dim_x), dtype=torch.float32, device=dev)
    dvec = torch.empty((3, N * K), dtype=torch.float32, device=dev)
    work = torch.empty((N * K, op.ws_layout["stride"]), dtype=torch.float32, device=dev)
    valid = torch.empty(N * K, dtype=torch.uint8, device=dev)
    itab, ftab = op.device_tables(dev)
    fn = _entry("fused_conv_bwd", "fused_conv_bwd_pg_launch", [_ConvDims, _WsLayout] + [_P] * 15)
    rc = fn(op.dims(N, K), _WsLayout(**op.ws_layout), _ptr(x), _ptr(src), _ptr(vec), _ptr(coef),
            *[_ptr(w) for w in ws], _ptr(ybar), _ptr(itab), _ptr(ftab),
            _ptr(dxg), _ptr(dvec), _ptr(work), _ptr(valid),
            _P(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, "fused_conv_bwd_pg")
    fused_conv_bwd_pg_records.launches += 1
    return dxg, dvec, work, valid


fused_conv_bwd_pg_records.launches = 0


def param_grad_reduce(op: FusedConvOp, work, valid, N: int, K: int):
    """Second pass of B2′: ``(dws, dcoef)`` summed over the valid rows of
    the workspace. CPU tensors: the plain version. CUDA tensors: the
    ``param_grad_reduce`` kernels (``csrc/fused_conv_bwd.cu``), whose sums
    run in a fixed order (chunks of ``REDUCE_CHUNK`` rows, then the chunks
    in turn): the result does not depend on the launch."""
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
    n_chunks = -(-N * K // REDUCE_CHUNK)
    partial = torch.empty(n_chunks * (nb * h1 + h1 * h2 + h2 * numel + nb),
                          dtype=torch.float32, device=dev)
    dws = [torch.empty((a, b), dtype=torch.float32, device=dev)
           for a, b in ((nb, h1), (h1, h2), (h2, numel))]
    dcoef = torch.empty(nb, dtype=torch.float32, device=dev)
    fn = _entry("fused_conv_bwd", "param_grad_reduce_launch",
                [_ConvDims, _WsLayout, _P, _P, ctypes.c_int] + [_P] * 6)
    rc = fn(op.dims(N, K), _WsLayout(**op.ws_layout), _ptr(work), _ptr(valid), REDUCE_CHUNK,
            _ptr(partial),
            *[_ptr(w) for w in dws], _ptr(dcoef),
            _P(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, "param_grad_reduce")
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
) -> torch.Tensor:
    """The vec-mode fused conv as the model calls it: ``(N, dim_mid)``.

    ``plain=True`` runs :func:`fused_conv_fwd_plain` under ordinary autograd
    instead of the kernels, on any device: the reference the kernels are
    held against."""
    op = conv_op(conv, mlp_spec, embed)
    ws = tuple(mlp_params["w"]) if isinstance(mlp_params, dict) else tuple(mlp_params)
    coef = bessel_coef.reshape(-1)
    if plain:
        return fused_conv_fwd_plain(op, x, src_nk, vec_rows, coef, ws)
    src = src_nk if src_nk.dtype == torch.int32 else src_nk.to(torch.int32)
    return FusedConvVec.apply(
        op, x.contiguous(), vec_rows.contiguous(), coef.contiguous(),
        src.contiguous(), mir_nk.long(), *[w.contiguous() for w in ws],
    )
