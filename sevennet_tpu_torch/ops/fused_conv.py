"""Fused convolution of the dense ``(N, K)`` layout, vec mode: radial
embedding, radial MLP, uvu tensor product and the sum over each receiver's
neighbour slots, forward and backward (PyTorch port of the vec-mode path of
``sevennet_tpu/ops/fused_conv.py``).

Two hand-written CUDA kernels carry it on the card (``csrc/``):

- ``fused_conv_fwd``: replaces the Pallas kernel ``make_fused_conv_fwd``
  with ``embed`` set;
- ``fused_conv_bwd``: replaces ``make_fused_conv_bwd2`` with ``embed`` set,
  ``param_grads=False``.

Each has a plain PyTorch twin with the same contract
(:func:`fused_conv_fwd_plain`, :func:`fused_conv_bwd_plain`). The wrappers
:func:`fused_conv_fwd` / :func:`fused_conv_bwd` take the plain version only
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
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch

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


def _csr(keys: np.ndarray, n_rows: int, cols: np.ndarray):
    """Rows of ``cols`` grouped by ``keys`` (stable): (row_ptr, int4 terms)."""
    order = np.argsort(keys, kind="stable")
    ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n_rows), out=ptr[1:])
    terms = np.zeros((len(keys), 4), np.int64)
    terms[:, : cols.shape[1]] = cols[order]
    return ptr, terms


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


def fused_conv_bwd_plain(op: FusedConvOp, x, src, vec, coef, ws, ybar):
    """Plain twin of the backward kernel: the pullback of
    :func:`fused_conv_fwd_plain` at ``ybar (N, dim_mid)``, returning the
    per-edge x-cotangents ``dxg (N*K, dim_x)`` and ``dvec (3, N*K)``."""
    N, K = src.shape
    with torch.enable_grad():
        xg = x[src.reshape(-1).long()].detach().requires_grad_(True)
        v = vec.detach().requires_grad_(True)
        ws = [w.detach() for w in ws]
        out = _fwd_plain_from_xg(op, xg, v, coef.detach(), ws, N, K)
        dxg, dvec = torch.autograd.grad(out, (xg, v), ybar)
    return dxg, dvec


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


def _library(name: str, argc: int):
    from .kernels import library

    lib = library(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [_ConvDims] + [_P] * argc
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


def fused_conv_bwd(op: FusedConvOp, x, src, vec, coef, ws, ybar):
    """Backward conv without parameter gradients: ``(dxg, dvec)``. CPU
    tensors: the plain version. CUDA tensors: the ``fused_conv_bwd`` kernel
    (``csrc/fused_conv_bwd.cu``)."""
    _check(op, x, src, vec, coef, ws, ybar)
    if x.device.type == "cpu":
        return fused_conv_bwd_plain(op, x, src, vec, coef, ws, ybar)
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


def mirror_gather(dxg: torch.Tensor, mir: torch.Tensor) -> torch.Tensor:
    """``dx[n] = sum_k dxg[mir[n, k]]``: the edges sending from atom n are
    exactly the mirrors of row n's edges, so the scatter of the x-cotangents
    becomes a gather (padded slots point at themselves and carry zeros)."""
    N, K = mir.shape
    return dxg[mir.reshape(-1)].view(N, K, -1).sum(1)


class FusedConvVec(torch.autograd.Function):
    """Vec-mode fused conv with the mirror-gather backward. Differentiable in
    ``x`` and ``vec``; the MLP weights and Bessel coefficients get no
    gradient (``param_grads=False``, the serving path)."""

    @staticmethod
    def forward(ctx, op, x, vec, coef, src, mir, *ws):
        ctx.op = op
        ctx.save_for_backward(x, vec, coef, src, mir, *ws)
        return fused_conv_fwd(op, x, src, vec, coef, ws)

    @staticmethod
    def backward(ctx, ybar):
        x, vec, coef, src, mir, *ws = ctx.saved_tensors
        dxg, dvec = fused_conv_bwd(ctx.op, x, src, vec, coef, ws, ybar.contiguous())
        return (None, mirror_gather(dxg, mir), dvec, None, None, None) + (None,) * len(ws)


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
