"""The fused-conv breakdown and knock-out probes' plain versions
(``sevennet_tpu_torch/probes/breakdown.py``, ``probes/knockout.py``) against
the TPU probe kernels they port, and their wrappers' checks.

The TPU kernels live in scripts that build a 566 MB (``r2_fused_breakdown.py``)
or 1.4 GB (``r3_fwd_knockout.py``) input and time the kernels on a TPU when
imported, so their kernel bodies and calls are quoted here, each with its
file and lines (the globals of the scripts made parameters; the
``vmem_limit_bytes`` of the TPU runs left out), and run through
``pl.pallas_call(..., interpret=True)`` on the CPU: SevenNet-0's layer
shrunk to ``8x0e+4x1e+2x2e`` against lmax-2 harmonics (dim_mid 196, so the
scripts' 128-lane pads still fit), radial MLP ``(8, 16, 16, numel)``, K 12
(its halving chain takes the even steps 12 -> 6 -> 3 and the odd one 3 ->
2). Every variant runs at A = 1 receiver a grid step, 3 blocks; the
variants that compute their function at any A also at A = 2, 2 blocks, on
the script's own row order (a-major rows; k-major ones through the
script's ``kmaj`` for the chains and the k-major 0/1 matrix). The same
inputs, made with numpy from a seed, go through both. Limits: 1e-5 of the
largest reference value (float32 on both sides, the CPU's dots at any
precision are fp32, sums in another order); ``feat_transpose`` bitwise;
storek's columns that no window covers are NaN in interpret mode (Pallas
leaves them unwritten) and 0 in the port. The CUDA kernels are held
against these plain versions on the card (tests/test_torch_kernels.py,
chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sevennet_tpu.irreps import Irreps as JIrreps
from sevennet_tpu.irreps import infer_irreps_out as j_infer
from sevennet_tpu.ops.activations import NORMALIZE2MOM_CST as J_CST
from sevennet_tpu.ops.fused_conv import _DOT
from sevennet_tpu.ops.fused_conv import _instr_tables as j_instr_tables
from sevennet_tpu.ops.tensor_product import ConvTPSpec as JConvTPSpec
from sevennet_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_tpu_torch.ops import fused_conv as fc
from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec
from sevennet_tpu_torch.probes import breakdown as bd
from sevennet_tpu_torch.probes import knockout as ko

torch.set_num_threads(1)
PREC = jax.lax.Precision.HIGHEST
TOL = 1e-5
K = 12


class Layer:
    """The scripts' module-level tables (``r2_fused_breakdown.py:22-35``,
    ``r3_fwd_knockout.py:24-38``) for the small layer."""

    def __init__(self):
        j_x, j_f = JIrreps("8x0e+4x1e+2x2e"), JIrreps.spherical_harmonics(2, 1)
        self.jconv = JConvTPSpec(j_x, j_f, j_infer(j_x, j_f, 2, "full"))
        p_x, p_f = Irreps("8x0e+4x1e+2x2e"), Irreps.spherical_harmonics(2, 1)
        self.conv = ConvTPSpec(p_x, p_f, infer_irreps_out(p_x, p_f, 2, "full"))
        self.dims = (8, 16, 16, self.conv.weight_numel)
        self.instr, self.w3j_pack_np, self.dim_mid, self.numel = j_instr_tables(self.jconv)
        self.dim_x, self.dim_f, self.n_basis = j_x.dim, j_f.dim, 8
        self.R = self.w3j_pack_np.shape[0]
        self.cst = J_CST["silu"]
        self.inv_sqrt = [1.0 / math.sqrt(d) for d in self.dims[:-1]]
        self.n_mlp = len(self.dims) - 1
        self.op = fc.conv_op(self.conv, ScalarMLPSpec(self.dims))


LAYER = Layer()


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    nk = n * K

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    xg = f32(nk, LAYER.dim_x, scale=0.5)
    emb, sh = f32(nk, 8, scale=0.3), f32(nk, 9, scale=0.5)
    ws = [f32(a, b) for a, b in zip(LAYER.dims[:-1], LAYER.dims[1:])]
    return xg, emb, sh, ws


def kmaj(arr, A_):
    """``r2_fused_breakdown.py:355-360``: (N, K, ...) -> flat k-major rows
    (b K A + k A + a)."""
    NN, KK = arr.shape[0], arr.shape[1]
    tail = arr.shape[2:]
    return (arr.reshape(NN // A_, A_, KK, *tail).swapaxes(1, 2)
            .reshape(NN * KK, *tail))


def script_rows(arrs, order, A):
    """Receiver-major rows (i K + k) in the script's order: a-major rows are
    the same; k-major through ``kmaj``."""
    if order == "a":
        return arrs
    return [kmaj(a.reshape(-1, K, a.shape[1]), A) for a in arrs]


def pallas_build(L, variant, precision, A):
    """``scripts_dev/r2_fused_breakdown.py:59-178`` (``build``'s kernel and
    call), with the ONES matrices of ``:51-56``."""
    T = A * K
    instr, dim_mid, R = L.instr, L.dim_mid, L.R
    n_mlp, inv_sqrt, cst = L.n_mlp, L.inv_sqrt, L.cst
    dim_x, dim_f, n_basis = L.dim_x, L.dim_f, L.n_basis
    ONES_BD = np.zeros((T, A), np.float32)
    for t in range(T):
        ONES_BD[t, t % A] = 1.0  # k-major: lane t = k*A + a
    ONES_BD_AMAJ = np.zeros((T, A), np.float32)
    for t in range(T):
        ONES_BD_AMAJ[t, t // K] = 1.0  # a-major: t = a*K + k

    def kernel(xg_ref, emb_ref, sh_ref, ones_ref, *rest):
        mlp_refs = rest[:n_mlp]
        w3j_ref = rest[n_mlp]
        out_ref = rest[n_mlp + 1]
        kw = dict(preferred_element_type=jnp.float32)
        if precision is not None:
            kw["precision"] = precision

        h = emb_ref[:]
        for li, wref in enumerate(mlp_refs):
            h = jnp.dot(h, wref[:], **kw) * inv_sqrt[li]
            if li < n_mlp - 1:
                h = jax.nn.silu(h) * cst
        if variant == "mlp":
            out_ref[:] = jnp.pad(h[:A], ((0, 0), (0, dim_mid - h.shape[1])))
            return
        tmp = jnp.dot(sh_ref[:], w3j_ref[:].T, **kw)
        if variant == "tmp":
            out_ref[:] = jnp.pad(tmp[:A], ((0, 0), (0, dim_mid - R)))
            return
        def mmred(acc):
            return jax.lax.dot_general(
                ones_ref[:], acc, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)

        def kred(acc):
            rows = acc.shape[0]
            while rows > A:
                if (rows // A) % 2 == 0:
                    half = rows // 2
                    acc = acc[:half, :] + acc[half:, :]
                    rows = half
                else:
                    acc = jnp.concatenate(
                        [acc[:A, :] + acc[rows - A:, :], acc[A:rows - A, :]], 0)
                    rows -= A
            return acc

        xg = xg_ref[:]
        if variant == "tp":
            total = jnp.zeros((T, 128), jnp.float32)
        elif variant in ("tpred", "tpredk", "tpredmm", "tpredmm_amaj"):
            total = jnp.zeros((A, 128), jnp.float32)
        for ins in instr:
            d1, d3, mul = ins["d1"], ins["d3"], ins["mul"]
            x0, w0 = ins["x_start"], ins["w_start"]
            wb = h[:, w0:w0 + mul]
            xw = [xg[:, x0 + m*mul : x0 + (m+1)*mul] * wb for m in range(d1)]
            by_p = {}
            for m, p, r in ins["mp"]:
                term = xw[m] * tmp[:, r:r + 1]
                by_p[p] = term if p not in by_p else by_p[p] + term
            if variant == "tp":
                for p, acc in by_p.items():
                    total = total + jnp.pad(acc, ((0, 0), (0, 128 - mul)))
                continue
            if variant == "tpred":
                for p, acc in by_p.items():
                    red = acc.reshape(A, K, mul).sum(axis=1)
                    total = total + jnp.pad(red, ((0, 0), (0, 128 - mul)))
                continue
            if variant == "tpredk":
                for p, acc in by_p.items():
                    red = kred(acc)
                    total = total + jnp.pad(red, ((0, 0), (0, 128 - mul)))
                continue
            if variant in ("tpredmm", "tpredmm_amaj"):
                for p, acc in by_p.items():
                    red = mmred(acc)
                    total = total + jnp.pad(red, ((0, 0), (0, 128 - mul)))
                continue
            if variant == "storek":
                for p, acc in by_p.items():
                    # aligned 128-wide store at an aligned offset
                    red = kred(acc)
                    col = (ins["g_start"] // 128) * 128 % (dim_mid - 128)
                    out_ref[:, col:col + 128] = jnp.pad(
                        red, ((0, 0), (0, 128 - mul)))
                continue
            g0, u_off, u_tot = ins["g_start"], ins["u_off"], ins["u_tot"]
            for p in range(d3):
                start = g0 + p*u_tot + u_off
                if p in by_p:
                    if variant == "fullk":
                        red = kred(by_p[p])
                    elif variant == "fullmm":
                        red = mmred(by_p[p])
                    else:
                        red = by_p[p].reshape(A, K, mul).sum(axis=1)
                    out_ref[:, start:start+mul] = red
                else:
                    out_ref[:, start:start+mul] = jnp.zeros((A, mul), jnp.float32)
        if variant == "tp":
            out_ref[:] = jnp.pad(total[:A], ((0, 0), (0, dim_mid - 128)))
        elif variant in ("tpred", "tpredk", "tpredmm", "tpredmm_amaj"):
            out_ref[:] = jnp.pad(total, ((0, 0), (0, dim_mid - 128)))

    ones = ONES_BD_AMAJ if variant.endswith("_amaj") else ONES_BD

    def fused(xg, emb, sh, mlp_ws, w3j_pack_np):
        n_blocks = xg.shape[0] // T
        in_specs = [
            pl.BlockSpec((T, dim_x), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T, n_basis), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T, dim_f), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T, A), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ] + [pl.BlockSpec(w.shape, lambda i: (0, 0), memory_space=pltpu.VMEM)
             for w in mlp_ws] + [
            pl.BlockSpec((R, dim_f), lambda i: (0, 0), memory_space=pltpu.VMEM)]
        return pl.pallas_call(
            kernel, grid=(n_blocks,), in_specs=in_specs,
            out_specs=pl.BlockSpec((A, dim_mid), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((n_blocks*A, dim_mid), jnp.float32),
            interpret=True,
        )(xg, emb, sh, jnp.asarray(ones), *mlp_ws, jnp.asarray(w3j_pack_np))
    return fused


def pallas_build_feat(L, variant, A_):
    """``scripts_dev/r2_fused_breakdown.py:201-270`` (``build_feat``'s kernel
    and call)."""
    T_ = A_ * K
    instr, dim_mid, R = L.instr, L.dim_mid, L.R
    n_mlp, inv_sqrt, cst = L.n_mlp, L.inv_sqrt, L.cst
    dim_x, dim_f, n_basis = L.dim_x, L.dim_f, L.n_basis
    O_np = np.zeros((T_, A_), np.float32)
    for t in range(T_):
        O_np[t, t // K] = 1.0  # a-major

    def kernel(xg_ref, emb_ref, sh_ref, ones_ref, *rest):
        mlp_refs = rest[:n_mlp]
        w3j_ref = rest[n_mlp]
        out_ref = rest[n_mlp + 1]
        kw = dict(preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
        xgT = xg_ref[:].T          # (480, T)
        embT = emb_ref[:].T        # (8, T)
        shT = sh_ref[:].T          # (9, T)
        if variant == "transpose":
            out_ref[:] = jnp.pad(
                xgT[:, :dim_mid].T[:A_] if T_ >= dim_mid else
                jnp.pad(xgT.T[:A_], ((0,0),(0,dim_mid-dim_x))),
                ((0,0),(0,0)))
            return
        h = embT
        for li, wref in enumerate(mlp_refs):
            h = jnp.dot(wref[:].T, h, **kw) * inv_sqrt[li]
            if li < n_mlp - 1:
                h = jax.nn.silu(h) * cst
        tmp = jnp.dot(w3j_ref[:], shT, **kw)   # (R, T)

        def mmred(acc):
            # (mul, T) x (T, A) -> (mul, A)
            return jax.lax.dot_general(
                acc, ones_ref[:], (((1,), (0,)), ((), ())), **kw)

        for ins in instr:
            d1, d3, mul = ins["d1"], ins["d3"], ins["mul"]
            x0, w0 = ins["x_start"], ins["w_start"]
            wb = h[w0:w0 + mul, :]
            xw = [xgT[x0 + m*mul : x0 + (m+1)*mul, :] * wb for m in range(d1)]
            by_p = {}
            for m, p, r in ins["mp"]:
                term = xw[m] * tmp[r:r + 1, :]
                by_p[p] = term if p not in by_p else by_p[p] + term
            g0, u_off, u_tot = ins["g_start"], ins["u_off"], ins["u_tot"]
            for p in range(d3):
                start = g0 + p*u_tot + u_off
                if p in by_p:
                    out_ref[:, start:start+mul] = mmred(by_p[p]).T
                else:
                    out_ref[:, start:start+mul] = jnp.zeros((A_, mul), jnp.float32)

    def fused(xg, emb, sh, mlp_ws, w3j_pack_np):
        n_blocks = xg.shape[0] // T_
        in_specs = [
            pl.BlockSpec((T_, dim_x), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T_, n_basis), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T_, dim_f), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T_, A_), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ] + [pl.BlockSpec(w.shape, lambda i: (0, 0), memory_space=pltpu.VMEM)
             for w in mlp_ws] + [
            pl.BlockSpec((R, dim_f), lambda i: (0, 0), memory_space=pltpu.VMEM)]
        return pl.pallas_call(
            kernel, grid=(n_blocks,), in_specs=in_specs,
            out_specs=pl.BlockSpec((A_, dim_mid), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((n_blocks*A_, dim_mid), jnp.float32),
            interpret=True,
        )(xg, emb, sh, jnp.asarray(O_np), *mlp_ws, jnp.asarray(w3j_pack_np))
    return fused


def pallas_build_featroll(L, A_, mlp_only=False):
    """``scripts_dev/r2_fused_breakdown.py:273-352`` (``build_featroll``'s
    kernel and call; its unused ``prec`` and ``tponly`` arguments left out)."""
    T_ = A_ * K
    PREC2 = jax.lax.Precision.HIGHEST  # Mosaic supports DEFAULT/HIGHEST only
    instr, dim_mid, R = L.instr, L.dim_mid, L.R
    n_mlp, inv_sqrt, cst = L.n_mlp, L.inv_sqrt, L.cst
    dim_x, dim_f, n_basis = L.dim_x, L.dim_f, L.n_basis

    def kernel(xg_ref, emb_ref, sh_ref, *rest):
        mlp_refs = rest[:n_mlp]
        w3j_ref = rest[n_mlp]
        out_ref = rest[n_mlp + 1]
        scr = rest[n_mlp + 2]
        kw = dict(preferred_element_type=jnp.float32, precision=PREC2)
        xgT = xg_ref[:].T
        embT = emb_ref[:].T
        shT = sh_ref[:].T
        h = embT
        for li, wref in enumerate(mlp_refs):
            h = jnp.dot(wref[:].T, h, **kw) * inv_sqrt[li]
            if li < n_mlp - 1:
                h = jax.nn.silu(h) * cst
        tmp = jnp.dot(w3j_ref[:], shT, **kw)
        if mlp_only:
            out_ref[:] = jnp.pad((h[:, :A_] + tmp[:, :A_][: h.shape[0]]
                                  if False else h[:, :A_]).T,
                                 ((0, 0), (0, dim_mid - h.shape[0])))
            return

        def kfold(acc):
            # lanes are k-major: lane = k*A_ + a; fold K down to 1
            kcur = K
            while kcur > 1:
                if kcur % 2 == 0:
                    half = (kcur // 2) * A_
                    acc = acc[:, :half] + pltpu.roll(acc, acc.shape[1] - half, 1)[:, :half]
                    kcur //= 2
                else:
                    acc = acc[:, : (kcur - 1) * A_] + jnp.pad(
                        pltpu.roll(acc, A_, 1)[:, :A_],
                        ((0, 0), (0, (kcur - 2) * A_)))
                    kcur -= 1
            return acc  # (mul, A_)

        for ins in instr:
            d1, d3, mul = ins["d1"], ins["d3"], ins["mul"]
            x0, w0 = ins["x_start"], ins["w_start"]
            wb = h[w0:w0 + mul, :]
            xw = [xgT[x0 + m*mul : x0 + (m+1)*mul, :] * wb for m in range(d1)]
            by_p = {}
            for m, p, r in ins["mp"]:
                term = xw[m] * tmp[r:r + 1, :]
                by_p[p] = term if p not in by_p else by_p[p] + term
            g0, u_off, u_tot = ins["g_start"], ins["u_off"], ins["u_tot"]
            for p in range(d3):
                start = g0 + p*u_tot + u_off
                if p in by_p:
                    scr[start:start + mul, :] = kfold(by_p[p])
                else:
                    scr[start:start + mul, :] = jnp.zeros((mul, A_), jnp.float32)
        out_ref[:] = scr[:].T

    def fused(xg, emb, sh, mlp_ws, w3j_pack_np):
        n_blocks = xg.shape[0] // T_
        in_specs = [
            pl.BlockSpec((T_, dim_x), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T_, n_basis), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T_, dim_f), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ] + [pl.BlockSpec(w.shape, lambda i: (0, 0), memory_space=pltpu.VMEM)
             for w in mlp_ws] + [
            pl.BlockSpec((R, dim_f), lambda i: (0, 0), memory_space=pltpu.VMEM)]
        return pl.pallas_call(
            kernel, grid=(n_blocks,), in_specs=in_specs,
            out_specs=pl.BlockSpec((A_, dim_mid), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((n_blocks*A_, dim_mid), jnp.float32),
            scratch_shapes=[pltpu.VMEM((dim_mid, A_), jnp.float32)],
            interpret=True,
        )(xg, emb, sh, *mlp_ws, jnp.asarray(w3j_pack_np))
    return fused


def pallas_knockout(L, variant, N, A):
    """``scripts_dev/r3_fwd_knockout.py:50-139`` (``make``'s kernel and call)."""
    T = A * K
    NK = N * K
    NB = NK // T
    instr, dim_mid, R, numel = L.instr, L.dim_mid, L.R, L.numel
    n_mlp, inv_sqrt, cst = L.n_mlp, L.inv_sqrt, L.cst
    dim_x, dim_f, n_basis = L.dim_x, L.dim_f, L.n_basis
    mlp_ws_shapes = list(zip(L.dims[:-1], L.dims[1:]))
    do_mlp = variant not in ("nomlp", "nothing")
    do_tp = variant not in ("notp", "nothing")
    do_fold = variant not in ("nofold",)

    def _kfold(acc):
        kcur = K
        while kcur > 1:
            w = kcur * A
            if kcur % 2 == 0:
                half = (kcur // 2) * A
                acc = acc[:, :half] + pltpu.roll(acc, w - half, 1)[:, :half]
                kcur //= 2
            else:
                head = acc[:, : (kcur - 1) * A]
                tail = pltpu.roll(acc, A, 1)[:, :A]
                acc = head + jnp.pad(tail, ((0, 0), (0, (kcur - 2) * A)))
                kcur -= 1
        return acc

    def kernel(xg_ref, emb_ref, sh_ref, *rest):
        mlp_refs = rest[:n_mlp]
        w3j_ref = rest[n_mlp]
        out_ref = rest[n_mlp + 1]
        scr = rest[n_mlp + 2]
        xgT = xg_ref[:].T
        embT = emb_ref[:].T
        shT = sh_ref[:].T
        if do_mlp:
            h = embT
            for li, wref in enumerate(mlp_refs):
                h = jnp.dot(wref[:].T, h, **_DOT) * inv_sqrt[li]
                if li < n_mlp - 1:
                    h = jax.nn.silu(h) * cst
        else:
            h = jnp.broadcast_to(embT[:1, :] * 0.1, (numel, T))
        tmp = jnp.dot(w3j_ref[:], shT, **_DOT)
        if not do_tp:
            scr[:, :] = jnp.broadcast_to(
                (h[:1, :1] + tmp[:1, :1]), (dim_mid, A)
            )
        else:
            for ins in instr:
                d1, d3, mul = ins["d1"], ins["d3"], ins["mul"]
                x0, w0 = ins["x_start"], ins["w_start"]
                wb = h[w0 : w0 + mul, :]
                xw = [
                    xgT[x0 + m * mul : x0 + (m + 1) * mul, :] * wb
                    for m in range(d1)
                ]
                by_p = {}
                for m, p, r in ins["mp"]:
                    term = xw[m] * tmp[r : r + 1, :]
                    by_p[p] = term if p not in by_p else by_p[p] + term
                g0, u_off, u_tot = ins["g_start"], ins["u_off"], ins["u_tot"]
                for p in range(d3):
                    start = g0 + p * u_tot + u_off
                    if p in by_p:
                        if do_fold:
                            scr[start : start + mul, :] = _kfold(by_p[p])
                        else:
                            scr[start : start + mul, :] = by_p[p][:, :A]
                    else:
                        scr[start : start + mul, :] = jnp.zeros(
                            (mul, A), jnp.float32
                        )
        out_ref[:] = scr[:].T

    in_specs = [
        pl.BlockSpec((T, dim_x), lambda i: (i, 0), memory_space=pltpu.VMEM),
        pl.BlockSpec((T, n_basis), lambda i: (i, 0), memory_space=pltpu.VMEM),
        pl.BlockSpec((T, dim_f), lambda i: (i, 0), memory_space=pltpu.VMEM),
    ] + [
        pl.BlockSpec(w_shape, lambda i: (0, 0), memory_space=pltpu.VMEM)
        for w_shape in mlp_ws_shapes
    ] + [
        pl.BlockSpec((R, dim_f), lambda i: (0, 0), memory_space=pltpu.VMEM),
    ]
    return pl.pallas_call(
        kernel,
        grid=(NB,),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((A, dim_mid), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NB * A, dim_mid), jnp.float32),
        scratch_shapes=[pltpu.VMEM((dim_mid, A), jnp.float32)],
        interpret=True,
    )


# port variant -> (the script's call of it, the precision it passes)
def _script_call(variant, A):
    L = LAYER
    if variant in ("feat_full", "feat_transpose"):
        return pallas_build_feat(L, "full" if variant == "feat_full" else "transpose", A)
    if variant == "featroll_full":
        return pallas_build_featroll(L, A)
    if variant == "featroll_mlp":
        return pallas_build_featroll(L, A, mlp_only=True)
    hi = variant.endswith("_hi")
    return pallas_build(L, variant[:-3] if hi else variant, PREC if hi else None, A)


# the variants that compute their function at any A, with the row order the
# script gives them
ANY_A = {"full": "a", "fullk": "k", "fullmm": "k", "tpredmm_amaj": "a", "feat_full": "a",
         "featroll_full": "k"}


def _run_script(variant, A, xg, emb, sh, ws):
    if variant in ANY_A:
        xg, emb, sh = script_rows([xg, emb, sh], ANY_A[variant], A)
    f = _script_call(variant, A)
    return np.asarray(f(*(jnp.asarray(v) for v in (xg, emb, sh)), [jnp.asarray(w) for w in ws],
                        LAYER.w3j_pack_np))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * np.abs(want).max())


def _port(fn, xg, emb, sh, ws, variant):
    return fn(LAYER.op, *(torch.tensor(v) for v in (xg, emb, sh)), [torch.tensor(w) for w in ws],
              K, variant, plain=True).numpy()


@pytest.mark.parametrize("variant", bd.VARIANTS)
def test_breakdown_plain_matches_pallas(variant):
    """Every variant at A = 1 (3 blocks of one receiver)."""
    xg, emb, sh, ws = _inputs(60, 3)
    assert np.array_equal(LAYER.w3j_pack_np, LAYER.op.w3j_pack)  # the port's own tables
    want = _run_script(variant, 1, xg, emb, sh, ws)
    got = _port(bd.breakdown, xg, emb, sh, ws, variant)
    if variant == "feat_transpose":
        assert np.array_equal(got, want)
        return
    if variant == "storek":
        unwritten = bd.storek_map(LAYER.conv) == -2
        assert unwritten.any() and np.isnan(want[:, unwritten]).all()
        assert not np.isnan(want[:, ~unwritten]).any() and (got[:, unwritten] == 0).all()
        got, want = got[:, ~unwritten], want[:, ~unwritten]
    _close(got, want)


@pytest.mark.parametrize("variant", sorted(ANY_A))
def test_breakdown_plain_matches_pallas_at_a2(variant):
    """The variants that compute their function at any A, at A = 2 (2
    blocks of two receivers), on the script's own row order."""
    xg, emb, sh, ws = _inputs(61, 4)
    _close(_port(bd.breakdown, xg, emb, sh, ws, variant), _run_script(variant, 2, xg, emb, sh, ws))


@pytest.mark.parametrize("variant", ko.VARIANTS)
def test_knockout_plain_matches_pallas(variant):
    """Every variant at A = 1 (3 blocks of one receiver)."""
    xg, emb, sh, ws = _inputs(62, 3)
    f = pallas_knockout(LAYER, variant, 3, 1)
    want = np.asarray(f(*(jnp.asarray(v) for v in (xg, emb, sh)), *(jnp.asarray(w) for w in ws),
                        jnp.asarray(LAYER.w3j_pack_np)))
    _close(_port(ko.knockout, xg, emb, sh, ws, variant), want)


def test_knockout_full_plain_matches_pallas_at_a2():
    """``full``, the knock-out's one variant that computes its function at
    any A, at A = 2 (2 blocks) on the script's k-major rows."""
    xg, emb, sh, ws = _inputs(63, 4)
    f = pallas_knockout(LAYER, "full", 4, 2)
    want = np.asarray(f(*(jnp.asarray(v) for v in script_rows([xg, emb, sh], "k", 2)),
                        *(jnp.asarray(w) for w in ws), jnp.asarray(LAYER.w3j_pack_np)))
    _close(_port(ko.knockout, xg, emb, sh, ws, "full"), want)


@pytest.mark.parametrize("fn,variant", [(bd.breakdown, v) for v in (
    "full", "full_hi", "fullk", "fullmm", "feat_full", "featroll_full")] + [(ko.knockout, "full")])
def test_full_plain_is_b4_fwd(fn, variant):
    """The conv variants' plain versions are B4 fwd's function: on the
    identity gather they match the port's plain emb/sh conv forward
    (``fused_conv_fwd_embsh_plain``), which the kernels' ``full_hi`` and
    knock-out ``full`` equal bitwise on the card."""
    xg, emb, sh, ws = _inputs(64, 3)
    src = torch.arange(3 * K, dtype=torch.int32).view(3, K)
    want = fc.fused_conv_fwd_embsh_plain(LAYER.op, torch.tensor(xg), src, torch.tensor(emb),
                                         torch.tensor(sh), [torch.tensor(w) for w in ws])
    _close(_port(fn, xg, emb, sh, ws, variant), want.numpy())


def test_breakdown_knockout_wrappers_check_their_inputs():
    """The wrappers raise on CPU tensors unless told to run the plain
    version (which does not count as a launch), and refuse unknown
    variants, misshapen or mistyped inputs and a vec-mode op."""
    xg, emb, sh, ws = _inputs(65, 2)
    t = [torch.tensor(v) for v in (xg, emb, sh)]
    tw = [torch.tensor(w) for w in ws]
    op = LAYER.op
    counts = (bd.breakdown.launches, dict(bd.breakdown.by_variant), ko.knockout.launches,
              dict(ko.knockout.by_variant))
    for fn, v in ((bd.breakdown, "full_hi"), (bd.breakdown, "tp"), (ko.knockout, "nomlp")):
        with pytest.raises(ValueError, match="plain=True"):
            fn(op, *t, tw, K, v)
        fn(op, *t, tw, K, v, plain=True)
    with pytest.raises(ValueError, match="variant"):
        bd.breakdown(op, *t, tw, K, "fullx", plain=True)
    with pytest.raises(ValueError, match="variant"):
        ko.knockout(op, *t, tw, K, "noxpose", plain=True)
    with pytest.raises(ValueError, match="float32"):
        bd.breakdown(op, t[0].double(), *t[1:], tw, K, plain=True)
    with pytest.raises(ValueError, match="whole number"):
        bd.breakdown(op, *(v[:-1] for v in t), tw, K, plain=True)
    with pytest.raises(ValueError, match="sh"):
        ko.knockout(op, t[0], t[1], t[2][:, :4].contiguous(), tw, K, plain=True)
    with pytest.raises(ValueError, match="radial MLP"):
        bd.breakdown(op, *t, tw[:-1], K, plain=True)
    with pytest.raises(ValueError, match="emb/sh"):
        vec_op = fc.conv_op(LAYER.conv, ScalarMLPSpec(LAYER.dims),
                            fc.EdgeEmbedSpec(lmax=2, n_basis=8, cutoff=5.0,
                                             cutoff_kind="poly_cut", cutoff_arg=6.0))
        bd.breakdown(vec_op, *t, tw, K, plain=True)
    assert (bd.breakdown.launches, bd.breakdown.by_variant, ko.knockout.launches,
            ko.knockout.by_variant) == counts
    assert bd.tol("feat_transpose") == 0 and bd.tol("full") == 2.0 ** -8
    assert bd.tol("full_hi") == bd.tol("featroll_full") == 1e-4


def test_breakdown_knockout_work_counts():
    """The operation and byte counts the bounds divide by, at the scripts'
    shapes, against counts made by hand for SevenNet-0's layer: per slot
    the MLP 15 + 8,128 + 121,920 multiply-adds' 2n - 1 counts, tmp 2 nnz -
    129, the messages 2 per elementary term; per receiver 95 or 71 adds a
    column of the K sum."""
    from sevennet_tpu_torch.probes import fold_conv as fcv

    conv, mlp = fcv.sevennet0_conv()
    op = fc.conv_op(conv, mlp)
    mlp_f = 64 * 15 + 64 * 127 + 960 * 127
    assert mlp_f == 131008
    nnz = int((op.w3j_pack != 0).sum())
    tmp_f = 2 * nnz - 129
    msg = 2 * op.n_terms
    n, k = bd.N, bd.K
    nk = n * k
    w_floats = 8 * 64 + 64 * 64 + 64 * 960
    fl, by, one = bd.breakdown_work(op, "full", n, k)
    assert fl == nk * (mlp_f + tmp_f + msg) + n * (k - 1) * 3136
    assert by == 4 * (nk * (480 + 8 + 9) + w_floats + 129 * 9 + n * 3136)
    assert one == nk * (mlp_f + tmp_f)
    assert bd.breakdown_work(op, "full_hi", n, k) == (fl, by, 0)
    # the full conv is chip_smoke.py:work's fwd_embsh on the gathered rows
    assert fl == nk * (mlp_f + tmp_f + 2 * op.n_terms + 3136) - n * 3136
    assert bd.breakdown_work(op, "mlp", n, k) == (nk * mlp_f, 4 * (nk * 8 + w_floats + n * 3136),
                                                  nk * mlp_f)
    assert bd.breakdown_work(op, "tp", n, k)[0] == nk * (mlp_f + tmp_f + msg + 3136 - 128)
    assert bd.breakdown_work(op, "tpredmm", n, k)[0] == (nk * (mlp_f + tmp_f + msg)
                                                         + n * ((k - 1) * 3136 + 3136 - 128))
    assert bd.breakdown_work(op, "feat_transpose", n, k) == (0, 4 * (nk * 480 + n * 3136), 0)
    n, k = ko.N, ko.K
    nk = n * k
    assert ko.knockout_work(op, "nothing", n, k) == (
        nk * (1 + tmp_f), 4 * (nk * (8 + 9) + 129 * 9 + n * 3136), 0)
    assert ko.knockout_work(op, "nomlp", n, k)[0] == nk * (1 + tmp_f + msg) + n * 71 * 3136
    assert ko.knockout_work(op, "nofold", n, k)[0] == nk * (mlp_f + tmp_f + msg)
    assert ko.knockout_work(op, "full", n, k) == bd.conv_work(op, n, k)


def test_storek_map_is_the_scripts_last_writer():
    """storek's column map, checked against the script's stores replayed
    in numpy at SevenNet-0's layer: each window of 128 columns at its
    aligned offset, the instruction's channels then zeros, last writer
    wins."""
    from sevennet_tpu_torch.probes import fold_conv as fcv

    conv, _ = fcv.sevennet0_conv()
    instr, _, dim_mid, _ = fc._instr_tables(conv)
    out = np.full(dim_mid, -2)
    for ins in instr:
        by_p = {}
        for _, p, _ in ins["mp"]:
            by_p.setdefault(p, None)
        for p in by_p:
            col = (ins["g_start"] // 128) * 128 % (dim_mid - 128)
            start = ins["g_start"] + p * ins["u_tot"] + ins["u_off"]
            window = np.full(128, -1)
            window[: ins["mul"]] = np.arange(start, start + ins["mul"])
            out[col:col + 128] = window
    assert np.array_equal(bd.storek_map(conv), out)
