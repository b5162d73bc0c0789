"""The port's fused conv against the JAX package's: vec mode
(``sevennet_tpu/ops/fused_conv.py:fused_conv_apply_vec``) and emb/sh mode
(``fused_conv_apply``, and the kernels ``make_fused_conv_fwd`` /
``make_fused_conv_bwd2`` with ``embed=None`` and ``make_fused_conv_bwd``),
Pallas kernels in interpret mode on the CPU, as tests/test_fused_conv.py
runs them.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
CUDA kernels walk precomputed term tables, which a numpy walk here holds
against the plain version. The kernels themselves are checked on the card
(tests/test_torch_kernels.py, and chip_smoke.py).

Tiny shapes: ``8x0e+8x1e+8x2e``, N = 24, K = 16 (slots past each atom's
neighbour count padded with the sentinel vector), MLP (8, 16, 16, numel).
In emb/sh mode the inputs are what a model with unnormalized spherical
harmonics feeds the conv: the Bessel embedding times the envelope (zero
rows on padded slots) and the spherical harmonics of the raw edge vectors
(large on the sentinel). Tolerance atol 1e-5, or 1e-5 of the largest
reference value where values reach tens: fp32 on both sides, sums in
another order.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_tpu.irreps import Irreps as JIrreps
from sevennet_tpu.irreps import infer_irreps_out as j_infer
from sevennet_tpu.ops import fused_conv as jfc
from sevennet_tpu.ops import radial as jradial
from sevennet_tpu.ops.mlp import ScalarMLPSpec as JMLPSpec
from sevennet_tpu.ops.tensor_product import ConvTPSpec as JConvTPSpec
from sevennet_tpu.so3.spherical import spherical_harmonics as j_sph
from sevennet_tpu_torch.data.graph import densify_edges
from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy
from sevennet_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_tpu_torch.ops import fused_conv as fc
from sevennet_tpu_torch.ops import radial
from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec
from sevennet_tpu_torch.so3.spherical import spherical_harmonics

torch.set_num_threads(1)
X_IR, F_IR = "8x0e+8x1e+8x2e", "1x0e+1x1e+1x2e"
N, K, CUT = 24, 16, 3.0


def _specs(kind):
    arg = 2.5 if kind == "XPLOR" else 6.0
    jconv = JConvTPSpec(JIrreps(X_IR), JIrreps(F_IR), j_infer(JIrreps(X_IR), JIrreps(F_IR), 2, "full"))
    conv = ConvTPSpec(Irreps(X_IR), Irreps(F_IR), infer_irreps_out(Irreps(X_IR), Irreps(F_IR), 2, "full"))
    dims = (8, 16, 16, conv.weight_numel)
    return (
        (jconv, JMLPSpec(dims), jfc.EdgeEmbedSpec(8, CUT, kind, arg, 2)),
        (conv, ScalarMLPSpec(dims), fc.EdgeEmbedSpec(8, CUT, kind, arg, 2)),
    )


def _problem(seed=0):
    """Random atoms in an open box; a symmetric neighbour list in the dense
    (N, K) layout, sentinel vectors on padded slots; weights and the
    cotangent from the same seed."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 7.0, (N, 3))
    dst, src, shift = neighbor_list_numpy(pos, CUT)
    order = np.argsort(dst, kind="stable")
    src_d, _, shift_d, mask_d = densify_edges(
        src[order].astype(np.int32), dst[order].astype(np.int32),
        shift[order], np.ones(len(dst), bool), N, K,
    )
    assert 0 < mask_d.sum() < N * K, "want real and padded slots"
    vec = pos[src_d] - pos[np.repeat(np.arange(N), K)]
    vec[~mask_d] = (2 * CUT, 0.0, 0.0)
    src_nk = src_d.reshape(N, K)
    mir = fc.mirror_map_numpy(src_nk, shift_d.reshape(N, K, 3), mask_d.reshape(N, K))
    return dict(
        src=src_nk, shift=shift_d.reshape(N, K, 3), mask=mask_d.reshape(N, K), mir=mir,
        vec=np.ascontiguousarray(vec.T, np.float32),
        x=(rng.normal(size=(N, 72)) * 0.5).astype(np.float32),
        coef=np.linspace(1.0, 8.0, 8).astype(np.float32),
        rng=rng,
    )


def _weights(rng, dims):
    return [rng.normal(size=(a, b)).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]


def test_instr_tables_and_mirror_map_match_jax():
    (jconv, _, _), (conv, _, _) = _specs("XPLOR")
    ji, jw, jd, jn = jfc._instr_tables(jconv)
    ti, tw, td, tn = fc._instr_tables(conv)
    assert ji == ti and (jd, jn) == (td, tn)
    np.testing.assert_array_equal(jw, tw)
    p = _problem()
    mir = p["mir"]
    np.testing.assert_array_equal(mir, jfc.mirror_map_numpy(p["src"], p["shift"], p["mask"]))
    np.testing.assert_array_equal(
        mir, np.asarray(jfc.mirror_map(jnp.asarray(p["src"]), jnp.asarray(p["shift"]),
                                       jnp.asarray(p["mask"]))))
    # padded slots point at themselves; real ones at an edge pointing back
    flat = np.arange(N * K).reshape(N, K)
    assert (mir[~p["mask"]] == flat[~p["mask"]]).all()
    i_idx = np.repeat(np.arange(N), K).reshape(N, K)
    assert (p["src"].reshape(-1)[mir[p["mask"]]] == i_idx[p["mask"]]).all()


@pytest.mark.parametrize("kind", ["XPLOR", "poly_cut"])
def test_fused_conv_matches_jax_vec(kind):
    """Forward, and dx / dvec through the autograd Function (plain forward,
    plain backward, mirror gather) against JAX's custom_vjp op."""
    (jconv, jmlp, jemb), (conv, mlp, emb) = _specs(kind)
    p = _problem()
    ws = _weights(p["rng"], mlp.dims)
    ybar = (p["rng"].normal(size=(N, conv.irreps_mid.dim)) * 0.1).astype(np.float32)

    def jax_conv(x, vec):
        return jfc.fused_conv_apply_vec(
            jconv, jmlp, {"w": [jnp.asarray(w) for w in ws]}, jnp.asarray(p["coef"])[:, None],
            jemb, x, vec, jnp.asarray(p["src"]), jnp.asarray(p["mir"]),
            block_atoms=8, param_grads=False,
        )

    out_j, pull = jax.vjp(jax_conv, jnp.asarray(p["x"]), jnp.asarray(p["vec"]))
    dx_j, dvec_j = pull(jnp.asarray(ybar))

    x = torch.tensor(p["x"], requires_grad=True)
    vec = torch.tensor(p["vec"], requires_grad=True)
    out = fc.fused_conv_apply_vec(
        conv, mlp, {"w": [torch.tensor(w) for w in ws]}, torch.tensor(p["coef"]), emb,
        x, vec, torch.tensor(p["src"]).long(), torch.tensor(p["mir"]).long(),
    )
    dx, dvec = torch.autograd.grad(out, (x, vec), torch.tensor(ybar))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-5)
    np.testing.assert_allclose(dvec.numpy(), np.asarray(dvec_j), atol=1e-5)
    # padded slots: exactly zero edge-vector cotangents
    assert (dvec.numpy()[:, ~p["mask"].reshape(-1)] == 0).all()


def _walk_tables(op, x, src, vec, coef, ws, ybar):
    """The CUDA kernels' algorithm in float64 numpy, reading the same
    tables (``op.itab``/``op.ftab`` at the offsets of ``op.dims`` and of
    the uvu header at the table's start): per edge inside the cutoff,
    embedding and spherical-harmonic terms, the MLP, then the uvu product
    and its pullback task by task (the forward's (instruction, channels)
    tasks, ``dtmp`` per (instruction, m), ``dxg`` and ``dw`` per (x irrep,
    channels) over the instructions that read the irrep).
    Also what B2′ adds: the per-edge record of the parameter gradients at
    the columns of ``op.ws_layout`` (rows outside the cutoff stay NaN and
    invalid), and the sums over edges ``dW_l = h_l ⊗ g_l / sqrt(d_l)`` and
    ``dcoef``."""
    d = op.dims(*src.shape)
    it, ftab = op.itab.astype(np.int64), op.ftab.astype(np.float64)

    off_ins, n_dt, off_dt, n_dx, off_dx, off_list, n_fw, off_fw = it[:8]
    # every task once, in the warps' runs
    for n_t, runs in ((n_dt, it[8]), (n_dx, it[9]), (n_fw, it[10])):
        starts = it[runs : runs + fc.UVU_WARPS + 1]
        assert starts[0] == 0 and starts[-1] == n_t and (np.diff(starts) >= 0).all()

    def ins(kk):
        rec = it[off_ins + kk * fc.UVU_INS : off_ins + (kk + 1) * fc.UVU_INS]
        return rec[:7], rec[8 : 8 + 49].reshape(7, 7)

    dt_tasks = it[off_dt : off_dt + 4 * n_dt].reshape(-1, 4)
    dx_tasks = it[off_dx : off_dx + 8 * n_dx].reshape(-1, 8)
    fw_tasks = it[off_fw : off_fw + 4 * n_fw].reshape(-1, 4)
    sh_t = it[d.sh_terms : d.sh_terms + 4 * d.n_sh].reshape(-1, 4)
    sh_c = ftab[d.sh_coef : d.sh_coef + d.n_sh]
    sd_t = it[d.shd_terms : d.shd_terms + 4 * d.n_shd].reshape(-1, 4)
    sd_comp = it[d.shd_terms + 4 * d.n_shd : d.shd_terms + 5 * d.n_shd]
    sd_c = ftab[d.shd_coef : d.shd_coef + d.n_shd]
    w3j = ftab[d.w3j : d.w3j + d.R * d.dim_f].reshape(d.R, d.dim_f)
    W1, W2, W3 = [np.asarray(w, np.float64) for w in ws]
    n, k = src.shape
    out = np.zeros((n, d.dim_mid))
    dxg = np.zeros((n * k, d.dim_x))
    dvec = np.zeros((3, n * k))
    L = op.ws_layout
    work = np.full((n * k, L["stride"]), np.nan, np.float32)
    valid = np.zeros(n * k, np.uint8)
    dws = [np.zeros(w.shape) for w in (W1, W2, W3)]
    dcoef = np.zeros(d.n_basis)
    es = op.embed
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))  # noqa: E731
    for f in range(n * k):
        i = f // k
        v = vec[:, f].astype(np.float64)
        r = max(np.sqrt(v @ v), 1e-12)
        if not r < es.cutoff:
            continue
        rinv, u = 1.0 / r, v / r
        if es.cutoff_kind == "XPLOR":
            on, c = es.cutoff_arg, es.cutoff
            a, b = c * c - r * r, c * c + 2 * r * r - 3 * on * on
            inv = 1.0 / (c * c - on * on) ** 3
            env = 1.0 if r < on else a * a * b * inv
            denv = 0.0 if r < on else (-4 * r * a * b + 4 * r * a * a) * inv
        else:
            pp, xr = es.cutoff_arg, r / es.cutoff
            xp = xr**pp
            c0, c1, c2 = (pp + 1) * (pp + 2) / 2, pp * (pp + 2), pp * (pp + 1) / 2
            env = 1 - c0 * xp + c1 * xp * xr - c2 * xp * xr * xr
            denv = (-c0 * pp * xp / xr + c1 * (pp + 1) * xp - c2 * (pp + 2) * xp * xr) / es.cutoff
        mono = lambda t: u[0] ** t[1] * u[1] ** t[2] * u[2] ** t[3]  # noqa: E731
        sh = np.zeros(d.dim_f)
        for t, c in zip(sh_t, sh_c):
            sh[t[0]] += c * mono(t)
        emb = np.sin(coef * r) * (2.0 / es.cutoff) * rinv * env
        tmp = w3j @ sh
        z1 = emb @ W1 / np.sqrt(d.n_basis)
        h1 = z1 * sig(z1) * d.act_cst
        z2 = h1 @ W2 / np.sqrt(d.h1)
        h2 = z2 * sig(z2) * d.act_cst
        w = h2 @ W3 / np.sqrt(d.h2)
        xs = x[src[i, f % k]].astype(np.float64)
        yb = ybar[i].astype(np.float64)
        for kk, u0, _, _ in fw_tasks:
            (x0, d1, d3, mul, w0, y0, ut), rt = ins(kk)
            uu = np.arange(u0, min(u0 + 16, mul))
            for p_ in range(d3):
                for m in range(d1):
                    if rt[m, p_] >= 0:
                        out[i, y0 + p_ * ut + uu] += xs[x0 + m * mul + uu] * w[w0 + uu] * tmp[rt[m, p_]]
        dtmp = np.zeros(d.R)
        for kk, m, _, _ in dt_tasks:
            (x0, d1, d3, mul, w0, y0, ut), rt = ins(kk)
            uu = np.arange(mul)
            for p_ in range(d3):
                if rt[m, p_] >= 0:
                    dtmp[rt[m, p_]] = np.sum(xs[x0 + m * mul + uu] * w[w0 + uu] * yb[y0 + p_ * ut + uu])
        dw = np.zeros(d.numel)
        for x0, d1, mul, l0, nl, u0, _, _ in dx_tasks:
            uu = np.arange(u0, min(u0 + 8, mul))
            for kk in it[off_list + l0 : off_list + l0 + nl]:
                (_, _, d3, _, w0, y0, ut), rt = ins(kk)
                for m in range(d1):
                    a = sum(yb[y0 + p_ * ut + uu] * tmp[rt[m, p_]] for p_ in range(d3)
                            if rt[m, p_] >= 0)
                    dxg[f, x0 + m * mul + uu] += w[w0 + uu] * a
                    dw[w0 + uu] += xs[x0 + m * mul + uu] * a
        dsilu = lambda z: sig(z) * (1 + z * (1 - sig(z))) * d.act_cst  # noqa: E731
        dz2 = (W3 @ dw) / np.sqrt(d.h2) * dsilu(z2)
        dz1 = (W2 @ dz2) / np.sqrt(d.h1) * dsilu(z1)
        demb = (W1 @ dz1) / np.sqrt(d.n_basis)
        dsh = w3j.T @ dtmp
        dr = np.sum(demb * (2.0 / es.cutoff) * (
            coef * np.cos(coef * r) * rinv * env
            + np.sin(coef * r) * (denv * rinv - env * rinv * rinv)))
        du = np.zeros(3)
        for t, comp, c in zip(sd_t, sd_comp, sd_c):
            du[comp] += c * dsh[t[0]] * mono(t)
        dvec[:, f] = (du - u * (u @ du)) * rinv + u * dr
        dc = demb * (2.0 / es.cutoff) * np.cos(coef * r) * env
        for dW, h, g, fan_in in ((dws[0], emb, dz1, d.n_basis), (dws[1], h1, dz2, d.h1),
                                 (dws[2], h2, dw, d.h2)):
            dW += np.outer(h, g) / np.sqrt(fan_in)
        dcoef += dc
        work[f, L["emb"] : L["dc"] + d.n_basis] = np.concatenate(
            [emb, h1, h2, dz1, dz2, dw, dc])
        valid[f] = 1
    return out, dxg, dvec, dws, dcoef, work, valid


@pytest.mark.parametrize("kind", ["XPLOR", "poly_cut"])
def test_kernel_tables_reproduce_plain(kind):
    """The tables the CUDA kernels read (the uvu product's instruction
    records and task lists; spherical harmonics and their derivatives as
    monomial terms) give the plain versions' results."""
    _, (conv, mlp, emb) = _specs(kind)
    op = fc.conv_op(conv, mlp, emb)
    p = _problem(seed=1)
    ws = _weights(p["rng"], mlp.dims)
    ybar = (p["rng"].normal(size=(N, op.dim_mid)) * 0.1).astype(np.float32)
    out, dxg, dvec, dws, dcoef, work, valid = _walk_tables(
        op, p["x"], p["src"], p["vec"], p["coef"], ws, ybar)
    args = (op, torch.tensor(p["x"]), torch.tensor(p["src"]), torch.tensor(p["vec"]),
            torch.tensor(p["coef"]), [torch.tensor(w) for w in ws])
    out_p = fc.fused_conv_fwd_plain(*args)
    dxg_p, dvec_p, dws_p, dcoef_p = fc.fused_conv_bwd_plain(*args, torch.tensor(ybar),
                                                            param_grads=True)
    np.testing.assert_allclose(out, out_p.numpy(), atol=1e-5)
    np.testing.assert_allclose(dxg, dxg_p.numpy(), atol=1e-5)
    np.testing.assert_allclose(dvec, dvec_p.numpy(), atol=1e-5)
    # B2′: the parameter gradients from the walk's sums and from its records
    # through the reduction's CPU path (NaN rows outside the cutoff ignored)
    dws_r, dcoef_r = fc.param_grad_reduce(op, torch.tensor(work), torch.tensor(valid), N, K)
    for want, got, got_r in zip(dws + [dcoef], dws_p + [dcoef_p], dws_r + [dcoef_r]):
        tol = 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(want, got.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(want, got_r.numpy(), rtol=0, atol=tol)


def test_uvu_layout_matches_csrc():
    """The host lays the uvu task tables out as the kernels' header defines
    them, and the launch-time check refuses a library that reads another
    layout."""
    header = (Path(fc.__file__).resolve().parents[1] / "csrc" / "fused_conv_common.cuh")
    defines = dict(re.findall(r"^#define (NT|UVU_INS|UVU_D) (\d+)", header.read_text(), re.M))
    assert (int(defines["NT"]) // 32, int(defines["UVU_INS"]), int(defines["UVU_D"])) == (
        fc.UVU_WARPS, fc.UVU_INS, fc.UVU_MAX_D)

    class Lib:
        def __init__(self, layout):
            self.layout = layout

        def fused_conv_uvu_layout(self, out):
            out[:] = self.layout

    fc.check_uvu_layout(Lib((fc.UVU_WARPS, fc.UVU_INS, fc.UVU_MAX_D)))
    with pytest.raises(RuntimeError, match="uvu table layout"):
        fc.check_uvu_layout(Lib((2 * fc.UVU_WARPS, fc.UVU_INS, fc.UVU_MAX_D)))


def test_wrappers_check_their_inputs():
    _, (conv, mlp, emb) = _specs("XPLOR")
    op = fc.conv_op(conv, mlp, emb)
    p = _problem()
    ws = [torch.tensor(w) for w in _weights(p["rng"], mlp.dims)]
    x, vec, coef = torch.tensor(p["x"]), torch.tensor(p["vec"]), torch.tensor(p["coef"])
    src = torch.tensor(p["src"])
    launches = fc.fused_conv_fwd.launches
    out = fc.fused_conv_fwd(op, x, src, vec, coef, ws)
    assert out.shape == (N, op.dim_mid)
    assert fc.fused_conv_fwd.launches == launches  # the CPU runs the plain version
    with pytest.raises(ValueError, match="src"):
        fc.fused_conv_fwd(op, x, src.long(), vec, coef, ws)
    with pytest.raises(ValueError, match="vec"):
        fc.fused_conv_fwd(op, x, src, vec.T, coef, ws)
    with pytest.raises(ValueError, match="ybar"):
        fc.fused_conv_bwd(op, x, src, vec, coef, ws, torch.zeros(N, 3))
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_conv_fwd(op, x.T.contiguous().T, src, vec, coef, ws)


def test_embsh_wrappers_check_their_inputs():
    """The emb/sh wrappers run the plain twins on the CPU without counting,
    refuse an op of the other mode and misshapen edge arrays, and their
    reduction has no dcoef; the records pass exists only on the card."""
    _, (conv, mlp, emb_spec) = _specs("XPLOR")
    op, op_vec = fc.conv_op(conv, mlp), fc.conv_op(conv, mlp, emb_spec)
    p = _problem()
    ws = [torch.tensor(w) for w in _weights(p["rng"], mlp.dims)]
    x, src = torch.tensor(p["x"]), torch.tensor(p["src"])
    emb, sh = _emb_sh("XPLOR", p["vec"], p["coef"], p["mask"])
    ybar = torch.zeros(N, op.dim_mid)
    launches = fc.fused_conv_fwd_embsh.launches, fc.fused_conv_bwd_embsh.launches
    assert fc.fused_conv_fwd_embsh(op, x, src, emb, sh, ws).shape == (N, op.dim_mid)
    assert len(fc.fused_conv_bwd_embsh(op, x, src, emb, sh, ws, ybar)) == 3
    assert (fc.fused_conv_fwd_embsh.launches, fc.fused_conv_bwd_embsh.launches) == launches
    with pytest.raises(ValueError, match="emb/sh"):
        fc.fused_conv_fwd_embsh(op_vec, x, src, emb, sh, ws)
    with pytest.raises(ValueError, match="vec"):
        fc.fused_conv_fwd(op, x, src, torch.tensor(p["vec"]), torch.tensor(p["coef"]), ws)
    with pytest.raises(ValueError, match="emb"):
        fc.fused_conv_fwd_embsh(op, x, src, emb.T.contiguous(), sh, ws)
    with pytest.raises(ValueError, match="sh"):
        fc.fused_conv_bwd_embsh(op, x, src, emb, sh[:, :4].contiguous(), ws, ybar)
    with pytest.raises(ValueError, match="on the card"):
        fc.fused_conv_bwd_embsh_pg_records(op, x, src, emb, sh, ws, ybar)
    work = torch.randn(N * K, op.ws_layout["stride"])
    dws, dcoef = fc.param_grad_reduce(op, work, torch.ones(N * K, dtype=torch.uint8), N, K)
    assert dcoef is None and [tuple(w.shape) for w in dws] == [tuple(w.shape) for w in ws]


def _jax_conv(jconv, jmlp, jemb, p, param_grads):
    def f(ws, coef, x, vec):
        return jfc.fused_conv_apply_vec(
            jconv, jmlp, {"w": list(ws)}, coef[:, None], jemb, x, vec,
            jnp.asarray(p["src"]), jnp.asarray(p["mir"]),
            block_atoms=8, param_grads=param_grads,
        )
    return f


@pytest.mark.parametrize("kind", ["XPLOR", "poly_cut"])
def test_bwd_param_grads_match_jax(kind):
    """B2′'s plain twin (``param_grads=True``) and the conv's first-order
    gradients through the autograd Function against ``jax.vjp`` over the
    JAX conv with ``param_grads=True`` (its Pallas backward in interpret
    mode): dx, dvec, the MLP weights and the Bessel coefficients."""
    (jconv, jmlp, jemb), (conv, mlp, emb) = _specs(kind)
    p = _problem(seed=2)
    ws = _weights(p["rng"], mlp.dims)
    ybar = (p["rng"].normal(size=(N, conv.irreps_mid.dim)) * 0.1).astype(np.float32)
    jargs = (tuple(jnp.asarray(w) for w in ws), jnp.asarray(p["coef"]),
             jnp.asarray(p["x"]), jnp.asarray(p["vec"]))
    _, pull = jax.vjp(_jax_conv(jconv, jmlp, jemb, p, True), *jargs)
    jdws, jdcoef, jdx, jdvec = pull(jnp.asarray(ybar))

    op = fc.conv_op(conv, mlp, emb)
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    coef = torch.tensor(p["coef"], requires_grad=True)
    x = torch.tensor(p["x"], requires_grad=True)
    vec = torch.tensor(p["vec"], requires_grad=True)
    src, mir = torch.tensor(p["src"]), torch.tensor(p["mir"]).long()
    dxg, dvec_t, dws_t, dcoef_t = fc.fused_conv_bwd_plain(
        op, x.detach(), src, vec.detach(), coef.detach(), [w.detach() for w in tw],
        torch.tensor(ybar), param_grads=True)
    out = fc.fused_conv_apply_vec(conv, mlp, {"w": tw}, coef, emb, x, vec, src.long(), mir)
    g = torch.autograd.grad(out, (x, vec, coef, *tw), torch.tensor(ybar))
    pairs = [("dx", fc.mirror_gather(dxg, mir), g[0], jdx), ("dvec", dvec_t, g[1], jdvec),
             ("dcoef", dcoef_t, g[2], jdcoef)]
    pairs += [(f"dW{i + 1}", a, b, c) for i, (a, b, c) in enumerate(zip(dws_t, g[3:], jdws))]
    for name, twin, through_fn, ref in pairs:
        ref = np.asarray(ref)
        tol = 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(twin.numpy(), ref, rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(through_fn.numpy(), ref, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("kind", ["XPLOR", "poly_cut"])
def test_force_loss_grad_of_grad_matches_jax(kind):
    """The gradient of a force-like loss ``sum (dE/dvec)^2`` with respect to
    the MLP weights, the Bessel coefficients and x, through
    ``fused_conv_apply_vec`` on the CPU (the kernels' path: FusedConvVec,
    whose backward is the differentiable FusedConvBwd), against JAX's
    grad-of-grad through ``_make_bwd_op``. E is nonlinear in the conv's
    output, so the cotangent ybar depends on the parameters too."""
    (jconv, jmlp, jemb), (conv, mlp, emb) = _specs(kind)
    p = _problem(seed=3)
    ws = _weights(p["rng"], mlp.dims)
    R = (p["rng"].normal(size=(N, conv.irreps_mid.dim)) * 0.1).astype(np.float32)
    jconv_f = _jax_conv(jconv, jmlp, jemb, p, True)

    def jloss(ws_, coef, x, vec):
        def energy(v):
            out = jconv_f(ws_, coef, x, v)
            return jnp.sum(out * R) + 0.1 * jnp.sum(out * out)
        return jnp.sum(jax.grad(energy)(vec) ** 2)

    jargs = (tuple(jnp.asarray(w) for w in ws), jnp.asarray(p["coef"]),
             jnp.asarray(p["x"]), jnp.asarray(p["vec"]))
    jdws, jdcoef, jdx = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)

    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    coef = torch.tensor(p["coef"], requires_grad=True)
    x = torch.tensor(p["x"], requires_grad=True)
    vec = torch.tensor(p["vec"], requires_grad=True)
    out = fc.fused_conv_apply_vec(conv, mlp, {"w": tw}, coef, emb, x, vec,
                                  torch.tensor(p["src"]).long(), torch.tensor(p["mir"]).long())
    energy = (out * torch.tensor(R)).sum() + 0.1 * (out * out).sum()
    (dvec,) = torch.autograd.grad(energy, vec, create_graph=True)
    assert dvec.requires_grad
    got = torch.autograd.grad((dvec ** 2).sum(), (*tw, coef, x))
    for name, a, b in [(f"W{i + 1}", g, jg) for i, (g, jg) in enumerate(zip(got[:3], jdws))] + [
            ("coef", got[3], jdcoef), ("x", got[4], jdx)]:
        ref = np.asarray(b)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# emb/sh mode (embed=None): kernels B4 (fwd, bwd, B4′), B5, and the whole op
# ---------------------------------------------------------------------------

A = 8  # JAX block of atoms: k-major lanes T = A * K = 128


def _emb_sh(kind, vec, coef, mask):
    """The legacy model's conv inputs from edge vectors ``(3, N*K)``: the
    Bessel embedding times the envelope and the edge mask, and unnormalized
    spherical harmonics (``sevennet_tpu/model/model.py:379-390``)."""
    ev = torch.as_tensor(vec).T
    r = torch.linalg.vector_norm(ev, dim=-1)
    env = (radial.xplor_cutoff(r, CUT, 2.5) if kind == "XPLOR"
           else radial.poly_cutoff(r, CUT, p=6))
    emb = radial.bessel_basis(r, torch.as_tensor(coef), CUT) * (
        env * torch.as_tensor(mask.reshape(-1), dtype=torch.float32))[:, None]
    return emb, spherical_harmonics(2, ev, normalize=False)


def _j_emb_sh(kind, vec, coef, mask):
    ev = vec.T
    r = jnp.linalg.norm(ev, axis=-1)
    env = (jradial.xplor_cutoff(r, CUT, 2.5) if kind == "XPLOR"
           else jradial.poly_cutoff(r, CUT, p=6))
    emb = jradial.bessel_basis(r, coef, CUT) * (env * jnp.asarray(mask.reshape(-1), jnp.float32))[:, None]
    return emb, j_sph(2, ev, normalize=False)


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5 * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("maker,param_grads", [
    ("bwd2", False), ("bwd2", True), ("bwd", False), ("bwd", True)])
def test_embsh_twins_match_jax_kernels(maker, param_grads):
    """The emb/sh plain twins against the Pallas kernels they stand for, on
    k-major inputs: the forward against ``make_fused_conv_fwd(embed=None)``
    (B4), the backward against ``make_fused_conv_bwd2(embed=None)`` (B4
    bwd, and B4′ with ``param_grads``) or ``make_fused_conv_bwd`` (B5).
    Padded slots (zero emb rows) included: their demb is not zero, their
    dxg and dsh are."""
    (jconv, jmlp, _), (conv, mlp, _) = _specs("XPLOR")
    p = _problem(seed=4)
    ws = _weights(p["rng"], mlp.dims)
    ybar = (p["rng"].normal(size=(N, conv.irreps_mid.dim)) * 0.1).astype(np.float32)
    emb, sh = _emb_sh("XPLOR", p["vec"], p["coef"], p["mask"])
    pad = ~p["mask"].reshape(-1)
    assert (emb[pad] == 0).all() and sh[pad].abs().max() > 10.0

    def km(a):
        return jfc.to_k_major(jnp.asarray(a.numpy()).reshape(N, K, -1), A)

    def rows(a_km):
        return np.asarray(jfc.from_k_major(a_km, N, K, A)).reshape(N * K, -1)

    jws = tuple(jnp.asarray(w) for w in ws)
    xg = jnp.asarray(p["x"])[jfc.to_k_major(jnp.asarray(p["src"]), A)]
    make = jfc.make_fused_conv_bwd2 if maker == "bwd2" else jfc.make_fused_conv_bwd
    out_j = jfc.make_fused_conv_fwd(jconv, jmlp, A, K, interpret=True)(xg, km(emb), km(sh), jws)
    res_j = make(jconv, jmlp, A, K, param_grads=param_grads, interpret=True)(
        xg, km(emb), km(sh), jnp.asarray(ybar), jws)

    op = fc.conv_op(conv, mlp)
    # emb/sh mode: no spherical-harmonic tables, no dcoef columns
    assert op.embed is None and op.dims(N, K).n_sh == 0
    assert op.ws_layout["dc"] == op.ws_layout["dw"] + op.numel
    args = (op, torch.tensor(p["x"]), torch.tensor(p["src"]), emb, sh,
            [torch.tensor(w) for w in ws])
    _close(fc.fused_conv_fwd_embsh_plain(*args), out_j, "out")
    got = fc.fused_conv_bwd_embsh_plain(*args, torch.tensor(ybar), param_grads=param_grads)
    for name, a, b in zip(("dxg", "demb", "dsh"), got, res_j):
        _close(a, rows(b), name)
    if param_grads:
        for i, (a, b) in enumerate(zip(got[3], res_j[3])):
            _close(a, b, f"dW{i + 1}")
    demb = got[1].numpy()
    assert np.abs(demb[pad]).max() > 1e-3
    assert (got[0].numpy()[pad] == 0).all() and (got[2].numpy()[pad] == 0).all()


def _embsh_problem(kind, seed):
    (jconv, jmlp, _), (conv, mlp, _) = _specs(kind)
    p = _problem(seed=seed)
    ws = _weights(p["rng"], mlp.dims)
    src, mir = jnp.asarray(p["src"]), jnp.asarray(p["mir"])

    def jconv_f(ws_, x, emb, sh):
        return jfc.fused_conv_apply(jconv, jmlp, {"w": list(ws_)}, x, emb.reshape(N, K, -1),
                                    sh.reshape(N, K, -1), src, mir, block_atoms=A,
                                    param_grads=True)

    def tconv_f(ws_, x, emb, sh):
        return fc.fused_conv_apply(conv, mlp, {"w": ws_}, x, emb.view(N, K, -1),
                                   sh.view(N, K, -1), torch.tensor(p["src"]).long(),
                                   torch.tensor(p["mir"]).long())

    return p, ws, jconv_f, tconv_f


@pytest.mark.parametrize("kind", ["XPLOR", "poly_cut"])
def test_fused_conv_apply_matches_jax(kind):
    """The emb/sh op through its autograd Function (plain twins on the
    CPU, mirror gather) against JAX's ``fused_conv_apply`` with
    ``param_grads=True``: output, dx, demb, dsh and the MLP-weight
    gradients."""
    p, ws, jconv_f, tconv_f = _embsh_problem(kind, seed=5)
    ybar = (p["rng"].normal(size=(N, _specs(kind)[1][0].irreps_mid.dim)) * 0.1).astype(np.float32)
    emb_j, sh_j = _j_emb_sh(kind, jnp.asarray(p["vec"]), jnp.asarray(p["coef"]), p["mask"])
    out_j, pull = jax.vjp(jconv_f, tuple(jnp.asarray(w) for w in ws), jnp.asarray(p["x"]),
                          emb_j, sh_j)
    jdws, jdx, jdemb, jdsh = pull(jnp.asarray(ybar))

    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    x = torch.tensor(p["x"], requires_grad=True)
    emb, sh = (t.detach().requires_grad_(True)
               for t in _emb_sh(kind, p["vec"], p["coef"], p["mask"]))
    out = tconv_f(tw, x, emb, sh)
    g = torch.autograd.grad(out, (x, emb, sh, *tw), torch.tensor(ybar))
    _close(out.detach(), out_j, "out")
    for name, a, b in [("dx", g[0], jdx), ("demb", g[1], jdemb), ("dsh", g[2], jdsh)] + [
            (f"dW{i + 1}", a, b) for i, (a, b) in enumerate(zip(g[3:], jdws))]:
        _close(a, b, name)


@pytest.mark.parametrize("kind", ["XPLOR", "poly_cut"])
def test_embsh_force_loss_grad_of_grad_matches_jax(kind):
    """The gradient of a force-like loss ``sum (dE/dvec)^2`` in emb/sh mode
    (emb and sh computed from the edge vectors in each framework, the conv
    through ``fused_conv_apply``) with respect to the MLP weights, the
    Bessel coefficients and x, against JAX's grad-of-grad through
    ``_make_bwd_op``."""
    p, ws, jconv_f, tconv_f = _embsh_problem(kind, seed=6)
    R = (p["rng"].normal(size=(N, _specs(kind)[1][0].irreps_mid.dim)) * 0.1).astype(np.float32)

    def jloss(ws_, coef, x, vec):
        def energy(v):
            out = jconv_f(ws_, x, *_j_emb_sh(kind, v, coef, p["mask"]))
            return jnp.sum(out * R) + 0.1 * jnp.sum(out * out)
        return jnp.sum(jax.grad(energy)(vec) ** 2)

    gg_j = jax.grad(jloss, argnums=(0, 1, 2))(
        tuple(jnp.asarray(w) for w in ws), jnp.asarray(p["coef"]), jnp.asarray(p["x"]),
        jnp.asarray(p["vec"]))

    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    x = torch.tensor(p["x"], requires_grad=True)
    coef = torch.tensor(p["coef"], requires_grad=True)
    vec = torch.tensor(p["vec"], requires_grad=True)
    out = tconv_f(tw, x, *_emb_sh(kind, vec, coef, p["mask"]))
    energy = (out * torch.tensor(R)).sum() + 0.1 * (out * out).sum()
    (dvec,) = torch.autograd.grad(energy, vec, create_graph=True)
    assert dvec.requires_grad
    got = torch.autograd.grad((dvec ** 2).sum(), (*tw, coef, x))
    for name, a, b in [(f"W{i + 1}", a, b) for i, (a, b) in enumerate(zip(got[:3], gg_j[0]))] + [
            ("coef", got[3], gg_j[1]), ("x", got[4], gg_j[2])]:
        assert np.abs(np.asarray(b)).max() > 0, name
        _close(a, b, name)
