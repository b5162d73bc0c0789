"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: without a CUDA card every test here skips. This file imports
nothing of JAX, so it also runs where only PyTorch is installed
(``--noconftest`` skips the repo's conftest files, which import JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu

chip_smoke.py runs the same comparison at SevenNet-0 shapes. Tolerance:
1e-5 of the largest plain value, fp32 on both sides with sums in another
order (``dvec`` reaches tens and sums hundreds of products per edge). The
emb/sh kernels (B4, B4′, and B6 through ``dense_conv_pallas``) take what a
model with unnormalized spherical harmonics feeds them.
"""

import numpy as np
import pytest
import torch

from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.data.graph import dense_graph_from_arrays
from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy
from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
from sevennet_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.ops import fused_conv as fc
from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec
from sevennet_tpu_torch.ops.pallas_conv import dense_conv_pallas
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("kind,arg", [("XPLOR", 2.5), ("poly_cut", 6.0)])
def test_kernels_match_plain(cuda, kind, arg):
    x_ir, f_ir = Irreps("8x0e+8x1e+8x2e"), Irreps("1x0e+1x1e+1x2e")
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    mlp = ScalarMLPSpec((8, 16, 16, conv.weight_numel))
    op = fc.conv_op(conv, mlp, fc.EdgeEmbedSpec(8, 3.0, kind, arg, 2))
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, 7.0, (40, 3))
    dst, src, shift = neighbor_list_numpy(pos, 3.0)
    g = dense_graph_from_arrays(pos, np.zeros(40), src, dst, shift, device=cuda)
    N, K = g.n_atoms_cap, g.dense_k
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T,
                      torch.tensor([[6.0], [0.0], [0.0]], device=cuda)).contiguous()
    ws = [torch.tensor(rng.normal(size=(a, b)), dtype=torch.float32, device=cuda)
          for a, b in zip(mlp.dims[:-1], mlp.dims[1:])]
    args = (op, torch.tensor(rng.normal(size=(N, op.dim_x)), dtype=torch.float32, device=cuda),
            g.edge_src.view(N, K).to(torch.int32), vec,
            torch.linspace(1.0, 8.0, 8, device=cuda), ws)
    ybar = torch.tensor(rng.normal(size=(N, op.dim_mid)), dtype=torch.float32, device=cuda)
    n0, b0 = fc.fused_conv_fwd.launches, fc.fused_conv_bwd.launches
    out = fc.fused_conv_fwd(*args)
    dxg, dvec = fc.fused_conv_bwd(*args, ybar)
    torch.cuda.synchronize()
    assert (fc.fused_conv_fwd.launches, fc.fused_conv_bwd.launches) == (n0 + 1, b0 + 1)
    dxg_p, dvec_p = fc.fused_conv_bwd_plain(*args, ybar)
    for got, want in ((out, fc.fused_conv_fwd_plain(*args)), (dxg, dxg_p), (dvec, dvec_p)):
        scale = float(want.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-5 * scale)
    # slots past the cutoff get exact zeros
    pad = ~g.edge_mask
    assert (dxg[pad] == 0).all() and (dvec[:, pad] == 0).all()


@pytest.mark.parametrize("normalize_sph", [True, False])
def test_calculator_kernels_match_plain(cuda, normalize_sph):
    spec = build_model_spec({"channel": 8, "lmax": 2, "num_convolution_layer": 3,
                             "cutoff": 4.0, "chemical_species": ["Hf", "O"],
                             "_normalize_sph": normalize_sph})
    params = params_from_numpy(spec, random_params(spec, 3))
    fwd = fc.fused_conv_fwd if normalize_sph else fc.fused_conv_fwd_embsh
    rng = np.random.default_rng(1)
    cell = np.eye(3) * 6.0
    at = AtomsLite(positions=rng.uniform(0, 6.0, (24, 3)), numbers=[72] * 8 + [8] * 16,
                   cell=cell, pbc=True)
    n0 = fwd.launches
    res = SevenNetCalculator(spec, params).calculate(at)
    assert fwd.launches == n0 + len(spec.layers)
    ref = SevenNetCalculator(spec, params, plain=True).calculate(at)
    assert abs(res["energy"] - ref["energy"]) <= 1e-5 * abs(ref["energy"])
    np.testing.assert_allclose(res["forces"], ref["forces"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(res["stress"], ref["stress"], atol=1e-6, rtol=0)


def _small_problem(cuda, kind, arg, seed=0):
    x_ir, f_ir = Irreps("8x0e+8x1e+8x2e"), Irreps("1x0e+1x1e+1x2e")
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    mlp = ScalarMLPSpec((8, 16, 16, conv.weight_numel))
    embed = fc.EdgeEmbedSpec(8, 3.0, kind, arg, 2)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 7.0, (40, 3))
    dst, src, shift = neighbor_list_numpy(pos, 3.0)
    g = dense_graph_from_arrays(pos, np.zeros(40), src, dst, shift, device=cuda)
    N, K = g.n_atoms_cap, g.dense_k
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T,
                      torch.tensor([[6.0], [0.0], [0.0]], device=cuda)).contiguous()
    ws = [torch.tensor(rng.normal(size=(a, b)), dtype=torch.float32, device=cuda)
          for a, b in zip(mlp.dims[:-1], mlp.dims[1:])]
    x = torch.tensor(rng.normal(size=(N, conv.irreps_x.dim)), dtype=torch.float32, device=cuda)
    return dict(conv=conv, mlp=mlp, embed=embed, g=g, N=N, K=K, vec=vec, ws=ws, x=x,
                coef=torch.linspace(1.0, 8.0, 8, device=cuda), rng=rng)


@pytest.mark.parametrize("kind,arg", [("XPLOR", 2.5), ("poly_cut", 6.0)])
def test_bwd_pg_kernel_matches_plain(cuda, kind, arg):
    """B2′ (first pass and reduction) against its plain twin: dxg, dvec,
    the MLP-weight gradients and dcoef, 1e-5 of the largest plain value."""
    p = _small_problem(cuda, kind, arg)
    op = fc.conv_op(p["conv"], p["mlp"], p["embed"])
    N, K = p["N"], p["K"]
    args = (op, p["x"], p["g"].edge_src.view(N, K).to(torch.int32), p["vec"], p["coef"], p["ws"])
    ybar = torch.tensor(p["rng"].normal(size=(N, op.dim_mid)), dtype=torch.float32, device=cuda)
    n0, r0 = fc.fused_conv_bwd_pg_records.launches, fc.param_grad_reduce.launches
    dxg, dvec, dws, dcoef = fc.fused_conv_bwd(*args, ybar, param_grads=True)
    torch.cuda.synchronize()
    assert (fc.fused_conv_bwd_pg_records.launches, fc.param_grad_reduce.launches) == (n0 + 1, r0 + 1)
    dxg_p, dvec_p, dws_p, dcoef_p = fc.fused_conv_bwd_plain(*args, ybar, param_grads=True)
    for got, want in zip([dxg, dvec, *dws, dcoef], [dxg_p, dvec_p, *dws_p, dcoef_p]):
        scale = float(want.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-5 * scale)
    pad = ~p["g"].edge_mask
    assert (dxg[pad] == 0).all() and (dvec[:, pad] == 0).all()


def test_force_loss_grad_kernels_match_plain(cuda):
    """Grad of a force-like loss through the kernels' Function (B1, B2′,
    plain second-order rule) against the plain path, on the card."""
    p = _small_problem(cuda, "XPLOR", 2.5, seed=1)
    N, K = p["N"], p["K"]
    R = torch.tensor(p["rng"].normal(size=(N, p["conv"].irreps_mid.dim)), dtype=torch.float32,
                     device=cuda) * 0.1
    src, mir = p["g"].edge_src.view(N, K), p["g"].edge_mir.view(N, K)
    grads = {}
    for plain in (False, True):
        ws = [w.clone().requires_grad_(True) for w in p["ws"]]
        coef = p["coef"].clone().requires_grad_(True)
        vec = p["vec"].clone().requires_grad_(True)
        out = fc.fused_conv_apply_vec(p["conv"], p["mlp"], {"w": ws}, coef, p["embed"], p["x"],
                                      vec, src, mir, plain=plain)
        energy = (out * R).sum() + 0.1 * (out * out).sum()
        (dvec,) = torch.autograd.grad(energy, vec, create_graph=True)
        grads[plain] = torch.autograd.grad((dvec ** 2).sum() + energy, (*ws, coef))
    for got, want in zip(grads[False], grads[True]):
        scale = float(want.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("normalize_sph", [True, False])
def test_train_step_kernels_match_plain(cuda, normalize_sph):
    """One train step through the kernels (B1 and B2′, or with unnormalized
    spherical harmonics B4 and B4′; the backward twice per layer: forces
    with create_graph, then the loss's backward) against the plain path's
    loss and gradients at the same weights."""
    from sevennet_tpu_torch.data.dataset import atoms_to_graph
    from sevennet_tpu_torch.data.graph import batch_graphs
    from sevennet_tpu_torch.train import Trainer

    spec = build_model_spec({"channel": 8, "lmax": 2, "num_convolution_layer": 3,
                             "cutoff": 4.0, "chemical_species": ["Hf", "O"],
                             "_normalize_sph": normalize_sph})
    params = params_from_numpy(spec, random_params(spec, 5))
    rng = np.random.default_rng(2)
    graphs = []
    for _ in range(2):
        at = AtomsLite(positions=rng.uniform(0, 6.0, (16, 3)), numbers=[72] * 6 + [8] * 10,
                       cell=np.eye(3) * 6.0, pbc=True, energy=-50.0,
                       forces=rng.normal(size=(16, 3)), stress=rng.normal(size=6) * 1e-2)
        graphs.append(atoms_to_graph(at, 4.0, spec.z_to_type))
    b = batch_graphs(graphs, n_atoms_cap=40, n_graphs_cap=3, device=cuda)
    kern = Trainer(spec, params)
    plain = Trainer(spec, params, plain=True)
    total_p, _, _ = plain._loss_and_metrics(kern.params, b)
    g_plain = torch.autograd.grad(total_p, kern.trainable)
    kernels = ((fc.fused_conv_fwd, fc.fused_conv_bwd, fc.fused_conv_bwd_pg_records) if normalize_sph
               else (fc.fused_conv_fwd_embsh, fc.fused_conv_bwd_embsh,
                     fc.fused_conv_bwd_embsh_pg_records))
    n0 = {f: f.launches for f in kernels}
    losses, _ = kern.train_step(b)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in n0.items()] == [3, 0, 6]
    assert abs(losses["total"].item() - total_p.item()) <= 1e-5 * abs(total_p.item())
    for p, gp in zip(kern.trainable, g_plain):
        np.testing.assert_allclose(p.grad.cpu(), gp.cpu(), rtol=0,
                                   atol=1e-4 * float(gp.abs().max()))


def test_embsh_kernels_match_plain(cuda):
    """B4 fwd, B4 bwd, B4′ (records pass and reduction) and B6 against their
    plain twins on the emb/sh inputs of a model with unnormalized spherical
    harmonics (Bessel embedding zero on padded slots, spherical harmonics of
    the raw edge vectors); padded slots get zero dxg and dsh but the same
    nonzero demb as the twin's."""
    from sevennet_tpu_torch.model.build import build_model_spec as build
    from sevennet_tpu_torch.model.model import edge_emb_sh

    p = _small_problem(cuda, "XPLOR", 2.5, seed=2)
    op = fc.conv_op(p["conv"], p["mlp"])
    N, K, g = p["N"], p["K"], p["g"]
    spec = build({"cutoff": 3.0, "lmax": 2, "chemical_species": ["O"], "_normalize_sph": False,
                  "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 2.5}})
    emb, sh = edge_emb_sh(spec, p["coef"], p["vec"], g.edge_mask)
    src = g.edge_src.view(N, K).to(torch.int32)
    args = (op, p["x"], src, emb.contiguous(), sh.contiguous(), p["ws"])
    ybar = torch.tensor(p["rng"].normal(size=(N, op.dim_mid)), dtype=torch.float32, device=cuda)
    counters = (fc.fused_conv_fwd_embsh, fc.fused_conv_bwd_embsh,
                fc.fused_conv_bwd_embsh_pg_records, fc.param_grad_reduce, dense_conv_pallas)
    n0 = [f.launches for f in counters]
    out = fc.fused_conv_fwd_embsh(*args)
    bwd = fc.fused_conv_bwd_embsh(*args, ybar)
    pg = fc.fused_conv_bwd_embsh(*args, ybar, param_grads=True)
    b6 = dense_conv_pallas(p["conv"], p["mlp"], p["x"], emb.view(N, K, -1), sh.view(N, K, -1),
                           src, p["ws"])
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, n0)] == [1, 1, 1, 1, 1]
    out_p = fc.fused_conv_fwd_embsh_plain(*args)
    bwd_p = fc.fused_conv_bwd_embsh_plain(*args, ybar, param_grads=True)
    pairs = [(out, out_p), (b6, out_p)] + list(zip(bwd, bwd_p[:3])) + list(zip(pg[:3], bwd_p[:3]))
    pairs += list(zip(pg[3], bwd_p[3]))
    for got, want in pairs:
        scale = float(want.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-5 * scale)
    pad = ~g.edge_mask
    assert (bwd[0][pad] == 0).all() and (bwd[2][pad] == 0).all()
    assert float(bwd[1][pad].abs().max()) > 0


@pytest.mark.parametrize("j,slot", [(2, 2), (0, 3)], ids=["interior", "wrap"])
def test_bwd_slot_kernel_matches_plain(cuda, j, slot):
    """B3 (``fused_conv_bwd_slot``) on one chunk of 8 rows against its plain
    twin: the slot's dxg and the chunk's dvec within 1e-5 of the largest
    plain value, the buffer's other slots bitwise unchanged (pre-filled with
    a sentinel), zeros for the slots past the cutoff inside the slot; then
    the ring backward over every chunk, and the chunked scatter backward
    (B2 per chunk and ``index_add_``), against the unchunked conv."""
    p = _small_problem(cuda, "XPLOR", 2.5, seed=2)
    op = fc.conv_op(p["conv"], p["mlp"], p["embed"])
    N, K, RC, S = p["N"], p["K"], 8, 5
    src = p["g"].edge_src.view(N, K).to(torch.int32)
    ybar = torch.tensor(p["rng"].normal(size=(N, op.dim_mid)), dtype=torch.float32, device=cuda)
    src_c, vec_c, yb = fc._chunk(RC, K, j, src, p["vec"], ybar)
    buf = torch.full((S * RC * K, op.dim_x), -7.25e30, device=cuda)
    before = buf.clone()
    n0 = fc.fused_conv_bwd_slot.launches
    dvec = fc.fused_conv_bwd_slot(op, p["x"], src_c, vec_c, p["coef"], p["ws"], yb, buf, slot)
    torch.cuda.synchronize()
    assert fc.fused_conv_bwd_slot.launches == n0 + 1
    dxg_p, dvec_p = fc.fused_conv_bwd_plain(op, p["x"], src_c, vec_c, p["coef"], p["ws"], yb)
    rows = slice(slot * RC * K, (slot + 1) * RC * K)
    for got, want in ((buf[rows], dxg_p), (dvec, dvec_p)):
        scale = float(want.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-5 * scale)
    other = torch.ones(S * RC * K, dtype=torch.bool, device=cuda)
    other[rows] = False
    assert torch.equal(buf[other], before[other])
    pad = ~p["g"].edge_mask.view(N, K)[j * RC:(j + 1) * RC].reshape(-1)
    assert (buf[rows][pad] == 0).all() and (dvec[:, pad] == 0).all()

    # the ring backward (W 2 over N // 8 chunks) against the unchunked conv
    n = (N // RC) * RC
    x = p["x"][:n].clone().requires_grad_(True)
    vec = p["vec"][:, : n * K].contiguous().requires_grad_(True)
    src_n, mask_n = src[:n], p["g"].edge_mask.view(N, K)[:n]
    shift = p["g"].edge_shift.view(N, K, 3)[:n]
    keep = mask_n & (src_n < n)
    mir = fc.mirror_map(src_n, shift, keep)
    sentinel = torch.tensor([[6.0], [0.0], [0.0]], device=cuda)
    outs = []
    for rc, ring in ((0, 0), (RC, 2), (RC, 0)):
        vec_k = torch.where(keep.reshape(-1)[None], vec, sentinel)
        out = fc.fused_conv_apply_vec(p["conv"], p["mlp"], {"w": p["ws"]}, p["coef"],
                                      p["embed"], x, vec_k, src_n.long(), mir,
                                      row_chunk=rc, ring=ring)
        outs.append([t.detach() for t in (out, *torch.autograd.grad(out, (x, vec), ybar[:n]))])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("hidden", [(20, 24), (20, 72)], ids=["h2_24", "h2_72"])
def test_odd_widths_ragged_tiles_match_plain(cuda, hidden):
    """Widths that are not multiples of the tensor-core tile (dim_x 53,
    numel 81, radial MLP (8, 20, h2, 81); h2 72 takes two k-groups in the
    W3 forward product and two passes of the backward one) and ragged
    tiles (K 22: a full tile of 16 slots and one of 6; rows of 4 to 22
    edges inside the cutoff), every instance of both kernels against its
    plain twin, 1e-5 of the largest plain value: B1, B2, B2′ (both passes),
    B3, and in emb/sh mode B4 fwd, B4 bwd, B4′ (both passes) and B6."""
    x_ir, f_ir = Irreps("3x0e+5x1e+7x2e"), Irreps("1x0e+1x1e+1x2e")
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    mlp = ScalarMLPSpec((8, *hidden, conv.weight_numel))
    embed = fc.EdgeEmbedSpec(8, 3.4, "XPLOR", 3.0, 2)
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.0, 7.0, (40, 3))
    dst, src, shift = neighbor_list_numpy(pos, 3.4)
    g = dense_graph_from_arrays(pos, np.zeros(40), src, dst, shift, device=cuda)
    N, K = g.n_atoms_cap, g.dense_k
    assert (K, conv.weight_numel, x_ir.dim) == (22, 81, 53)
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T,
                      torch.tensor([[7.0], [0.0], [0.0]], device=cuda)).contiguous()

    def rnd(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)

    ws = [rnd(a, b) for a, b in zip(mlp.dims[:-1], mlp.dims[1:])]
    x, coef = rnd(N, x_ir.dim), torch.linspace(1.0, 8.0, 8, device=cuda)
    src_nk = g.edge_src.view(N, K).to(torch.int32)
    op, op_e = fc.conv_op(conv, mlp, embed), fc.conv_op(conv, mlp)
    ybar = rnd(N, op.dim_mid)
    args = (op, x, src_nk, vec, coef, ws)
    pairs = [(fc.fused_conv_fwd(*args), fc.fused_conv_fwd_plain(*args))]
    pairs += list(zip(fc.fused_conv_bwd(*args, ybar), fc.fused_conv_bwd_plain(*args, ybar)))
    got = fc.fused_conv_bwd(*args, ybar, param_grads=True)
    want = fc.fused_conv_bwd_plain(*args, ybar, param_grads=True)
    pairs += [(got[0], want[0]), (got[1], want[1]), (got[3], want[3])] + list(zip(got[2], want[2]))
    # B3: rows 8 .. 15 into slot 1 of a 3-slot buffer
    src_c, vec_c, yb = fc._chunk(8, K, 1, src_nk, vec, ybar)
    buf = torch.zeros((3 * 8 * K, op.dim_x), device=cuda)
    dvec_c = fc.fused_conv_bwd_slot(op, x, src_c, vec_c, coef, ws, yb, buf, 1)
    dxg_c, dvec_cp = fc.fused_conv_bwd_plain(op, x, src_c, vec_c, coef, ws, yb)
    pairs += [(buf[8 * K:16 * K], dxg_c), (dvec_c, dvec_cp)]
    # emb/sh mode on the same edges' embedding and spherical harmonics
    emb, sh = (t.contiguous() for t in fc.edge_embedding_plain(op, vec, coef))
    eargs = (op_e, x, src_nk, emb, sh, ws)
    out_p = fc.fused_conv_fwd_embsh_plain(*eargs)
    pairs += [(fc.fused_conv_fwd_embsh(*eargs), out_p),
              (dense_conv_pallas(conv, mlp, x, emb.view(N, K, -1), sh.view(N, K, -1), src_nk, ws),
               out_p)]
    want = fc.fused_conv_bwd_embsh_plain(*eargs, ybar, param_grads=True)
    pairs += list(zip(fc.fused_conv_bwd_embsh(*eargs, ybar), want[:3]))
    got = fc.fused_conv_bwd_embsh(*eargs, ybar, param_grads=True)
    pairs += list(zip(got[:3], want[:3])) + list(zip(got[3], want[3]))
    torch.cuda.synchronize()
    assert len(pairs) == 22
    for got, want in pairs:
        scale = float(want.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-5 * scale)
