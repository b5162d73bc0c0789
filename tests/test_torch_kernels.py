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
from sevennet_tpu_torch.model.presets import MF_OMPA, WIDE4_LAYER
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
    for other_path in outs[1:]:
        for got, want in zip(other_path, outs[0]):
            np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0,
                                       atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("j,slot", [(2, 2), (0, 3)], ids=["interior", "wrap"])
def test_bwd_embsh_slot_kernel_matches_plain(cuda, j, slot):
    """B4 bwd's slot entry (``fused_conv_bwd_embsh_slot``, the emb/sh ring's
    per-chunk kernel) on one chunk of 8 rows against its plain twin: the
    slot's dxg and the chunk's demb and dsh within 1e-5 of the largest plain
    value, the buffer's other slots bitwise unchanged (pre-filled with a
    sentinel); then the emb/sh ring backward (W 2) and the chunked scatter
    backward over every chunk against the unchunked conv."""
    from sevennet_tpu_torch.model.build import build_model_spec as build
    from sevennet_tpu_torch.model.model import edge_emb_sh

    p = _small_problem(cuda, "XPLOR", 2.5, seed=2)
    op = fc.conv_op(p["conv"], p["mlp"])
    N, K, RC, S = p["N"], p["K"], 8, 5
    spec = build({"cutoff": 3.0, "lmax": 2, "chemical_species": ["O"], "_normalize_sph": False,
                  "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 2.5}})
    emb, sh = (t.contiguous() for t in edge_emb_sh(spec, p["coef"], p["vec"], p["g"].edge_mask))
    src = p["g"].edge_src.view(N, K).to(torch.int32)
    ybar = torch.tensor(p["rng"].normal(size=(N, op.dim_mid)), dtype=torch.float32, device=cuda)
    rows = slice(j * RC * K, (j + 1) * RC * K)
    src_c, yb = src[j * RC:(j + 1) * RC], ybar[j * RC:(j + 1) * RC]
    buf = torch.full((S * RC * K, op.dim_x), -7.25e30, device=cuda)
    before = buf.clone()
    n0 = fc.fused_conv_bwd_embsh_slot.launches
    demb, dsh = fc.fused_conv_bwd_embsh_slot(op, p["x"], src_c, emb[rows], sh[rows], p["ws"], yb,
                                             buf, slot)
    torch.cuda.synchronize()
    assert fc.fused_conv_bwd_embsh_slot.launches == n0 + 1
    want = fc.fused_conv_bwd_embsh_plain(op, p["x"], src_c, emb[rows], sh[rows], p["ws"], yb)
    in_slot = slice(slot * RC * K, (slot + 1) * RC * K)
    for got, ref in zip((buf[in_slot], demb, dsh), want):
        scale = float(ref.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.cpu(), ref.cpu(), rtol=0, atol=1e-5 * scale)
    other = torch.ones(S * RC * K, dtype=torch.bool, device=cuda)
    other[in_slot] = False
    assert torch.equal(buf[other], before[other])

    n = (N // RC) * RC
    x = p["x"][:n].clone().requires_grad_(True)
    src_n, mask_n = src[:n], p["g"].edge_mask.view(N, K)[:n]
    keep = (mask_n & (src_n < n)).reshape(-1, 1)
    emb_n = (emb[: n * K] * keep).detach().requires_grad_(True)
    sh_n = sh[: n * K].detach().requires_grad_(True)
    mir = fc.mirror_map(src_n, p["g"].edge_shift.view(N, K, 3)[:n], keep.view(n, K))
    outs = []
    for rc, ring in ((0, 0), (RC, 2), (RC, 0)):  # W 2 of 5 chunks takes any order
        out = fc.fused_conv_apply(p["conv"], p["mlp"], {"w": p["ws"]}, x, emb_n.view(n, K, -1),
                                  sh_n.view(n, K, -1), src_n.long(), mir, row_chunk=rc, ring=ring)
        outs.append([t.detach() for t in (out, *torch.autograd.grad(out, (x, emb_n, sh_n),
                                                                    ybar[:n]))])
    for other_path in outs[1:]:
        for got, ref in zip(other_path, outs[0]):
            np.testing.assert_allclose(got.cpu(), ref.cpu(), rtol=0,
                                       atol=1e-5 * float(ref.abs().max()))


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


def _instances_match_plain(cuda, conv, mlp, embed, n_atoms, box, seed):
    """B1, B2, B2′ (both passes) and, on the same edges' embedding and
    spherical harmonics, B4 fwd, B4 bwd and B4′ against their plain twins
    on random atoms, 1e-5 of the largest plain value; returns the vec op."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (n_atoms, 3))
    dst, src, shift = neighbor_list_numpy(pos, embed.cutoff)
    g = dense_graph_from_arrays(pos, np.zeros(n_atoms), src, dst, shift, device=cuda)
    N, K = g.n_atoms_cap, g.dense_k
    sentinel = torch.tensor([[2.0 * embed.cutoff], [0.0], [0.0]], device=cuda)
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T, sentinel).contiguous()

    def rnd(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)

    ws = [rnd(a, b) for a, b in zip(mlp.dims[:-1], mlp.dims[1:])]
    x, coef = rnd(N, conv.irreps_x.dim), torch.linspace(1.0, 8.0, embed.n_basis, device=cuda)
    src_nk = g.edge_src.view(N, K).to(torch.int32)
    op, op_e = fc.conv_op(conv, mlp, embed), fc.conv_op(conv, mlp)
    ybar = rnd(N, op.dim_mid)
    args = (op, x, src_nk, vec, coef, ws)
    pairs = [(fc.fused_conv_fwd(*args), fc.fused_conv_fwd_plain(*args))]
    pairs += list(zip(fc.fused_conv_bwd(*args, ybar), fc.fused_conv_bwd_plain(*args, ybar)))
    got = fc.fused_conv_bwd(*args, ybar, param_grads=True)
    want = fc.fused_conv_bwd_plain(*args, ybar, param_grads=True)
    pairs += [(got[0], want[0]), (got[1], want[1]), (got[3], want[3])] + list(zip(got[2], want[2]))
    emb, sh = (t.contiguous() for t in fc.edge_embedding_plain(op, vec, coef))
    eargs = (op_e, x, src_nk, emb, sh, ws)
    pairs += [(fc.fused_conv_fwd_embsh(*eargs), fc.fused_conv_fwd_embsh_plain(*eargs))]
    want = fc.fused_conv_bwd_embsh_plain(*eargs, ybar, param_grads=True)
    pairs += list(zip(fc.fused_conv_bwd_embsh(*eargs, ybar), want[:3]))
    got = fc.fused_conv_bwd_embsh(*eargs, ybar, param_grads=True)
    pairs += list(zip(got[:3], want[:3])) + list(zip(got[3], want[3]))
    torch.cuda.synchronize()
    for got, want in pairs:
        scale = float(want.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-5 * scale)
    return op


def test_l3i5_layer_kernels_match_plain(cuda):
    """SevenNet-l3i5's middle-layer widths (bench.py:89-106: lmax 3,
    128x0e+64x1e+32x2e+32x3e, 1,760 uvu weights, poly cutoff p 6), whose
    per-edge weights the kernels form in several column blocks: every
    instance against its plain twin on 48 random atoms (about 30
    neighbours each)."""
    spec = build_model_spec({
        "lmax": 3, "channel": 128, "cutoff": 5.0, "is_parity": False,
        "num_convolution_layer": 5, "chemical_species": ["H", "O"],
        "irreps_manual": ["128x0e"] + ["128x0e+64x1e+32x2e+32x3e"] * 4 + ["128x0e"],
        "cutoff_function": {"cutoff_function_name": "poly_cut", "poly_cut_p_value": 6},
        "self_connection_type": "nequip", "weight_nn_hidden_neurons": [64, 64]})
    layer = spec.layers[1]
    embed = fc.EdgeEmbedSpec(8, 5.0, "poly_cut", 6.0, 3)
    op = _instances_match_plain(cuda, layer.conv, layer.radial_mlp, embed, 48, 8.0, 4)
    assert op.numel == 1760 and len(op.plan.blocks) > 1



@pytest.mark.parametrize("t", range(5))
def test_mf_ompa_layer_kernels_match_plain(cuda, t):
    """SevenNet-MF-ompa's layer widths (lmax 3 with parity, up to 1,408 x
    and 15,552 mid columns; cutoff 6, XPLOR from 5.5): every instance against
    its plain twin on 40 random atoms, and B3 on a chunk of them; layers 2
    and 3 run on a cluster of 2 CTAs a receiver row."""
    spec = build_model_spec(dict(MF_OMPA, chemical_species=["H", "O"]))
    layer = spec.layers[t]
    embed = fc.EdgeEmbedSpec(8, 6.0, "XPLOR", 5.5, 3)
    op = _instances_match_plain(cuda, layer.conv, layer.radial_mlp, embed, 40, 9.0, 5 + t)
    assert op.plan.cluster == (1, 1, 2, 2, 1)[t]
    _b3_chunk_matches_plain(cuda, op, t)


def test_wide4_layer_kernels_match_plain(cuda):
    """WIDE4_LAYER's second layer (mf-ompa's parity irreps at twice the
    channels, x of 2,560 columns), which runs on a cluster of 4 CTAs a
    receiver row: every instance against its plain twin on 40 random atoms,
    and B3 on a chunk of them."""
    spec = build_model_spec(dict(WIDE4_LAYER, chemical_species=["H", "O"]))
    layer = spec.layers[1]
    embed = fc.EdgeEmbedSpec(8, 6.0, "XPLOR", 5.5, 3)
    op = _instances_match_plain(cuda, layer.conv, layer.radial_mlp, embed, 40, 9.0, 11)
    assert op.plan.cluster == 4
    _b3_chunk_matches_plain(cuda, op, 4)


def _b3_chunk_matches_plain(cuda, op, seed):
    """B3 (B2 into a slot of a ring buffer) on an 8-row chunk of 40 random
    atoms against its plain twin, 1e-5 of max |plain|, the other slots
    untouched."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 9.0, (40, 3))
    dst, src, shift = neighbor_list_numpy(pos, 6.0)
    g = dense_graph_from_arrays(pos, np.zeros(40), src, dst, shift, device=cuda)
    N, K, RC = g.n_atoms_cap, g.dense_k, 8
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T,
                      torch.tensor([[12.0], [0.0], [0.0]], device=cuda)).contiguous()
    ws = [torch.tensor(rng.normal(size=(a, b)), dtype=torch.float32, device=cuda)
          for a, b in zip(op.mlp_spec.dims[:-1], op.mlp_spec.dims[1:])]
    x = torch.tensor(rng.normal(size=(N, op.dim_x)), dtype=torch.float32, device=cuda)
    ybar = torch.tensor(rng.normal(size=(N, op.dim_mid)), dtype=torch.float32, device=cuda)
    coef = torch.linspace(1.0, 8.0, 8, device=cuda)
    src_c = g.edge_src.view(N, K).to(torch.int32)[RC:2 * RC].contiguous()
    vec_c = vec[:, RC * K:2 * RC * K].contiguous()
    buf = torch.full((3 * RC * K, op.dim_x), -7.25, device=cuda)
    buf_p = buf.cpu()
    dv = fc.fused_conv_bwd_slot(op, x, src_c, vec_c, coef, ws, ybar[RC:2 * RC], buf, 1)
    dv_p = fc.fused_conv_bwd_slot_plain(op, x.cpu(), src_c.cpu(), vec_c.cpu(), coef.cpu(),
                                        [w.cpu() for w in ws], ybar[RC:2 * RC].cpu(), buf_p, 1)
    torch.cuda.synchronize()
    for got, want in ((dv.cpu(), dv_p), (buf.cpu(), buf_p)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


_SEVENNET0 = {  # bench.py:87-147
    "lmax": 2, "channel": 128, "cutoff": 5.0, "is_parity": False, "num_convolution_layer": 5,
    "irreps_manual": ["128x0e"] + ["128x0e+64x1e+32x2e"] * 4 + ["128x0e"],
    "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 4.5},
    "self_connection_type": "linear", "weight_nn_hidden_neurons": [64, 64],
    "chemical_species": ["H", "O"]}
_L3I5 = dict(_SEVENNET0, lmax=3,  # bench.py:89-106
             irreps_manual=["128x0e"] + ["128x0e+64x1e+32x2e+32x3e"] * 4 + ["128x0e"],
             cutoff_function={"cutoff_function_name": "poly_cut", "poly_cut_p_value": 6},
             self_connection_type="nequip")


def _reduce_op(which, vec_mode):
    """The conv op of a SevenNet-0 or l3i5 layer (``("s0", t)``, ``("l3i5",
    t)``), or of the odd widths (``("odd", hidden)``: dim_x 53, 81 uvu
    weights, radial MLP (8, *hidden, 81))."""
    kind, arg = which
    if kind == "odd":
        x_ir, f_ir = Irreps("3x0e+5x1e+7x2e"), Irreps("1x0e+1x1e+1x2e")
        conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
        embed = fc.EdgeEmbedSpec(8, 3.4, "XPLOR", 3.0, 2) if vec_mode else None
        return fc.conv_op(conv, ScalarMLPSpec((8, *arg, conv.weight_numel)), embed)
    from sevennet_tpu_torch.model.model import edge_embed_spec

    spec = build_model_spec(_SEVENNET0 if kind == "s0" else _L3I5)
    layer = spec.layers[arg]
    return fc.conv_op(layer.conv, layer.radial_mlp,
                      edge_embed_spec(spec, layer) if vec_mode else None)


@pytest.mark.parametrize("which,vec_mode,rows,case", [
    (("s0", 0), True, 3_001, "nan"),          # d_out 384
    (("s0", 1), True, 10_007, "nan"),         # d_out 960, rows not a multiple of the chunk
    (("s0", 4), False, 50, "nan"),            # d_out 224, below one chunk
    (("l3i5", 1), True, 2_117, "nan"),        # d_out 1,760
    (("odd", (20, 24)), True, 880, "nan"),    # d_out 81, dc off the 4-float grid
    (("odd", (21, 27)), True, 1_000, "nan"),  # h1, dz1 and dc off the 4-float grid
    (("odd", (21, 27)), False, 500, "all_invalid"),
    (("odd", (21, 27)), True, 700, "misaligned"),  # the workspace 4 bytes off: refused
], ids=["s0_layer0", "s0_layers1-3", "s0_layer4_one_chunk", "l3i5_layers1-3", "odd_20_24",
        "odd_21_27", "all_invalid", "misaligned"])
def test_param_grad_reduce_matches_plain(cuda, which, vec_mode, rows, case):
    """The reduction kernel (``csrc/pg_reduce.cu``) on random records
    against its plain version, 1e-5 of the largest plain value: d_in 8 and
    64, d_out 224, 384, 960, 1,760 and 81, record fields on and off the
    4-float grid, one chunk and a ragged last chunk; invalid records hold
    NaN (all of them invalid: exact zeros). Two calls give the same bits,
    and each call counts one launch. A workspace that does not start on a
    16-byte boundary (the kernel's bulk copies move whole 16 bytes) is
    refused, with no launch."""
    op = _reduce_op(which, vec_mode)
    stride = op.ws_layout["stride"]
    rng = np.random.default_rng(rows)
    records = rng.normal(size=(rows, stride)).astype(np.float32)
    valid = (rng.uniform(size=rows) < 0.9).astype(np.uint8)
    if case == "all_invalid":
        valid[:] = 0
    records[valid == 0] = np.nan
    if case == "misaligned":
        buf = torch.empty(rows * stride + 1, device=cuda)
        work = buf[1:].view(rows, stride)
        work.copy_(torch.from_numpy(records))
        assert work.is_contiguous() and work.data_ptr() % 16 == 4
        n0 = fc.param_grad_reduce.launches
        with pytest.raises(ValueError, match="16-byte"):
            fc.param_grad_reduce(op, work, torch.from_numpy(valid).to(cuda), rows, 1)
        assert fc.param_grad_reduce.launches == n0
        return
    else:
        work = torch.from_numpy(records).to(cuda)
    valid = torch.from_numpy(valid).to(cuda)
    n0 = fc.param_grad_reduce.launches
    dws, dcoef = fc.param_grad_reduce(op, work, valid, rows, 1)
    dws2, dcoef2 = fc.param_grad_reduce(op, work, valid, rows, 1)
    torch.cuda.synchronize()
    assert fc.param_grad_reduce.launches == n0 + 2
    dws_p, dcoef_p = fc.param_grad_reduce_plain(op, work, valid)
    got, again = [*dws, dcoef], [*dws2, dcoef2]
    want = [*dws_p, dcoef_p]
    assert (dcoef is None) == (not vec_mode)
    for g, g2, w in zip(got, again, want):
        if w is None:
            continue
        assert g.shape == w.shape and torch.equal(g, g2)
        scale = float(w.abs().max())
        if case == "all_invalid":
            assert scale == 0 and (g == 0).all()
            continue
        assert scale > 0
        np.testing.assert_allclose(g.cpu(), w.cpu(), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("hidden", [(), (16,), (16, 16, 16)], ids=["depth0", "depth1", "depth3"])
def test_mlp_depth_kernels_match_plain(cuda, hidden):
    """Radial MLPs of no, one and three hidden layers: every instance against
    its plain twin (the kernels walk the hidden layers in a loop; with none,
    W3 reads the embedding)."""
    x_ir, f_ir = Irreps("8x0e+8x1e+8x2e"), Irreps("1x0e+1x1e+1x2e")
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    mlp = ScalarMLPSpec((8, *hidden, conv.weight_numel))
    _instances_match_plain(cuda, conv, mlp, fc.EdgeEmbedSpec(8, 3.0, "XPLOR", 2.5, 2), 40, 7.0, 5)


@pytest.mark.parametrize("chain", [False, True], ids=["rate", "chain"])
@pytest.mark.parametrize("variant", ["ffma", "tf32", "3xtf32", "3xtf32_presplit", "wgmma_tf32",
                                     "bf16"])
def test_probe_mm_matches_plain(cuda, variant, chain):
    """The matmul-rate probe's every variant, both contracts (r2_pallas_mm's
    scaled and r2_pallas_fma's carried products), at ragged shapes, two with
    k chunked (70 x 130 x 40 with copies; 200 x 300 x 130, whose k-steps the
    rate contract halves between the warpgroups at an odd step, with
    copies), two with many copies (130 x 72 x 100, where the chain's second
    warpgroup skips the last row block; 96 x 200 x 72, four chunks), and at
    every shape of its contract's TPU script (bf16: its one), against the
    plain loop (mm_rate.PROBE_TOL). Each case twice: into an output the
    wrapper allocates and into a preallocated one filled with NaN."""
    from sevennet_tpu_torch.probes import mm_rate as mr

    rng = np.random.default_rng(6)
    dtype = torch.bfloat16 if variant == "bf16" else torch.float32
    s = torch.full((1, 1), 0.0 if variant == "bf16" else 1e-3, device=cuda)
    cases = [(100, 64, 70, 1), (70, 130, 40, 3), (185, 9, 33, 1), (200, 300, 130, 2),
             (130, 72, 100, 70), (96, 200, 72, 100)]
    cases += [(m, k, n, 1) for m, k, n in mr.shapes(variant, chain)]
    for m, k, n, copies in cases:
        a = torch.tensor(rng.normal(size=(m, k)), device=cuda).to(dtype)
        b = torch.tensor(rng.normal(size=(k, n)), device=cuda).to(dtype)
        fn = mr.mm_chain if chain else mr.mm_rate
        extra = () if chain else (s,)
        want = fn(a, b, *extra, variant=variant, copies=copies, plain=True)
        out = torch.full(want.shape, float("nan"), device=cuda)
        n0 = fn.launches
        got_new = fn(a, b, *extra, variant=variant, copies=copies)
        got = fn(a, b, *extra, variant=variant, copies=copies, out=out)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 2 and got is out
        for g in (got_new, got):
            assert g.shape == want.shape
            np.testing.assert_allclose(g.cpu(), want.cpu(), rtol=0,
                                       atol=mr.PROBE_TOL[variant] * float(want.abs().max()))


@pytest.mark.parametrize("variant", ["ffma", "tf32", "3xtf32", "3xtf32_presplit", "wgmma_tf32",
                                     "bf16"])
def test_probe_mm_rate_where_a_factor_is_zero(cuda, variant):
    """The rate contract at s -0.125, where product 8's factor 1 + s i is 0
    and the later ones negative, and at REP 0 (no products: zeros): every
    variant finite and within mm_rate.PROBE_TOL of the plain loop, at a
    ragged shape with k chunked and copies and at the scripts' first
    shape."""
    from sevennet_tpu_torch.probes import mm_rate as mr

    rng = np.random.default_rng(10)
    dtype = torch.bfloat16 if variant == "bf16" else torch.float32
    s = torch.full((1, 1), -0.125, device=cuda)
    for (m, k, n, copies), rep in (((70, 130, 40, 3), mr.REP), ((1024, 64, 960, 1), mr.REP),
                                   ((100, 64, 70, 2), 0)):
        a = torch.tensor(rng.normal(size=(m, k)), device=cuda).to(dtype)
        b = torch.tensor(rng.normal(size=(k, n)), device=cuda).to(dtype)
        want = mr.mm_rate(a, b, s, variant=variant, rep=rep, copies=copies, plain=True)
        got = mr.mm_rate(a, b, s, variant=variant, rep=rep, copies=copies)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0,
                                   atol=mr.PROBE_TOL[variant] * float(want.abs().max()))


def test_batched_dot_matches_plain(cuda):
    """The batched small products (SevenNet-0's three path groups at K 72)
    on 300 atoms, rep 1 and 3, against torch.bmm, 1e-5 of max |plain|."""
    from sevennet_tpu_torch.probes import batched_dot as bd

    rng = np.random.default_rng(7)
    Ss = [torch.tensor(rng.normal(size=(300, d3, kk)) * 0.1, dtype=torch.float32, device=cuda)
          for d3, kk, _ in bd.GROUPS]
    XWs = [torch.tensor(rng.normal(size=(300, kk, mul)) * 0.1, dtype=torch.float32, device=cuda)
           for _, kk, mul in bd.GROUPS]
    want = bd.batched_dot(Ss, XWs, plain=True)
    for rep in (1, 3):
        n0 = bd.batched_dot.launches
        got = bd.batched_dot(Ss, XWs, rep=rep)
        torch.cuda.synchronize()
        assert bd.batched_dot.launches == n0 + 1
        for y, w in zip(got, want):
            np.testing.assert_allclose(y.cpu(), w.cpu(), rtol=0, atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("groups", [((5, 8, 8), (5, 40, 24), (22, 152, 24)),
                                    ((9, 40, 8), (5, 8, 24), (20, 80, 64))],
                         ids=["short_chunks", "long_chunks"])
def test_batched_dot_ragged_matches_plain(cuda, groups):
    """The batched dot at shapes off the script's: N below the card's SM
    count (CTAs with no atom left) and just above it (a CTA with two), d3 5
    and 9, K d1 short of a 72-row chunk (8, 40) and past one (80, 152: a
    partial last chunk), mul 8 and 24 (a column group partly empty), rep 1
    and 3, against torch.bmm, 1e-5 of max |plain|."""
    from sevennet_tpu_torch.probes import batched_dot as bd

    rng = np.random.default_rng(11)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n in (n_sm - 7, n_sm + 1):
        Ss = [torch.tensor(rng.normal(size=(n, d3, kk)), dtype=torch.float32, device=cuda)
              for d3, kk, _ in groups]
        XWs = [torch.tensor(rng.normal(size=(n, kk, mul)), dtype=torch.float32, device=cuda)
               for _, kk, mul in groups]
        want = bd.batched_dot(Ss, XWs, plain=True)
        for rep in (1, 3):
            n0 = bd.batched_dot.launches
            got = bd.batched_dot(Ss, XWs, rep=rep)
            torch.cuda.synchronize()
            assert bd.batched_dot.launches == n0 + 1
            for y, w in zip(got, want):
                _close_to(y, w, 1e-5)


@pytest.mark.parametrize("layout", ["feat", "edge"])
def test_probe_fma_matches_plain(cuda, layout):
    """The FMA-rate probe's carried chain (r2_pallas_fma's fma, 4 reps) and
    one pass (r2_pallas_caps's fma_probe), both layouts, with copies and at a
    width whose threads leave a CTA partly idle, against the torch loops
    (fma_rate.TOL)."""
    from sevennet_tpu_torch.probes import fma_rate as fr

    rng = np.random.default_rng(9)
    for mul, t_len, copies in ((32, 256, 1), (8, 100, 3)):
        xs, ts = fr.fma_shapes(layout, mul, t_len)
        x = torch.tensor(rng.normal(size=xs), dtype=torch.float32, device=cuda)
        t = torch.tensor(rng.normal(size=ts), dtype=torch.float32, device=cuda)
        for fn, kw in ((fr.fma_chain, dict(rep=4)), (fr.fma_pass, {})):
            n0 = fn.launches
            got = fn(x, t, layout, copies=copies, **kw)
            want = fn(x, t, layout, copies=copies, plain=True, **kw)
            torch.cuda.synchronize()
            assert fn.launches == n0 + 1 and got.shape == want.shape
            np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0,
                                       atol=fr.TOL * float(want.abs().max()))


def test_probe_vpu_matches_plain(cuda):
    """The elementwise chain (r4_vpu_roofline's kernel) on more elements than
    its resident CTAs take in one sweep, some |a| small enough that the 1e-9
    bump moves it, against the torch loop (fma_rate.TOL)."""
    from sevennet_tpu_torch.probes import fma_rate as fr

    rng = np.random.default_rng(10)
    a = rng.normal(size=(3000, 300)) * np.where(rng.random((3000, 300)) < 0.3, 1e-3, 1.0)
    a = torch.tensor(a, dtype=torch.float32, device=cuda)
    b = torch.tensor(rng.normal(size=(3000, 300)), dtype=torch.float32, device=cuda)
    n0 = fr.vpu_chain.launches
    got = fr.vpu_chain(a, b)
    want = fr.vpu_chain(a, b, plain=True)
    torch.cuda.synchronize()
    assert fr.vpu_chain.launches == n0 + 1
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=fr.TOL * float(want.abs().max()))


@pytest.mark.parametrize("streaming", [True, False], ids=["stcs", "st"])
@pytest.mark.parametrize("variant", ["ldg", "cp_async"])
def test_probe_gather_rows_matches_plain(cuda, variant, streaming):
    """The row gather, both variants, with and without streaming stores,
    at a width of several float4 sweeps a lane, a narrow one, with copies and
    into a preallocated output: bitwise equal to index_select."""
    from sevennet_tpu_torch.probes import gather as ga

    rng = np.random.default_rng(11)
    for n, d, t, copies in ((1000, 1040, 5000, 1), (64, 24, 333, 2)):
        x = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32, device=cuda)
        idx = torch.tensor(rng.integers(0, n, size=t), dtype=torch.int32, device=cuda)
        want = ga.gather_rows(x, idx, copies=copies, plain=True)
        out = torch.full(want.shape, float("nan"), device=cuda)
        n0 = ga.gather_rows.by_variant[variant]
        got = ga.gather_rows(x, idx, variant=variant, streaming=streaming, copies=copies, out=out)
        torch.cuda.synchronize()
        assert got is out and ga.gather_rows.by_variant[variant] == n0 + 1
        assert torch.equal(got, want)


def test_probe_gather_cols_matches_plain(cuda):
    """The column gather at p1's shape (480 rows, 1,024 indices), a row
    count that leaves the last CTA's rows short, T not a multiple of 4 (the
    4-byte path), copies 3 (4 rows a thread), each into an output the
    wrapper allocates and into a NaN-filled one: bitwise equal to
    index_select."""
    from sevennet_tpu_torch.probes import gather as ga

    rng = np.random.default_rng(12)
    for d, w, t, copies in ((37, 512, 1000, 1), (480, 64, 33, 3), (480, 512, 1024, 1),
                            (481, 512, 1023, 1), (480, 512, 1024, 3), (5, 8, 6, 2)):
        tbl = torch.tensor(rng.normal(size=(d, w)), dtype=torch.float32, device=cuda)
        idx = torch.tensor(rng.integers(0, w, size=(1, t)), dtype=torch.int32, device=cuda)
        want = ga.gather_cols(tbl, idx, copies=copies, plain=True)
        out = torch.full(want.shape, float("nan"), device=cuda)
        n0 = ga.gather_cols.launches
        got_new = ga.gather_cols(tbl, idx, copies=copies)
        got = ga.gather_cols(tbl, idx, copies=copies, out=out)
        torch.cuda.synchronize()
        assert ga.gather_cols.launches == n0 + 2 and got is out
        assert torch.equal(got_new, want) and torch.equal(got, want)


def _close_to(got, want, tol):
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=tol * float(want.abs().max()))


def test_probe_reduce_matches_plain(cuda):
    """The K reductions (r2_pallas_fma's kreduce, r2_pallas_mm's subreduce
    and lanereduce) at K 16 and 128, over several CTAs, against the torch
    loops (reduce.TOL); kreduce's carry, which each CTA recomputes, also on
    the columns that only the carry moves far."""
    from sevennet_tpu_torch.probes import reduce as rd

    rng = np.random.default_rng(13)
    s = torch.full((1, 1), 1e-3, device=cuda)
    for k, mul in ((16, 40), (128, 300)):
        x = rng.normal(size=(rd.A * k, mul)).astype(np.float32)
        x[:k, 0] = 1e8  # acc[0, 0] grows by about K a rep
        x = torch.tensor(x, device=cuda)
        n0 = rd.kreduce.launches
        got, want = rd.kreduce(x), rd.kreduce(x, plain=True)
        torch.cuda.synchronize()
        assert rd.kreduce.launches == n0 + 1
        _close_to(got, want, rd.TOL)
        _close_to(got[:, 1:], want[:, 1:], rd.TOL)
        a = torch.tensor(rng.normal(size=(rd.A * k, mul)), dtype=torch.float32, device=cuda)
        _close_to(rd.subreduce(a, s), rd.subreduce(a, s, plain=True), rd.TOL)
    for k, rows in ((8, 37), (64, 20), (128, 129)):
        a = torch.tensor(rng.normal(size=(rows, rd.A * k)), dtype=torch.float32, device=cuda)
        n0 = rd.lanereduce.launches
        got = rd.lanereduce(a, s)
        torch.cuda.synchronize()
        assert rd.lanereduce.launches == n0 + 1
        _close_to(got, rd.lanereduce(a, s, plain=True), rd.TOL)


@pytest.mark.parametrize("variant", ["pad0", "pad1"])
def test_probe_xpose_matches_plain(cuda, variant):
    """The transposes at ragged shapes and at the streamed width 480: the
    carried form (r2_pallas_mm's transpose) within xpose.CARRY_TOL, xpose and
    the round trip (r5_xpose_probe's xpose, xpose2) bitwise. The pad-0 round
    trip takes 4-byte accesses at a width off the 4-float grid and at an
    input 4 bytes off the 16-byte grid, 16-byte ones at the others."""
    from sevennet_tpu_torch.probes import xpose as xp

    rng = np.random.default_rng(14)
    s = torch.full((1, 1), 1e-3, device=cuda)
    for (r, c), off in (((70, 45), 0), ((96, 480), 0), ((33, 132), 1), ((40, 132), 0)):
        flat = torch.tensor(rng.normal(size=r * c + off), dtype=torch.float32, device=cuda)
        a = flat[off:].view(r, c)
        n0 = xp.transpose_carry.by_variant[variant]
        got = xp.transpose_carry(a, s, variant)
        torch.cuda.synchronize()
        assert xp.transpose_carry.by_variant[variant] == n0 + 1
        _close_to(got, xp.transpose_carry(a, s, variant, plain=True), xp.CARRY_TOL)
        for fn in (xp.xpose, xp.xpose2):
            out = torch.full(fn(a, variant, plain=True).shape, float("nan"), device=cuda)
            n0 = fn.launches
            assert fn(a, variant, out=out) is out
            torch.cuda.synchronize()
            assert fn.launches == n0 + 1 and torch.equal(out, fn(a, variant, plain=True))


@pytest.mark.parametrize("variant", ["roll", "mxu2", "mxu3", "bigroll"])
def test_probe_fold_matches_plain(cuda, variant):
    """The K fold (r3_fold_probe's make) at K 9 (odd, peeled) and 8, A 16 and
    32, 3 blocks, tiles that wrap around DX, at DM 800 (13 m64 tiles on a
    cluster of 2 CTAs of 7: the last tile half empty, the cluster's span not
    filled; with and without input columns in even pairs), and at the
    script's DM 3,136 over 2 blocks (a cluster of 7 CTAs a block for mxu),
    against plain (fold.TOL); the mxu variants also with a random fold
    matrix (rounded to bf16, as the kernel rounds it), which they read;
    mxu3 also on fold.cancelling_input, whose fold a kernel without its
    third piece misses."""
    from sevennet_tpu_torch.probes import fold as fo

    rng = np.random.default_rng(15)
    muls = (12, 12, 8, 8, 8, 8, 8, 8, 4, 4, 4, 4, 4, 4)
    wide, paired = (100,) * 8, (64,) * 12 + (32,)
    for k, a, m in ((9, 16, muls), (8, 32, muls), (9, 16, wide), (8, 32, wide), (8, 32, paired),
                    (72, 32, fo.MULS)):
        dx = sum(m) // 8
        x = torch.tensor(rng.normal(size=(3 * a * k if k < 72 else 2 * a * k, dx)) * 0.5,
                         dtype=torch.float32, device=cuda)
        folds = [fo.fold_matrix(k, a, cuda)]
        if fo.PIECES[variant]:
            folds.append(torch.tensor(rng.normal(size=(k * a, a)), dtype=torch.float32,
                                      device=cuda).to(torch.bfloat16).float())
        inputs = [(x, fm) for fm in folds]
        if variant == "mxu3":
            inputs.append((fo.cancelling_input(x.shape[0] // (a * k), k, a, dx, 16, cuda),
                           folds[0]))
        for x_, fm in inputs:
            n0 = fo.fold.by_variant[variant]
            got = fo.fold(x_, fm, k, a, variant, m)
            torch.cuda.synchronize()
            assert fo.fold.by_variant[variant] == n0 + 1
            _close_to(got, fo.fold(x_, fm, k, a, variant, m, plain=True), fo.TOL)


@pytest.mark.parametrize("variant", ["roll", "bigroll"])
def test_probe_roll_slices_match_plain(cuda, variant):
    """The roll kernel's ring of column slices: at K 8 and 9 and A 16 over
    DX 100 (two slices of fold.ROLL_SW columns, the last partial), at K 72
    over DX 100 with 192 receivers (more than the card's SMs: a CTA folds
    several, its threads' units continuing across them) and over DX 60 (a
    last slice of 4 columns); the tile map by single columns where its runs
    are off the 4-column grid ((100,) * 8), by 4-column runs elsewhere;
    against plain within fold.TOL and, since both add in the script's
    order, bitwise."""
    from sevennet_tpu_torch.probes import fold as fo

    rng = np.random.default_rng(21)
    paired = (64,) * 12 + (32,)
    for k, a, m, nb in ((8, 16, (100,) * 8, 3), (9, 16, paired, 3), (72, 32, paired, 6),
                        (72, 32, (100,) * 8, 2), (72, 16, (32,) * 15, 9)):
        dx = sum(m) // 8
        rp = fo.roll_plan(fo.column_map(variant, m, dx), dx, k)
        assert rp.nsl == -(-dx // fo.ROLL_SW) and dx % fo.ROLL_SW
        x = torch.tensor(rng.normal(size=(nb * a * k, dx)), dtype=torch.float32, device=cuda)
        fm = fo.fold_matrix(k, a, cuda)
        out = torch.full((nb * a, sum(m)), float("nan"), device=cuda)
        n0 = fo.fold.by_variant[variant]
        got = fo.fold(x, fm, k, a, variant, m, out=out)
        torch.cuda.synchronize()
        assert fo.fold.by_variant[variant] == n0 + 1 and got is out
        want = fo.fold(x, fm, k, a, variant, m, plain=True)
        _close_to(got, want, fo.TOL)
        assert torch.equal(got, want)


def test_probe_fold_conv_matches_plain_and_b4(cuda):
    """The conv fold (r4_fold_probe's make) on 16x0e+8x1e+4x2e (instructions
    of 16, 8 and 4 channels: the kernel pads a warp's 16), K 24, radial MLP
    (8, 16, 16, numel), every variant against plain and against B4 fwd on
    the same x[src] (fold_conv.TOL)."""
    from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec
    from sevennet_tpu_torch.probes import fold_conv as fcv

    x_ir, f_ir = Irreps("16x0e+8x1e+4x2e"), Irreps.spherical_harmonics(2, 1)
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    dims = (8, 16, 16, conv.weight_numel)
    rng = np.random.default_rng(16)
    n, k = 30, 24

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=cuda)

    x = t(50, x_ir.dim, scale=0.5)
    src = torch.tensor(rng.integers(0, 50, size=(n, k)), dtype=torch.int32, device=cuda)
    emb, sh = t(n * k, 8, scale=0.3), t(n * k, 9, scale=0.5)
    ws = [t(a, b) for a, b in zip(dims[:-1], dims[1:])]
    w3j = torch.tensor(fcv._tables(conv)[1], device=cuda)
    xg = x[src.reshape(-1).long()].contiguous()
    b4 = fc.fused_conv_fwd_embsh(fc.conv_op(conv, ScalarMLPSpec(dims), None), x, src, emb, sh, ws)
    for variant in fcv.VARIANTS:
        n0 = fcv.fold_conv.by_variant[variant]
        got = fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, variant)
        torch.cuda.synchronize()
        assert fcv.fold_conv.by_variant[variant] == n0 + 1
        _close_to(got, fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, variant, plain=True), fcv.TOL)
        _close_to(got, b4, fcv.TOL)


@pytest.mark.parametrize("layer,k", [("16x0e+8x1e+4x2e", 24), ("sevennet0", 72)])
def test_probe_fold_conv_sums_in_its_variants_order(cuda, layer, k):
    """On fold_conv.cancelling_input, where the three orders of the K sum
    round apart (the plain variants more than 10 TOL from each other), each
    kernel variant is within TOL of its own variant's plain version: it
    sums in that order."""
    from sevennet_tpu_torch.probes import fold_conv as fcv

    if layer == "sevennet0":
        conv, mlp = fcv.sevennet0_conv()
        dims = mlp.dims
    else:
        x_ir, f_ir = Irreps(layer), Irreps.spherical_harmonics(2, 1)
        conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
        dims = (8, 16, 16, conv.weight_numel)
    rng = np.random.default_rng(k)
    ws = [torch.tensor(rng.normal(size=(a, b)), dtype=torch.float32, device=cuda)
          for a, b in zip(dims[:-1], dims[1:])]
    w3j = torch.tensor(fcv._tables(conv)[1], device=cuda)
    xg, emb, sh = fcv.cancelling_input(20, k, conv, 3, cuda)
    plain = {v: fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, v, plain=True) for v in fcv.VARIANTS}
    for i, a in enumerate(fcv.VARIANTS):
        for b in fcv.VARIANTS[i + 1:]:
            gap = float((plain[a] - plain[b]).abs().max())
            assert gap > 10 * fcv.TOL * float(plain[a].abs().max()), (a, b, gap)
    for v in fcv.VARIANTS:
        _close_to(fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, v), plain[v], fcv.TOL)


def _breakdown_knockout_match(cuda, op, n, k, seed):
    """Every breakdown and knock-out variant of layer ``op`` at n receivers
    of k slots against plain (breakdown.tol, knockout.TOL), each launch
    counted, full_hi and the knock-out's full bitwise equal to B4 fwd on
    the same inputs."""
    from sevennet_tpu_torch.probes import breakdown as bd
    from sevennet_tpu_torch.probes import knockout as ko

    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=cuda)

    xg = t(n * k, op.dim_x, scale=0.5)
    emb, sh = t(n * k, op.n_basis, scale=0.3), t(n * k, op.dim_f, scale=0.5)
    ws = [t(a, b) for a, b in zip(op.mlp_spec.dims[:-1], op.mlp_spec.dims[1:])]
    src = torch.arange(n * k, dtype=torch.int32, device=cuda).view(n, k)
    b4 = fc.fused_conv_fwd_embsh(op, xg, src, emb, sh, ws)
    for mod, fn, full in ((bd, bd.breakdown, "full_hi"), (ko, ko.knockout, "full")):
        for variant in mod.VARIANTS:
            n0 = fn.by_variant[variant]
            got = fn(op, xg, emb, sh, ws, k, variant)
            torch.cuda.synchronize()
            assert fn.by_variant[variant] == n0 + 1
            want = fn(op, xg, emb, sh, ws, k, variant, plain=True)
            tol = bd.tol(variant) if mod is bd else ko.TOL
            if tol == 0:
                assert torch.equal(got, want)
            else:
                _close_to(got, want, tol)
            if variant == full:
                assert torch.equal(got, b4)


@pytest.mark.parametrize("k", [12, 20])
def test_probe_breakdown_knockout_match_plain_and_b4(cuda, k):
    """The breakdown and knock-out probes (r2_fused_breakdown's build,
    build_feat, build_featroll; r3_fwd_knockout's make) on 8x0e+4x1e+2x2e
    (dim_mid 196, over the scripts' 128 lanes), radial MLP (8, 16, 16,
    numel), K 12 (one partial tile) and 20 (a whole and a partial one):
    every variant against plain (breakdown.tol: 1e-4, 2^-8 for one TF32
    pass, bitwise for the transpose), each launch counted, full_hi and the
    knock-out's full bitwise equal to B4 fwd on the same inputs."""
    x_ir, f_ir = Irreps("8x0e+4x1e+2x2e"), Irreps.spherical_harmonics(2, 1)
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    op = fc.conv_op(conv, ScalarMLPSpec((8, 16, 16, conv.weight_numel)))
    _breakdown_knockout_match(cuda, op, 30, k, 17)


@pytest.mark.parametrize("k", [72, 96])
def test_probe_edge_product_at_sevennet0_widths(cuda, k):
    """The per-edge uvu product (csrc/probe_breakdown.cuh:uvu_edges) at
    SevenNet-0's widths, 128x0e+64x1e+32x2e against lmax-2 harmonics (mul
    128 with 4 channels a lane, d1 = d3 = 5 with 23 terms), which the
    8x0e+4x1e+2x2e test never reaches, at the scripts' K (72, 96) on 20
    receivers: every breakdown and knock-out variant (every PB_UVU_EDGE
    instantiation among them) against plain, each launch counted, full_hi
    and the knock-out's full bitwise equal to B4 fwd."""
    from sevennet_tpu_torch.probes import fold_conv as fcv

    conv, mlp = fcv.sevennet0_conv()
    _breakdown_knockout_match(cuda, fc.conv_op(conv, mlp), 20, k, k)


@pytest.mark.parametrize("mode", ["vec", "embsh"])
def test_ext_conv_at_a_rank_shape_matches_plain(cuda, mode):
    """The ext conv (``fused_conv_apply_ext_vec`` / ``fused_conv_apply_ext``)
    at the shape of rank 0 of a two-slab decomposition
    (``parallel.partition_system``): senders index ``[owned | ghosts]``,
    the slots are the rank's edges densified, two row chunks; the output and
    the gradients of ``x_ext`` (ghost rows included) and of the edge inputs
    against the plain versions."""
    from sevennet_tpu_torch.data.graph import densify_edges
    from sevennet_tpu_torch.model.model import edge_emb_sh, edge_embed_spec
    from sevennet_tpu_torch.parallel.partition import partition_system

    spec = build_model_spec({"channel": 8, "lmax": 2, "num_convolution_layer": 2,
                             "cutoff": 3.0, "chemical_species": ["H", "O"],
                             "_normalize_sph": mode == "vec"})
    params = params_from_numpy(spec, random_params(spec, 3))
    rng = np.random.default_rng(8)
    pos, cell = rng.uniform(0, 12.0, (96, 3)), np.eye(3) * 12.0
    dd = partition_system(pos, np.zeros(96, np.int32), cell, spec.cutoff, 2)
    NL, G = dd.n_local_cap, dd.n_ghost_cap
    src, dst, shift, mask = (dd.edge_src[0], dd.edge_dst[0], dd.edge_shift[0], dd.edge_mask[0])
    order = np.argsort(np.where(mask, dst, NL), kind="stable")
    src, dst, shift, mask = src[order], dst[order], shift[order], mask[order]
    K = int(np.bincount(dst[mask], minlength=NL).max())
    src_d, dst_d, shift_d, mask_d = densify_edges(src, dst, shift, mask, NL, K)
    assert (src_d[mask_d] >= NL).any()  # ghost senders
    # [owned | ghosts] positions: rank 0's left ghosts are rank 1's right
    # sends, its right ghosts rank 1's left sends, shifted by their images
    ext = np.concatenate([dd.positions[0], np.zeros((G, 3))])
    ghost_pos = np.zeros((G, 3))
    for s in range(2):
        rows = dd.send_idx_right if s == 0 else dd.send_idx_left
        rmask = dd.send_mask_right if s == 0 else dd.send_mask_left
        sl = slice(0, dd.n_ghost_left_cap) if s == 0 else slice(dd.n_ghost_left_cap, G)
        got = dd.positions[1][rows[1]] * rmask[1][:, None]
        ghost_pos[sl][: len(got)] = got
    ext[NL:] = ghost_pos + dd.ghost_shift[0] @ cell
    vec = (ext[src_d] - ext[dst_d] + shift_d @ cell)
    vec = np.where(mask_d[:, None], vec, [2 * spec.cutoff, 0.0, 0.0]).T
    layer = spec.layers[1]
    ws = params["1_convolution"]["weight_nn"]["w"]
    coef = params["edge_embedding"]["bessel_coeffs"].to(cuda)
    src_t = torch.as_tensor(src_d, device=cuda).long().view(NL, K)
    vec_t = torch.tensor(vec, dtype=torch.float32, device=cuda).contiguous()
    x = torch.tensor(rng.normal(size=(NL + G, layer.conv.irreps_x.dim)), dtype=torch.float32,
                     device=cuda)
    ybar = torch.tensor(rng.normal(size=(NL, layer.conv.irreps_mid.dim)), dtype=torch.float32,
                        device=cuda)
    if mode == "vec":
        edge = (vec_t,)
    else:
        emb, sh = edge_emb_sh(spec, coef, vec_t, torch.as_tensor(mask_d, device=cuda))
        edge = (emb.view(NL, K, -1), sh.view(NL, K, -1))
    outs = {}
    for plain in (False, True):
        xs = x.clone().requires_grad_(True)
        es = [e.detach().clone().requires_grad_(True) for e in edge]
        wl = [w.detach().to(cuda) for w in ws]  # MD takes no weight gradients: B2 / B4 bwd
        n0 = (fc.fused_conv_fwd.launches + fc.fused_conv_fwd_embsh.launches,
              fc.fused_conv_bwd.launches + fc.fused_conv_bwd_embsh.launches)
        if mode == "vec":
            out = fc.fused_conv_apply_ext_vec(layer.conv, layer.radial_mlp, wl, coef,
                                              edge_embed_spec(spec, layer), xs, es[0], src_t,
                                              plain=plain, row_chunk=-(-NL // 2))
        else:
            out = fc.fused_conv_apply_ext(layer.conv, layer.radial_mlp, wl, xs, *es, src_t,
                                          plain=plain, row_chunk=-(-NL // 2))
        grads = torch.autograd.grad(out, (xs, *es), ybar)
        torch.cuda.synchronize()
        n1 = (fc.fused_conv_fwd.launches + fc.fused_conv_fwd_embsh.launches,
              fc.fused_conv_bwd.launches + fc.fused_conv_bwd_embsh.launches)
        assert n1 == (n0 if plain else (n0[0] + 1, n0[1] + 2))
        outs[plain] = [out.detach(), *grads]
    assert float(outs[True][1][NL:].abs().max()) > 0  # ghost rows get gradients
    for got, want in zip(outs[False], outs[True]):
        _close_to(got, want, 1e-5)
