"""SevenNet-MF-ompa's wide parity layers in the fused-conv kernels: the
thread-block clusters and column blocks the host plans for them, their task
tables walked in numpy as the cluster walks them, the plans of SevenNet-0
and SevenNet-l3i5 (one CTA, the blocks they had), and one full-width mf-ompa
box against the JAX package.

The widest mf-ompa layers (2 and 3: 13,504 and 15,552 mid columns, x of
1,280 and 1,408 columns) do not fit a CTA's 232,448 bytes of shared memory
with their output accumulator, ybar and task tables whole, even with one
instruction per column block. A cluster of CTAs walks each receiver row's
edges once, each CTA (rank) the x irreps, instructions and outputs of its
share (``ops/fused_conv.py:plan_blocks``). Tolerances: the walk 1e-5 of the
largest plain value (float64 walk against the fp32 plain path); the
full-width box energy 1e-5 relative, forces within 1e-4 of the largest JAX
force and within 1e-3 eV/A (fp32 on both sides, sums in another order).

The planner falls back to a cluster of 4 CTAs where 2 do not fit. No
published model needs it; ``WIDE4_LAYER``'s second layer (mf-ompa's parity
irreps at twice the channels, x of 2,560 columns) does, and its 4-rank
tables are walked the same way in both modes.
"""

import jax
import numpy as np
import pytest
import torch

from sevennet_tpu.atoms import AtomsLite as JAtomsLite
from sevennet_tpu.calculator import SevenNetTPUCalculator
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu.scripts.modal_tools import select_modality as j_select
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.data.graph import densify_edges
from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy
from sevennet_tpu_torch.io.convert import params_from_numpy
from sevennet_tpu_torch.model.build import build_model_spec as t_build
from sevennet_tpu_torch.model.model import edge_embed_spec
from sevennet_tpu_torch.model.presets import MF_OMPA, WIDE4_LAYER
from sevennet_tpu_torch.ops import fused_conv as fc
from sevennet_tpu_torch.scripts.modal_tools import select_modality

from .test_torch_fused_conv import _walk_tables
from .test_torch_lmax3 import L3I5, SEVENNET0
from .test_torch_model import _water

torch.set_num_threads(1)

MF = dict(MF_OMPA, chemical_species=["H", "O"])
WIDE4 = dict(WIDE4_LAYER, chemical_species=["H", "O"])


def _ops(cfg, vec=True, embsh=True):
    spec = t_build(cfg)
    for layer in spec.layers:
        for embed in [edge_embed_spec(spec, layer)] * vec + [None] * embsh:
            yield layer, fc.conv_op(layer.conv, layer.radial_mlp, embed)


def test_mf_ompa_layers_plan():
    """Every mf-ompa layer plans, in both modes: one CTA, or (layers 2 and
    3) a cluster of 2 whose ranks split the x irreps (each rank the
    instructions that read its irreps, in order; together every irrep,
    instruction, x column and output column once, the W3 columns of the
    two about even), blocks that take each rank's instructions in turn, and
    both kernels' carve per CTA within the limit at PLAN_K slots, at least
    2 W3 stages."""
    clusters = []
    for layer, op in _ops(MF):
        plan = op.plan
        instr, _, dim_mid, _ = fc._instr_tables(layer.conv)
        xs = layer.conv.irreps_x.slices()
        assert sorted(j for r in plan.ranks for j in r.xi) == list(range(len(xs)))
        assert sorted(k for r in plan.ranks for k in r.ks) == list(range(len(instr)))
        assert sum(plan.rank_blocks) == len(plan.blocks)
        starts = np.cumsum((0,) + plan.rank_blocks)
        for r, a, b in zip(plan.ranks, starts[:-1], starts[1:]):
            assert [k for blk in plan.blocks[a:b] for k in blk] == list(r.ks)
            assert list(r.ks) == [k for k, ins in enumerate(instr)
                                  if ins["x_start"] in {xs[j].start for j in r.xi}]
            assert r.xw == sum(xs[j].stop - xs[j].start for j in r.xi)
            assert r.mw == sum(instr[k]["d3"] * instr[k]["mul"] for k in r.ks)
        assert sum(r.xw for r in plan.ranks) == op.dim_x
        assert sum(r.mw for r in plan.ranks) == dim_mid == op.dim_mid
        assert plan.mblk == max(r.mw for r in plan.ranks)
        cols = [sum(instr[k]["mul"] for k in r.ks) for r in plan.ranks]
        assert max(cols) <= 0.6 * sum(cols) or plan.cluster == 1
        if plan.cluster > 1:  # the backward holds one block's ybar
            assert plan.yblk == max(sum(instr[k]["d3"] * instr[k]["mul"] for k in b)
                                    for b in plan.blocks)
        d = op.dims(1, fc.PLAN_K)
        for bwd, (nbytes, stages) in ((False, plan.fwd), (True, plan.bwd)):
            assert op.carve(d, bwd) == (nbytes, stages)
            assert nbytes <= fc.SMEM_LIMIT and stages >= 2
        clusters.append(plan.cluster)
    assert clusters == [1, 1, 1, 1, 2, 2, 2, 2, 1, 1]


def test_mf_ompa_whole_layers_would_not_fit():
    """What the cluster repairs: layers 2 and 3 in one CTA, with the tables
    of the whole layer and blocks of one instruction, exceed the limit in
    both kernels."""
    spec = t_build(MF)
    for t in (2, 3):
        layer = spec.layers[t]
        op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        instr = fc._instr_tables(layer.conv)[0]
        blocks = fc._column_blocks(instr, range(len(instr)), max(i["mul"] for i in instr))
        whole = fc._conv_rank(layer.conv, instr, range(len(layer.conv.irreps_x)))
        tab = fc._uvu_tables(layer.conv, instr, blocks, op.mlp_spec.dims[1:-1], whole,
                             fc._kernel_rows(instr, [blocks]), cluster=False)
        d = op.dims(1, fc.PLAN_K)
        d.shd_terms += tab.size - d.sh_terms
        d.sh_terms = tab.size
        d.wblk = max(sum(instr[k]["mul"] for k in b) for b in blocks)
        d.rblk = max(sum(len(instr[k]["mp"]) for k in b) for b in blocks)
        assert min(fc.carve_bytes(d, False)[0], fc.carve_bytes(d, True)[0]) > fc.SMEM_LIMIT


def test_wide4_layer_plans_a_cluster_of_4():
    """WIDE4_LAYER: its first layer takes one CTA, its second a cluster of 4
    in both modes, the ranks splitting the x irreps (every irrep,
    instruction, x column and output column once; each rank's blocks its
    instructions in turn), both kernels' carve per CTA within the limit with
    at least 2 W3 stages (the planner tries every split over 2 CTAs first)."""
    got = []
    for layer, op in _ops(WIDE4):
        plan = op.plan
        instr = fc._instr_tables(layer.conv)[0]
        got.append(plan.cluster)
        assert sorted(j for r in plan.ranks for j in r.xi) == list(range(len(layer.conv.irreps_x)))
        assert sorted(k for r in plan.ranks for k in r.ks) == list(range(len(instr)))
        starts = np.cumsum((0,) + plan.rank_blocks)
        for r, a, b in zip(plan.ranks, starts[:-1], starts[1:]):
            assert [k for blk in plan.blocks[a:b] for k in blk] == list(r.ks)
        assert sum(r.xw for r in plan.ranks) == op.dim_x
        assert sum(r.mw for r in plan.ranks) == op.dim_mid
        for nbytes, stages in (plan.fwd, plan.bwd):
            assert nbytes <= fc.SMEM_LIMIT and stages >= 2
    assert got == [1, 1, 4, 4]


def _mf_or_wide4(t):
    """Layer ``t`` of mf-ompa, or with ``t`` "wide4" WIDE4_LAYER's second:
    its spec, layer and expected cluster size."""
    if t == "wide4":
        spec = t_build(WIDE4)
        return spec, spec.layers[1], 4
    spec = t_build(MF)
    return spec, spec.layers[t], 2


@pytest.mark.parametrize("t", [2, 3, "wide4"])
def test_mf_ompa_pass_tables_reproduce_plain(t):
    """Layer t's cluster tables, walked in numpy as the cluster walks them
    (rank by rank, each rank's shares of dsh and dz added in rank order and
    chained once), against the unblocked plain versions: forward, dxg, dvec
    and the parameter gradients, on a few edges of 3 receivers (``wide4``:
    WIDE4_LAYER's cluster of 4)."""
    spec, layer, cluster = _mf_or_wide4(t)
    op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
    assert op.plan.cluster == cluster
    rng = np.random.default_rng(t if t != "wide4" else 4)
    n, k = 3, 3
    pos = rng.uniform(0.0, 3.0, (n, 3))
    dst, src, shift = neighbor_list_numpy(pos, 6.0)
    src_d, _, _, mask = densify_edges(src.astype(np.int32), dst.astype(np.int32), shift,
                                      np.ones(len(src), bool), n, k)
    assert mask.sum() == 6   # two neighbours and one padded slot per row
    src_nk = src_d.reshape(n, k)
    vec = (pos[src_nk.reshape(-1)] - np.repeat(pos, k, 0)).T.astype(np.float32)
    vec[:, ~mask] = [[12.0], [0.0], [0.0]]   # the padded slots' sentinel
    x = (rng.normal(size=(n, op.dim_x)) * 0.5).astype(np.float32)
    coef = (np.arange(1, 9) * np.pi / 6.0).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) * 0.5).astype(np.float32)
          for a, b in zip(op.mlp_spec.dims[:-1], op.mlp_spec.dims[1:])]
    ybar = (rng.normal(size=(n, op.dim_mid)) * 0.1).astype(np.float32)
    out, dxg, dvec, dws, dcoef, work, valid = _walk_tables(op, x, src_nk, vec, coef, ws, ybar)
    args = (op, torch.tensor(x), torch.tensor(src_nk), torch.tensor(vec), torch.tensor(coef),
            [torch.tensor(w) for w in ws])
    dxg_p, dvec_p, dws_p, dcoef_p = fc.fused_conv_bwd_plain(*args, torch.tensor(ybar),
                                                            param_grads=True)
    dws_r, dcoef_r = fc.param_grad_reduce(op, torch.tensor(work), torch.tensor(valid), n, k)
    for want, got in ((fc.fused_conv_fwd_plain(*args), out), (dxg_p, dxg), (dvec_p, dvec),
                      *zip(dws_p + [dcoef_p], dws), (dcoef_p, dcoef),
                      *zip(dws_p + [dcoef_p], dws_r + [dcoef_r])):
        want = want.numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # a slot outside the cutoff gets no cotangent
    assert (dxg[~mask] == 0).all() and (dvec[:, ~mask] == 0).all()


@pytest.mark.parametrize("t", [2, 3, "wide4"])
def test_mf_ompa_embsh_cluster_tables_reproduce_plain(t):
    """Layer t in emb/sh mode (B4 and B4 bwd at these widths): its cluster
    tables walked in numpy over every slot of 3 receivers against the plain
    versions, forward, dxg, demb, dsh and the parameter gradients."""
    _, layer, cluster = _mf_or_wide4(t)
    op = fc.conv_op(layer.conv, layer.radial_mlp)
    assert op.plan.cluster == cluster
    rng = np.random.default_rng(10 + (t if t != "wide4" else 4))
    n, k = 3, 3
    src_nk = rng.integers(0, n, (n, k)).astype(np.int32)
    x = (rng.normal(size=(n, op.dim_x)) * 0.5).astype(np.float32)
    emb = (rng.normal(size=(n * k, op.n_basis)) * 0.5).astype(np.float32)
    emb[-1] = 0.0  # a padded slot: zero embedding
    sh = rng.normal(size=(n * k, op.dim_f)).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) * 0.5).astype(np.float32)
          for a, b in zip(op.mlp_spec.dims[:-1], op.mlp_spec.dims[1:])]
    ybar = (rng.normal(size=(n, op.dim_mid)) * 0.1).astype(np.float32)
    out, dxg, demb, dsh, dws, work, valid = _walk_tables(op, x, src_nk, None, None, ws, ybar,
                                                        emb_sh=(emb, sh))
    args = (op, torch.tensor(x), torch.tensor(src_nk), torch.tensor(emb), torch.tensor(sh),
            [torch.tensor(w) for w in ws])
    dxg_p, demb_p, dsh_p, dws_p = fc.fused_conv_bwd_embsh_plain(*args, torch.tensor(ybar),
                                                                param_grads=True)
    dws_r, _ = fc.param_grad_reduce(op, torch.tensor(work), torch.tensor(valid), n, k)
    for want, got in ((fc.fused_conv_fwd_embsh_plain(*args), out), (dxg_p, dxg),
                      (demb_p, demb), (dsh_p, dsh), *zip(dws_p, dws), *zip(dws_p, dws_r)):
        want = want.numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# the plans SevenNet-0 and SevenNet-l3i5 had before clusters: block widths
# per layer, the same in both modes, and (forward, backward) W3 stages
_BEFORE = {
    "sevennet0": ([(384,), (960,), (960,), (960,), (224,)], [(4, 4)] * 5),
    "l3i5": ([(512,), (736, 736, 288), (736, 736, 288), (736, 736, 288), (256,)],
             [(4, 4), (3, 2), (3, 2), (3, 2), (4, 4)]),
}


@pytest.mark.parametrize("name,cfg", [("sevennet0", SEVENNET0), ("l3i5", L3I5)])
def test_one_pass_plans_unchanged(name, cfg):
    """SevenNet-0 and l3i5 keep their plans: one CTA over every instruction,
    the column blocks and W3 stages they had, and a table whose x tile is x
    and whose output columns are all of the mid layout."""
    widths, stages = _BEFORE[name]
    got = [(op.plan, op) for _, op in _ops(cfg)]
    assert [p.widths for p, _ in got] == [w for w in widths for _ in range(2)]
    assert [(p.fwd[1], p.bwd[1]) for p, _ in got] == [s for s in stages for _ in range(2)]
    for plan, op in got:
        assert plan.cluster == 1 and plan.mblk == plan.yblk == op.dim_mid
        assert op.itab[fc.H_NEXT] == 0 and op.itab[fc.H_XW] == op.dim_x
        assert op.itab[fc.H_MW] == op.dim_mid


def test_mf_ompa_box_matches_jax():
    """SevenNet-MF-ompa at full width and depth, random weights from
    ``model_init``, with modality omat24 pinned by ``select_modality`` in
    both packages: a 12-atom water box through the port's calculator on the
    CPU (the conv's plain versions, whose op plans every layer) against
    ``SevenNetTPUCalculator(fused=False)``."""
    jcfg, jparams = j_select(MF, model_init(jax.random.PRNGKey(0), j_build(MF)), "omat24")
    jspec = j_build(jcfg)
    # forces of a few tenths of eV/A, so that the absolute limit is a sharp one
    jparams["rescale_atomic_energy"]["scale"] = jparams["rescale_atomic_energy"]["scale"] * 20.0
    ref = SevenNetTPUCalculator(jspec, jparams, fused=False, matmul_precision="highest")
    tcfg, tparams = select_modality(MF, params_from_numpy(
        t_build(MF), jax.tree_util.tree_map(np.asarray, jparams)), "omat24")
    spec = t_build(tcfg)
    assert spec.pinned_modal == 1 and spec.num_modalities == 2
    port = SevenNetCalculator(spec, tparams, device="cpu", plain=True)
    pos, Z, cell = _water(4, seed=11)
    r = ref.calculate(JAtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    p = port.calculate(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    fmax = np.abs(r["forces"]).max()
    assert fmax > 1e-2
    assert abs(p["energy"] - r["energy"]) <= 1e-5 * abs(r["energy"])
    np.testing.assert_allclose(p["forces"], r["forces"], rtol=0, atol=min(1e-4 * fmax, 1e-3))
    for layer in spec.layers:  # every layer plans (the kernels' tables)
        fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
