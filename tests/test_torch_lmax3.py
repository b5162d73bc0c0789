"""The port at lmax 3 (SevenNet-l3i5's form) and with radial MLPs of other
depths, against the JAX package; the column blocks of the conv kernels'
per-edge weights and the host's copy of their shared-memory carve.

Parity: tests/test_lmax3.py's two small configs (l3i5-like: lmax 3, poly
cutoff, nequip self-connection; and O(3) parity on), random weights from
``model_init`` carried over with ``params_from_numpy``, on the HfO2 cell,
through the port's calculator on the CPU (the conv's plain versions) in vec
mode and in emb/sh mode (``SEVENNET_TPU_VEC=0``), against
``SevenNetTPUCalculator(fused=False, matmul_precision="highest")``; then
the l3i5-like config with radial MLPs of no, one and three hidden layers.
The atomic energies are scaled by 20 so that the forces reach a few
hundredths of eV/A. Tolerances: energy 1e-6 relative, forces 1e-5 eV/A (fp32 on both
sides, sums in another order).

Column blocks: every SevenNet-0 layer plans one block (the kernels' schedule
before blocking); every SevenNet-l3i5 layer plans blocks whose carve fits a
CTA in both directions; a layer too wide for any block, or a call with too
many neighbour slots, raises a ValueError naming the bytes and the limit; a
library whose carve disagrees with the host's raises at the first launch.
The blocked task tables at l3i5's widths, walked in numpy, reproduce the
plain versions, also with radial MLPs of no and three hidden layers.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from sevennet_tpu.atoms import AtomsLite as JAtomsLite
from sevennet_tpu.calculator import SevenNetTPUCalculator
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.data.graph import densify_edges
from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy
from sevennet_tpu_torch.io.convert import params_from_numpy
from sevennet_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_tpu_torch.model.build import build_model_spec as t_build
from sevennet_tpu_torch.model.model import _vec_mode, edge_embed_spec
from sevennet_tpu_torch.ops import fused_conv as fc
from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec

from .test_lmax3 import _cfg_l3, _cfg_parity
from .test_torch_fused_conv import _walk_tables

torch.set_num_threads(1)

CONFIGS = {
    "l3": _cfg_l3(),
    "parity": _cfg_parity(),
    "l3_mlp0": dict(_cfg_l3(), weight_nn_hidden_neurons=[]),
    "l3_mlp1": dict(_cfg_l3(), weight_nn_hidden_neurons=[16]),
    "l3_mlp3": dict(_cfg_l3(), weight_nn_hidden_neurons=[16, 16, 16]),
}
# SevenNet-0 and SevenNet-l3i5 at full width (bench.py:87-147, :89-106)
SEVENNET0 = {
    "lmax": 2, "channel": 128, "cutoff": 5.0, "is_parity": False, "num_convolution_layer": 5,
    "irreps_manual": ["128x0e"] + ["128x0e+64x1e+32x2e"] * 4 + ["128x0e"],
    "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 4.5},
    "self_connection_type": "linear", "weight_nn_hidden_neurons": [64, 64],
    "radial_basis": {"radial_basis_name": "bessel", "bessel_basis_num": 8},
    "conv_denominator": 35.0, "chemical_species": ["H", "O"],
}
L3I5 = dict(SEVENNET0, lmax=3,
            irreps_manual=["128x0e"] + ["128x0e+64x1e+32x2e+32x3e"] * 4 + ["128x0e"],
            cutoff_function={"cutoff_function_name": "poly_cut", "poly_cut_p_value": 6},
            self_connection_type="nequip")


@functools.lru_cache(maxsize=None)
def _calculators(name):
    cfg = CONFIGS[name]
    jspec = j_build(cfg)
    jparams = model_init(jax.random.PRNGKey(11), jspec)
    # forces of a few hundredths of eV/A rather than the 1e-3 of the initial
    # scale, so that the absolute limit is a sharp one
    rs = jparams["rescale_atomic_energy"]
    rs["scale"] = rs["scale"] * 20.0
    ref = SevenNetTPUCalculator(jspec, jparams, fused=False, matmul_precision="highest")
    spec = t_build(cfg)
    port = SevenNetCalculator(
        spec, params_from_numpy(spec, jax.tree_util.tree_map(np.asarray, jparams)), device="cpu")
    return ref, port


@pytest.mark.parametrize("mode", ["vec", "embsh"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_calculator_matches_jax(name, mode, hfo2_structure, monkeypatch):
    if mode == "embsh":
        monkeypatch.setenv("SEVENNET_TPU_VEC", "0")
    ref, port = _calculators(name)
    assert _vec_mode(port.spec) == (mode == "vec")
    assert port.spec.lmax_edge == (2 if name == "parity" else 3)
    pos, Z, cell = hfo2_structure
    r = ref.calculate(JAtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    p = port.calculate(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    assert abs(p["energy"] - r["energy"]) <= 1e-6 * abs(r["energy"])
    np.testing.assert_allclose(p["forces"], r["forces"], atol=1e-5, rtol=0)
    assert np.abs(r["forces"]).max() > 1e-2


def _ops(cfg):
    spec = t_build(cfg)
    for layer in spec.layers:
        for embed in (edge_embed_spec(spec, layer), None):
            yield layer, fc.conv_op(layer.conv, layer.radial_mlp, embed)


def test_sevennet0_layers_plan_one_block():
    """SevenNet-0 keeps the schedule it had before blocking: w whole, in one
    block, and four W3 stages in flight in both kernels."""
    for layer, op in _ops(SEVENNET0):
        plan = op.plan
        assert plan.blocks == (tuple(range(len(layer.conv.instructions))),)
        assert plan.widths == (op.numel,) and plan.wblk == op.numel
        assert plan.fwd[1] == plan.bwd[1] == fc.MAX_STAGES
        assert max(plan.fwd[0], plan.bwd[0]) <= fc.SMEM_LIMIT


def test_l3i5_layers_fit_in_blocks():
    """Every SevenNet-l3i5 layer plans blocks at instruction boundaries that
    cover w and fit a CTA in both directions; the lmax-3 layers, whose w
    does not fit whole, take several."""
    n_blocks = []
    for layer, op in _ops(L3I5):
        plan = op.plan
        muls = [layer.conv.irreps_x[i].mul for i, _, _, _ in layer.conv.instructions]
        assert [k for b in plan.blocks for k in b] == list(range(len(muls)))
        assert plan.widths == tuple(sum(muls[k] for k in b) for b in plan.blocks)
        assert sum(plan.widths) == op.numel and max(plan.widths) == plan.wblk
        for nbytes, stages in (plan.fwd, plan.bwd):
            assert nbytes <= fc.SMEM_LIMIT and stages >= 2
        # the whole of w would not fit: each block is the widest that does
        d = op.dims(1, fc.PLAN_K)
        d.wblk = op.numel
        if len(plan.blocks) > 1:
            assert max(fc.carve_bytes(d, False)[0], fc.carve_bytes(d, True)[0]) > fc.SMEM_LIMIT
        n_blocks.append(len(plan.blocks))
    assert n_blocks == [1, 1, 3, 3, 3, 3, 3, 3, 1, 1]


def test_too_wide_layer_raises():
    x_ir = Irreps("1024x0e+512x1e+256x2e+256x3e")
    f_ir = Irreps("1x0e+1x1e+1x2e+1x3e")
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 3, "full"))
    with pytest.raises(ValueError, match=r"needs \d+ B.* over the limit of 232448 B"):
        fc.conv_op(conv, ScalarMLPSpec((8, 64, 64, conv.weight_numel)))


def test_check_carve_before_launch(monkeypatch):
    """Too many neighbour slots for a layer's plan raise a ValueError before
    any library is loaded; a library whose carve disagrees with the host's
    copy raises at the layer shape's first launch, once checked never
    again."""
    spec = t_build(L3I5)
    layer = spec.layers[1]
    op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
    with pytest.raises(ValueError, match=r"backward kernel needs \d+ B .*limit of 232448 B"):
        fc.check_carve("fused_conv_bwd", op, op.dims(10, 4096), bwd=True)

    class Lib:
        def __init__(self, nbytes):
            self.fused_conv_smem_bytes = lambda dims, bwd, mblk, xw: nbytes

    from sevennet_tpu_torch.ops import kernels

    dims = op.dims(10, 61)
    nbytes, _ = fc.carve_bytes(dims, False)
    monkeypatch.setattr(kernels, "library", lambda name: Lib(nbytes + 16))
    monkeypatch.setattr(fc, "_CARVE_CHECKED", set())
    with pytest.raises(RuntimeError, match="disagree"):
        fc.check_carve("fused_conv_fwd", op, dims, bwd=False)
    monkeypatch.setattr(kernels, "library", lambda name: Lib(nbytes))
    fc.check_carve("fused_conv_fwd", op, dims, bwd=False)
    monkeypatch.setattr(kernels, "library", lambda name: Lib(nbytes + 16))
    fc.check_carve("fused_conv_fwd", op, op.dims(99, 61), bwd=False)  # N does not matter


def _tables_match_plain(cfg, t):
    """Layer t's tables, walked in numpy as the CUDA kernels walk them,
    against the plain versions' forward, backward and parameter gradients.
    Returns the op."""
    spec = t_build(cfg)
    layer = spec.layers[t]
    op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
    rng = np.random.default_rng(t)
    n, k = 6, 8
    pos = rng.uniform(0.0, 4.0, (n, 3))
    dst, src, shift = neighbor_list_numpy(pos, 5.0)
    order = np.argsort(dst, kind="stable")
    keep = np.concatenate([np.flatnonzero(dst[order] == i)[:k - 1] for i in range(n)])
    sel = order[np.sort(keep)]
    src_d, _, shift_d, mask_d = densify_edges(
        src[sel].astype(np.int32), dst[sel].astype(np.int32), shift[sel],
        np.ones(len(sel), bool), n, k)
    vec = pos[src_d] - pos[np.repeat(np.arange(n), k)]
    vec[~mask_d] = (10.0, 0.0, 0.0)
    vec = np.ascontiguousarray(vec.T, np.float32)
    x = (rng.normal(size=(n, op.dim_x)) * 0.5).astype(np.float32)
    coef = np.linspace(1.0, 8.0, 8).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) * 0.3).astype(np.float32)
          for a, b in zip(layer.radial_mlp.dims[:-1], layer.radial_mlp.dims[1:])]
    ybar = (rng.normal(size=(n, op.dim_mid)) * 0.1).astype(np.float32)
    src_nk = src_d.reshape(n, k)
    out, dxg, dvec, dws, dcoef, work, valid = _walk_tables(op, x, src_nk, vec, coef, ws, ybar)
    args = (op, torch.tensor(x), torch.tensor(src_nk), torch.tensor(vec), torch.tensor(coef),
            [torch.tensor(w) for w in ws])
    out_p = fc.fused_conv_fwd_plain(*args)
    dxg_p, dvec_p, dws_p, dcoef_p = fc.fused_conv_bwd_plain(*args, torch.tensor(ybar),
                                                            param_grads=True)
    dws_r, dcoef_r = fc.param_grad_reduce(op, torch.tensor(work), torch.tensor(valid), n, k)
    assert valid.sum() > 2 * n and len(dws) == len(layer.radial_mlp.dims) - 1
    for want, got in [(out, out_p), (dxg, dxg_p), (dvec, dvec_p), (dcoef, dcoef_p),
                      (dcoef, dcoef_r), *zip(dws, dws_p), *zip(dws, dws_r)]:
        np.testing.assert_allclose(want, got.numpy(), rtol=0, atol=1e-5 * np.abs(want).max())
    return op


@pytest.mark.parametrize("t", [1, 4])
def test_l3i5_block_tables_reproduce_plain(t):
    """The tables of SevenNet-l3i5's layers 1 (three column blocks) and 4
    (one), walked in numpy as the CUDA kernels walk them, block by block,
    give the plain versions' forward, backward and parameter gradients."""
    op = _tables_match_plain(L3I5, t)
    assert len(op.plan.blocks) == (3 if t == 1 else 1)


@pytest.mark.parametrize("hidden", [(), (16, 16, 16)], ids=["depth0", "depth3"])
def test_mlp_depth_block_tables_reproduce_plain(hidden):
    """The same at l3i5's layer 1 (three column blocks) with radial MLPs of
    no and three hidden layers: with none, the last MLP layer reads the
    embedding and its cotangent is demb."""
    op = _tables_match_plain(dict(L3I5, weight_nn_hidden_neurons=list(hidden)), 1)
    assert len(op.plan.blocks) == 3 and op.dims(1, 1).nh == len(hidden)
