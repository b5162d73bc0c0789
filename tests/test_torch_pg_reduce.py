"""The host side of the B2′/B4′ reduction kernel (``csrc/pg_reduce.cu``), on
the CPU: its output tiles (:func:`reduce_tiles`) and row chunks
(:func:`reduce_chunk`), and a numpy walk of both as the kernel walks them
(staging with zero-filled invalid rows, fragments from the field's first
column, partial sums per chunk added in chunk order) against the plain
version, on records whose invalid rows hold NaN. The kernel itself is held
against the plain version on the card (``tests/test_torch_kernels.py``)."""

import math

import numpy as np
import pytest
import torch

from sevennet_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.model.model import edge_embed_spec
from sevennet_tpu_torch.ops import fused_conv as fc
from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec

SEVENNET0 = {  # bench.py:87-147, the widths the reduction sees
    "lmax": 2, "channel": 128, "cutoff": 5.0, "is_parity": False, "num_convolution_layer": 5,
    "irreps_manual": ["128x0e"] + ["128x0e+64x1e+32x2e"] * 4 + ["128x0e"],
    "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 4.5},
    "self_connection_type": "linear", "weight_nn_hidden_neurons": [64, 64],
    "chemical_species": ["H", "O"]}
L3I5 = dict(SEVENNET0, lmax=3,  # bench.py:89-106
            irreps_manual=["128x0e"] + ["128x0e+64x1e+32x2e+32x3e"] * 4 + ["128x0e"],
            cutoff_function={"cutoff_function_name": "poly_cut", "poly_cut_p_value": 6},
            self_connection_type="nequip")


def _model_op(cfg, t, vec_mode):
    spec = build_model_spec(cfg)
    layer = spec.layers[t]
    return fc.conv_op(layer.conv, layer.radial_mlp,
                      edge_embed_spec(spec, layer) if vec_mode else None)


def _odd_op(hidden, vec_mode):
    """dim_x 53, 81 uvu weights (not a multiple of 8), radial MLP (8,
    *hidden, 81): hidden (20, 24) puts dc at column 177, (21, 27) also h1 at
    29 and dz1 at 77, off the 4-float grid."""
    x_ir, f_ir = Irreps("3x0e+5x1e+7x2e"), Irreps("1x0e+1x1e+1x2e")
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    embed = fc.EdgeEmbedSpec(8, 3.4, "XPLOR", 3.0, 2) if vec_mode else None
    return fc.conv_op(conv, ScalarMLPSpec((8, *hidden, conv.weight_numel)), embed)


OPS = {
    "sevennet0_layer0": lambda v: _model_op(SEVENNET0, 0, v),
    "sevennet0_layers1-3": lambda v: _model_op(SEVENNET0, 1, v),
    "sevennet0_layer4": lambda v: _model_op(SEVENNET0, 4, v),
    "l3i5_layers1-3": lambda v: _model_op(L3I5, 1, v),
    "odd_20_24": lambda v: _odd_op((20, 24), v),
    "odd_21_27": lambda v: _odd_op((21, 27), v),
}


@pytest.mark.parametrize("vec_mode", [True, False], ids=["dcoef", "no_dcoef"])
@pytest.mark.parametrize("name", list(OPS))
def test_reduce_tiles_cover_every_output_once(name, vec_mode):
    """Every output entry of every product lies in exactly one tile; each
    tile fits the kernel's tile and staging buffers, stages only columns of
    the record, and its fragments read exactly the product's operand
    columns (copies from a 4-float boundary, in whole 16 bytes)."""
    op = OPS[name](vec_mode)
    prods = op.reduce_products
    assert (prods[-1][0] == -1) == vec_mode
    tiles, begins = fc.reduce_tiles(prods)
    assert len(tiles) <= fc.REDUCE_MAX_TILES and len(prods) <= fc.MAX_MLP + 1
    assert begins == list(np.cumsum([0] + [da * db for _, da, _, db in prods]))
    hits = np.zeros(begins[-1], np.int64)
    stride = op.ws_layout["stride"]
    cols = {}  # product -> output entries its tiles cover
    for m_col, m_sh, m_cols, m_len, n_col, n_sh, n_cols, n_len, out, sm, sn in tiles:
        assert 0 < m_len <= fc.REDUCE_TM and 0 < n_len <= fc.REDUCE_TN
        assert m_sh + m_len <= m_cols <= fc.REDUCE_SA and 0 <= m_col and m_col + m_cols <= stride
        if n_col < 0:
            assert (n_len, n_cols, n_sh) == (1, 0, 0)
        else:
            assert n_sh + n_len <= n_cols <= fc.REDUCE_SB and n_col + n_cols <= stride
        for c, sh, n in ((m_col, m_sh, m_cols), (n_col, n_sh, n_cols)):
            if c >= 0:
                assert c % 4 == 0 and n % 4 == 0 and sh < 4
        idx = out + np.arange(m_len)[:, None] * sm + np.arange(n_len)[None, :] * sn
        np.add.at(hits, idx.ravel(), 1)
        p = int(np.searchsorted(begins, out, side="right")) - 1
        assert begins[p] <= idx.min() and idx.max() < begins[p + 1]
        a, da, b, db = prods[p]
        i, j = np.divmod(idx - begins[p], db)  # the (da, db) entry of each tile entry
        m_read = m_col + m_sh + np.arange(m_len)[:, None] + 0 * j
        n_read = n_col + n_sh + np.arange(n_len)[None, :] + 0 * i if n_col >= 0 else -1 + 0 * i
        a_col, b_col = (-1 + 0 * i if a < 0 else a + i), b + j
        # the operands read A's column i and B's column j, or the other way
        # round (the product formed transposed; A a ones column: -1)
        assert (((m_read == a_col) & (n_read == b_col))
                | ((m_read == b_col) & (n_read == a_col))).all()
        cols[p] = cols.get(p, 0) + idx.size
    assert (hits == 1).all()
    assert cols == {p: da * db for p, (_, da, _, db) in enumerate(prods)}


@pytest.mark.parametrize("rows", [0, 1, 50, 64, 880, 10_007, 45_312, 174_000, 1_000_003,
                                  5_799_942])
def test_reduce_chunk_plan_covers_rows_once(rows):
    """The chunk size is a function of the row count alone (a whole number
    of stages, within the kernel's bounds) and the chunks cover every row
    once; from a few thousand rows on there are about as many chunks as
    SMs."""
    chunk = fc.reduce_chunk(rows)
    assert chunk == fc.reduce_chunk(rows) and chunk % fc.REDUCE_RK == 0
    assert fc.REDUCE_MIN_CHUNK <= chunk <= fc.REDUCE_MAX_CHUNK
    n_chunks = -(-rows // chunk)
    starts = np.arange(n_chunks) * chunk
    ends = np.minimum(starts + chunk, rows)
    assert (ends > starts).all() and (starts[1:] == ends[:-1]).all()
    assert (n_chunks == 0 and rows == 0) or (starts[0] == 0 and ends[-1] == rows)
    if fc.REDUCE_SMS * fc.REDUCE_MIN_CHUNK <= rows <= fc.REDUCE_SMS * fc.REDUCE_MAX_CHUNK:
        assert fc.REDUCE_SMS * 0.85 <= n_chunks <= fc.REDUCE_SMS


def _walk(op, work, valid):
    """The kernel's walk in numpy (float64): per chunk and tile, the staged
    rows (invalid ones and rows past the chunk zeroed in both operands),
    the fragments' columns, ``A^T B`` into the partial sums at the tile's
    places; then the chunks added in chunk order and scaled."""
    tiles, begins = fc.reduce_tiles(op.reduce_products)
    rows = work.shape[0]
    chunk = fc.reduce_chunk(rows)
    n_chunks = -(-rows // chunk)
    partial = np.full((n_chunks, begins[-1]), np.nan)
    for z in range(n_chunks):
        r0 = z * chunk
        nr = min(chunk, rows - r0)
        steps = -(-nr // fc.REDUCE_RK) * fc.REDUCE_RK
        ok = np.zeros(steps, bool)
        ok[:nr] = valid[r0:r0 + nr] != 0
        rec = np.zeros((steps, work.shape[1]))
        rec[:nr] = work[r0:r0 + nr]
        for m_col, m_sh, m_cols, m_len, n_col, n_sh, n_cols, n_len, out, sm, sn in tiles:
            a = np.where(ok[:, None], rec[:, m_col:m_col + m_cols], 0.0)[:, m_sh:m_sh + m_len]
            b = (np.ones((steps, 1)) if n_col < 0 else
                 np.where(ok[:, None], rec[:, n_col:n_col + n_cols], 0.0)[:, n_sh:n_sh + n_len])
            idx = out + np.arange(m_len)[:, None] * sm + np.arange(n_len)[None, :] * sn
            partial[z, idx] = a.T @ b
    total = np.zeros(begins[-1])
    for z in range(n_chunks):
        total = total + partial[z]
    outs = []
    for p, (a, da, _, db) in enumerate(op.reduce_products):
        v = total[begins[p]:begins[p + 1]] / math.sqrt(da)
        outs.append(v.reshape(da, db) if a >= 0 else v)
    return outs


@pytest.mark.parametrize("name,vec_mode,rows", [
    ("sevennet0_layers1-3", True, 3_001), ("sevennet0_layer4", False, 50),
    ("l3i5_layers1-3", True, 2_117), ("odd_20_24", True, 10_007), ("odd_21_27", True, 880),
    ("odd_21_27", False, 64)])
def test_reduce_walk_matches_plain(name, vec_mode, rows):
    """The tiles and chunks walked as the kernel walks them give the plain
    version's sums (float64 on both sides), with NaN in every invalid
    record: every output written, nothing of an invalid row read."""
    op = OPS[name](vec_mode)
    rng = np.random.default_rng(rows)
    work = rng.normal(size=(rows, op.ws_layout["stride"]))
    valid = (rng.uniform(size=rows) < 0.8).astype(np.uint8)
    work[valid == 0] = np.nan
    got = _walk(op, work, valid)
    dws, dcoef = fc.param_grad_reduce_plain(op, torch.from_numpy(work), torch.from_numpy(valid))
    want = [*dws] + ([dcoef] if vec_mode else [])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-12, atol=1e-12 * float(w.abs().max()))
