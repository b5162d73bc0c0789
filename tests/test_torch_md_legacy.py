"""Large systems on a legacy model (unnormalized spherical harmonics, the
emb/sh conv of every checkpoint older than SevenNet 0.10) through the port,
against the JAX package: the calculator with every layer chunked (the
chunked scatter backward), and the MD engine in its default mode (the
chunked scatter backward, atoms unsorted) and under ``SEVENNET_TPU_RING=1``
(the ring backward at W = 1 on cell-sorted atoms), each with
``SEVENNET_TPU_CHUNK_THRESHOLD`` turned down so that a small box chunks.

The references are the JAX calculator and ``MDEngine(fused=False,
sort_atoms=False)`` on the CPU (the dense XLA conv, fp32 ``highest``), fed
the same numpy weights. The model is tests/test_torch_md.py's (8 channels,
lmax 1, 2 layers, cutoff 3.5 A, skin 0.1 A) with ``_normalize_sph:
False``, on 1,029 atoms of water: six cells a side, the fewest for which
the emb/sh ring (a chunk at least the mirror window, and at least three
chunks) can be sized. Tolerances are that file's (forces 5e-5
eV/A, kinetic energy 1e-4 eV, positions 1e-4 A after 3 steps of 1 fs), the
potential energy 1e-6 of its size (hundreds of eV: on 648
atoms fp32 sums in another order put the port's unchunked engine 1.8e-4 eV
from JAX's at 312 eV, as far as its chunked one), and tests/test_torch_model.py's for the calculator (energy
1e-5 relative, forces 1e-4 eV/A, stress 1e-6 eV/A^3).
"""

import jax
import numpy as np
import pytest
import torch

from bench import water_box
from sevennet_tpu.atoms import AtomsLite as JAtomsLite
from sevennet_tpu.calculator import SevenNetTPUCalculator
from sevennet_tpu.md import MDEngine as JMDEngine
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.io.convert import params_from_numpy
from sevennet_tpu_torch.md import MDEngine
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.model.model import _vec_mode, conv_row_chunk

torch.set_num_threads(1)
CFG = {"cutoff": 3.5, "channel": 8, "lmax": 1, "is_parity": False,
       "num_convolution_layer": 2, "self_connection_type": "linear",
       "conv_denominator": 35.0, "chemical_species": ["H", "O"], "_remat": False,
       "_normalize_sph": False}
SKIN, DT, STEPS, T0, SEED = 0.1, 1.0, 3, 300.0, 2
F_TOL, E_TOL, X_TOL, PE_REL_TOL = 5e-5, 1e-4, 1e-4, 1e-6


@pytest.fixture(scope="module")
def system():
    pos, Z, cell = water_box(343)
    jspec = j_build(CFG)
    jparams = model_init(jax.random.PRNGKey(1), jspec)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return dict(pos=pos, Z=Z, cell=cell, jspec=jspec, jparams=jparams, tree=tree, n=len(pos))


def test_legacy_calculator_chunked_matches_jax(system, monkeypatch):
    """The legacy model with every layer chunked (row chunks that do not
    divide the atoms: the padded scatter path) serves the JAX calculator's
    energy, per-atom energies, forces and stress."""
    s = system
    monkeypatch.setenv("SEVENNET_TPU_CHUNK_THRESHOLD", "1000")
    spec = build_model_spec(dict(CFG, _edge_chunk=2000))
    assert not _vec_mode(spec)
    ref = SevenNetTPUCalculator(s["jspec"], s["jparams"], fused=False, matmul_precision="highest")
    r = ref.calculate(JAtomsLite(positions=s["pos"], numbers=s["Z"], cell=s["cell"], pbc=True))
    port = SevenNetCalculator(spec, params_from_numpy(spec, s["tree"]), device="cpu")
    at = AtomsLite(positions=s["pos"], numbers=s["Z"], cell=s["cell"], pbc=True)
    g = port.graph(at)
    rc = conv_row_chunk(port.spec, g.n_atoms_cap, g.dense_k, spec.layers[0].conv.irreps_x.dim)
    assert 0 < rc < g.n_atoms_cap and g.n_atoms_cap % rc
    p = port.calculate(at)
    assert abs(p["energy"] - r["energy"]) <= 1e-5 * abs(r["energy"])
    np.testing.assert_allclose(p["energies"], r["energies"], atol=1e-5 * abs(r["energy"]))
    np.testing.assert_allclose(p["forces"], r["forces"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(p["stress"], r["stress"], atol=1e-6, rtol=0)
    assert np.abs(r["forces"]).max() > 1e-3


def _unsorted(state, n, name):
    a = getattr(state, name).cpu().numpy()
    idx = state.atom_index.cpu().numpy()
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    real = idx < n
    out[idx[real]] = a[real]
    return out


@pytest.mark.parametrize("ring", ["default", "ring"])
def test_legacy_engine_matches_jax(system, monkeypatch, ring):
    """``MDEngine`` with the legacy model above the (lowered) threshold: by
    default the ring stays off in emb/sh mode and every layer runs the
    chunked scatter backward on unsorted atoms; ``SEVENNET_TPU_RING=1``
    sorts the atoms and runs the ring at W = 1 with ``RC = max(edge_chunk
    // K, window)``. Either way the initial forces and energy and 3 NVE
    steps with device rebuilds match the JAX engine's."""
    s = system
    monkeypatch.setenv("SEVENNET_TPU_CHUNK_THRESHOLD", "100000")
    if ring == "ring":
        monkeypatch.setenv("SEVENNET_TPU_RING", "1")
    jeng = JMDEngine(s["jspec"], s["jparams"], s["cell"], skin=SKIN, fused=False,
                     sort_atoms=False)
    jst = jeng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
    f0, e0 = np.asarray(jst.forces)[:s["n"]], float(jst.potential_energy)
    jst, (jpe, jke) = jeng.run(jst, STEPS, dt=DT, chunk=STEPS)

    spec = build_model_spec(dict(CFG, _edge_chunk=512))
    eng = MDEngine(spec, params_from_numpy(spec, s["tree"]), s["cell"], skin=SKIN, device="cpu")
    st = eng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
    dim_x = max(layer.conv.irreps_x.dim for layer in spec.layers)
    assert all(conv_row_chunk(eng.spec, st.n_atoms_cap, eng.k_model, layer.conv.irreps_x.dim)
               for layer in spec.layers), dim_x
    if ring == "ring":
        window = int(np.ceil(eng._ring_margin * eng._ring_window))
        assert eng._ring_nb >= 3 and eng._ring_w == eng.spec.conv_ring == 1
        assert eng.row_chunk >= max(512 // eng.k_model, window)
        assert not torch.equal(st.atom_index[:s["n"]], torch.arange(s["n"]))
    else:
        assert eng._ring_nb == 0 and eng.spec.conv_ring == 0
        assert torch.equal(st.atom_index, torch.arange(st.n_atoms_cap))
    np.testing.assert_allclose(_unsorted(st, s["n"], "forces"), f0, atol=F_TOL)
    pe_tol = PE_REL_TOL * abs(e0)
    assert abs(float(st.potential_energy) - e0) < pe_tol
    rebuilds = eng.n_rebuilds
    st, (pe, ke) = eng.run(st, STEPS, dt=DT, chunk=STEPS)
    assert eng.n_rebuilds > rebuilds, "no device rebuild in the compared steps"
    np.testing.assert_allclose(_unsorted(st, s["n"], "positions"),
                               np.asarray(jst.positions)[:s["n"]], atol=X_TOL)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), atol=pe_tol)
    np.testing.assert_allclose(ke.numpy(), np.asarray(jke), atol=E_TOL)
