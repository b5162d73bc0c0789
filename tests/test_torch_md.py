"""The port's MD engine (``sevennet_tpu_torch/md``) against the JAX
package's (``sevennet_tpu/md``): the device cell-list rebuild, the engine's
initial forces and NVE trajectory (unsorted, and sorted with the ring
backward forced on), its sort order and ring window, capacity growth, and
energy conservation.

The reference is the JAX ``MDEngine(fused=False, sort_atoms=False)`` on the
CPU (the dense XLA conv, fp32 ``highest``), fed the same numpy weights
(``model_init`` carried across with ``params_from_numpy``). A narrow model
(8 channels, lmax 1, 2 layers, H and O, cutoff 3.5 A) on a water box of
648 atoms: five cells a side, so the ring backward can be sized (its window
is about 1.5 cell layers). The skin is 0.1 A, so the rebuild runs on the
device within the compared steps. Tolerances: forces 5e-5 eV/A, energy 1e-4 eV,
positions 1e-4 A after 3 steps of 1 fs (those of
tests/test_md.py:test_engine_ring_backward_matches_dense): fp32 on both
sides, sums in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import water_box
from sevennet_tpu.md import MDEngine as JMDEngine
from sevennet_tpu.md.neighbor import CellListSpec as JCellListSpec
from sevennet_tpu.md.neighbor import build_cell_list_spec as j_build_cl
from sevennet_tpu.md.neighbor import rebuild_neighbors as j_rebuild
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu_torch.io.convert import params_from_numpy
from sevennet_tpu_torch.md import MDEngine, build_cell_list_spec, rebuild_neighbors
from sevennet_tpu_torch.model.build import build_model_spec

torch.set_num_threads(1)
CFG = {"cutoff": 3.5, "channel": 8, "lmax": 1, "is_parity": False,
       "num_convolution_layer": 2, "self_connection_type": "linear",
       "conv_denominator": 35.0, "chemical_species": ["H", "O"], "_remat": False}
SKIN, DT, STEPS, T0, SEED = 0.1, 1.0, 3, 300.0, 2
F_TOL, E_TOL, X_TOL = 5e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def system():
    """Water box, both packages' specs and the same weights."""
    pos, Z, cell = water_box(216)
    jspec = j_build(dict(CFG, _edge_chunk=0))
    jparams = model_init(jax.random.PRNGKey(0), jspec)
    spec = build_model_spec(dict(CFG, _edge_chunk=0))
    params = params_from_numpy(spec, jax.tree_util.tree_map(np.asarray, jparams))
    return dict(pos=pos, Z=Z, cell=cell, jspec=jspec, jparams=jparams, spec=spec,
                params=params, n=len(pos))


@pytest.fixture(scope="module")
def reference(system):
    """The JAX engine: initial forces and energy, then positions and energies
    after STEPS NVE steps (input order)."""
    s = system
    eng = JMDEngine(s["jspec"], s["jparams"], s["cell"], skin=SKIN, fused=False,
                    sort_atoms=False)
    st = eng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
    out = dict(forces=np.asarray(st.forces)[:s["n"]], pe=float(st.potential_energy))
    st, (pe, ke) = eng.run(st, STEPS, dt=DT, chunk=STEPS)
    out.update(positions=np.asarray(st.positions)[:s["n"]], pe_traj=np.asarray(pe),
               ke_traj=np.asarray(ke))
    return out


def _unsorted(state, n, name):
    """Rows of ``state.<name>`` back in the input order (``atom_index``)."""
    a = getattr(state, name).cpu().numpy()
    idx = state.atom_index.cpu().numpy()
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    real = idx < n
    out[idx[real]] = a[real]
    return out


def _edge_set(dst, src, shift, mask):
    dst, src, shift, mask = (np.asarray(a) for a in (dst, src, shift, mask))
    return set(zip(dst[mask].tolist(), src[mask].tolist(),
                   *[np.rint(shift[mask, i]).astype(int).tolist() for i in range(3)]))


def _run_and_compare(system, reference, eng, start_state=None):
    s = system
    st = start_state or eng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
    np.testing.assert_allclose(_unsorted(st, s["n"], "forces"), reference["forces"], atol=F_TOL)
    assert abs(float(st.potential_energy) - reference["pe"]) < E_TOL
    rebuilds = eng.n_rebuilds
    st, (pe, ke) = eng.run(st, STEPS, dt=DT, chunk=STEPS)
    assert eng.n_rebuilds > rebuilds, "no device rebuild in the compared steps"
    np.testing.assert_allclose(_unsorted(st, s["n"], "positions"), reference["positions"],
                               atol=X_TOL)
    np.testing.assert_allclose(pe.numpy(), reference["pe_traj"], atol=E_TOL)
    np.testing.assert_allclose(ke.numpy(), reference["ke_traj"], atol=E_TOL)
    return st


@pytest.mark.parametrize("case", ["default", "small_neighbors", "small_cells"])
def test_rebuild_neighbors_matches_jax(case):
    """The device cell list against the JAX one on a water box of 240 atoms:
    the same specs (the JAX one without its edge compaction, which the
    port's dense slot grid does not have), the same slot grid and the same
    overflow flags, also with a deliberately small neighbour or cell
    capacity."""
    pos, _, cell = water_box(80)
    n = len(pos)
    spec = build_cell_list_spec(cell, n, 5.0, 0.6)
    jspec = dataclasses.replace(j_build_cl(cell, n, 5.0, 0.6), edge_cap=0)
    assert JCellListSpec(**dataclasses.asdict(spec)) == jspec
    if case != "default":
        small = dict(neighbor_capacity=24) if case == "small_neighbors" else dict(cell_capacity=5)
        spec = dataclasses.replace(spec, **small)
        jspec = dataclasses.replace(jspec, **small)
    got = rebuild_neighbors(spec, torch.tensor(pos, dtype=torch.float32),
                            torch.tensor(cell, dtype=torch.float32), torch.ones(n, dtype=torch.bool))
    want = j_rebuild(jspec, jnp.asarray(pos, jnp.float32), jnp.asarray(cell, jnp.float32),
                     jnp.ones(n, bool))
    src, dst, shift, mask, ofl, pos_w = got
    jsrc, jdst, jshift, jmask, jofl, jpos_w = (np.asarray(a) for a in want)
    assert bool(ofl) == bool(jofl)
    assert bool(ofl) or case == "default"
    np.testing.assert_allclose(pos_w.numpy(), jpos_w, atol=1e-5)
    for a, b in ((src, jsrc), (dst, jdst), (shift, jshift), (mask, jmask)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_engine_matches_jax(system, reference):
    """``MDEngine(device="cpu")``: initial forces and energy, and 3 NVE steps
    with device rebuilds, against the JAX engine; then the device-rebuilt
    slots against a host build at the same positions."""
    s = system
    eng = MDEngine(s["spec"], s["params"], s["cell"], skin=SKIN, device="cpu")
    st = _run_and_compare(system, reference, eng)
    # the ring stays off, and so the atoms keep the input order
    assert eng._ring_nb == 0 and torch.equal(st.atom_index, torch.arange(st.n_atoms_cap))
    _check_slots_match_host(eng, st)


def _check_slots_match_host(eng, st):
    """The slots of the last device rebuild hold, row by row, the same
    ``(src, shift)`` set as a host build at the same positions, and every
    mirror points back (``src[mir[e]]`` is the row of ``e``, shift negated,
    ``mir[mir[e]] == e``)."""
    n_cap, K = st.n_atoms_cap, eng.k_model
    host = eng._host_initial_edges(st.nl_positions.numpy()[: int(st.atom_mask.sum())], n_cap)
    assert host is not None
    rows = np.repeat(np.arange(n_cap), K)
    dev = (rows, st.edge_src.numpy(), st.edge_shift.numpy(), st.edge_mask.numpy())
    assert _edge_set(*dev) == _edge_set(rows, host["src"], host["shift"], host["mask"])
    mask, mir = st.edge_mask.numpy(), st.edge_mir.numpy()
    e = np.flatnonzero(mask)
    assert (st.edge_src.numpy()[mir[e]] == rows[e]).all()
    np.testing.assert_array_equal(st.edge_shift.numpy()[mir[e]], -st.edge_shift.numpy()[e])
    assert (mir[mir[e]] == e).all()


def test_engine_with_ring_matches_jax(system, reference, monkeypatch):
    """The ring forced on (``SEVENNET_TPU_CHUNK_THRESHOLD`` down, edge chunk
    512 slots): the engine sorts the atoms and runs the ring backward
    through every layer; its forces and trajectory, unsorted with
    ``atom_index``, match the unsorted JAX engine. The host sort order and
    ring window equal the JAX engine's, and the device sort keeps the
    host's order; a ring-only growth keeps the physics."""
    monkeypatch.setenv("SEVENNET_TPU_CHUNK_THRESHOLD", "100000")
    s = system
    spec = build_model_spec(dict(CFG, _edge_chunk=512))
    eng = MDEngine(spec, s["params"], s["cell"], skin=SKIN, device="cpu")
    st = eng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
    assert eng._ring_nb >= 3 and eng.spec.conv_ring == eng._ring_w
    assert not torch.equal(st.atom_index[: s["n"]], torch.arange(s["n"]))  # sorted by cell
    assert st.n_atoms_cap == eng._ring_nb * eng.row_chunk >= s["n"]

    jeng = JMDEngine(j_build(dict(CFG, _edge_chunk=512)), s["jparams"], s["cell"], skin=SKIN,
                     fused=False)
    jeng.cl_spec = JCellListSpec(**dataclasses.asdict(eng.cl_spec))
    pos_w = eng._wrap(np.asarray(s["pos"], np.float64))
    np.testing.assert_array_equal(eng._host_sort_perm(pos_w), jeng._host_sort_perm(pos_w))
    from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy

    dst, src, _ = neighbor_list_numpy(pos_w, CFG["cutoff"] + SKIN, s["cell"], (True,) * 3)
    assert eng._host_window(pos_w, dst, src) == jeng._host_window(pos_w, dst, src) > 0
    assert torch.equal(eng._sort_state(st).atom_index, st.atom_index)

    st = _run_and_compare(system, reference, eng, start_state=st)
    _check_slots_match_host(eng, st)
    margin = eng._ring_margin
    grown = eng._grow_capacities(st, ring_only=True)
    assert eng._ring_margin > margin and not bool(grown.ring_overflow)
    np.testing.assert_allclose(_unsorted(grown, s["n"], "forces"),
                               _unsorted(st, s["n"], "forces"), atol=F_TOL)


@pytest.mark.parametrize("case", ["cells", "slots"])
def test_capacity_growth_matches_jax(system, reference, monkeypatch, case):
    """Undersized capacities, and the trajectory still matches the JAX
    engine's. ``cells``: half the cell capacity; the first device rebuild
    overflows and the chunk is retried from its snapshot with grown
    capacities. ``slots``: K from a 0.6 margin (``SEVENNET_TPU_KMARGIN``)
    drops edges inside the cutoff, so ``make_state`` falls back from the
    host build to the device rebuild and grows K there."""
    s = system
    small = None
    if case == "cells":
        small = build_cell_list_spec(s["cell"], s["n"], CFG["cutoff"], SKIN)
        small = dataclasses.replace(small, cell_capacity=small.cell_capacity // 2)
    else:
        monkeypatch.setenv("SEVENNET_TPU_KMARGIN", "0.6")
    eng = MDEngine(s["spec"], s["params"], s["cell"], skin=SKIN, cl_spec=small, device="cpu")
    st = _run_and_compare(system, reference, eng)
    assert eng.n_growths > 0 and not bool(st.nl_overflow)
    if case == "cells":
        assert eng.cl_spec.cell_capacity > small.cell_capacity


def test_nve_conserves_energy(system):
    """Total energy of 20 NVE steps drifts little, and less at half the
    timestep (velocity Verlet: about 4x less)."""
    s = system
    drifts = []
    for dt in (0.5, 0.25):
        eng = MDEngine(s["spec"], s["params"], s["cell"], device="cpu")
        st = eng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
        e0 = float(st.potential_energy + st.kinetic_energy())
        _, (pe, ke) = eng.run(st, 20, dt=dt, chunk=10)
        drifts.append(float((pe + ke - e0).abs().max()))
    assert drifts[0] < 2e-3, drifts
    assert drifts[1] < 0.5 * drifts[0], drifts


def test_trajectory_and_refusals(system, tmp_path, monkeypatch):
    """Trajectory frames keep the input order; integrators other than NVE
    and D3 raise; without CUDA the engine refuses to drift to the CPU."""
    from sevennet_tpu_torch.data.extxyz import read_extxyz

    s = system
    eng = MDEngine(s["spec"], s["params"], s["cell"], device="cpu")
    st = eng.make_state(s["pos"], s["Z"])
    path = str(tmp_path / "traj.extxyz")
    st, _ = eng.run(st, 4, dt=0.5, chunk=2, traj_path=path)
    frames = read_extxyz(path)
    assert len(frames) == 3
    np.testing.assert_array_equal(frames[0].numbers, s["Z"])
    np.testing.assert_allclose(frames[-1].positions, _unsorted(st, s["n"], "positions"),
                               atol=1e-6)
    with pytest.raises(NotImplementedError, match="A11"):
        eng.run(st, 1, integrator="langevin")
    with pytest.raises(NotImplementedError, match="A8"):
        MDEngine(s["spec"], s["params"], s["cell"], d3={"functional": "pbe"}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MDEngine(s["spec"], s["params"], s["cell"])
