"""The port's MD engine with D3 dispersion (``MDEngine(d3=...)``) against the
JAX package's ``MDEngine(fused=False, d3=...)``, on the CPU, on the 16-atom
Hf/O box of tests/test_d3.py:149-195 (L = 9.6 A).

A narrow model (8 channels, lmax 1, 2 layers, Hf and O, cutoff 4 A) with the
JAX ``model_init`` weights carried across (``params_from_numpy``); the
port's engine runs the conv's plain version (``plain=True``). The skin is
0.1 A, so that the D3 grid (cutoff 9.5 A, bounded by the box) is rebuilt on
the device within the compared steps. Tolerances: forces 5e-5 eV/A, energy
1e-4 eV, positions 1e-4 A after 10 NVE steps of 1 fs, the NPT cell 1e-6
relative; the engine's D3 part against ``D3Calculator`` at the engine's
cutoff 5e-5 eV and eV/A (those of tests/test_d3.py:test_d3_in_md_engine).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sevennet_tpu.md import MDEngine as JMDEngine
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.d3 import D3Calculator
from sevennet_tpu_torch.io.convert import params_from_numpy
from sevennet_tpu_torch.md import MDEngine
from sevennet_tpu_torch.model.build import build_model_spec
from tests.test_torch_d3 import hfo_box

torch.set_num_threads(1)
CFG = {"cutoff": 4.0, "channel": 8, "lmax": 1, "is_parity": False,
       "num_convolution_layer": 2, "self_connection_type": "linear",
       "conv_denominator": 20.0, "chemical_species": ["Hf", "O"], "_remat": False}
D3 = {"functional": "pbe", "damping": "damp_bj"}
SKIN, DT, STEPS, NPT_STEPS, T0, SEED = 0.1, 1.0, 10, 3, 600.0, 4
F_TOL, E_TOL, X_TOL, D3_TOL, C_REL = 5e-5, 1e-4, 1e-4, 5e-5, 1e-6


@pytest.fixture(scope="module")
def system():
    pos, Z, cell = hfo_box()
    jspec = j_build(CFG)
    jparams = model_init(jax.random.PRNGKey(2), jspec)
    spec = build_model_spec(CFG)
    params = params_from_numpy(spec, jax.tree_util.tree_map(np.asarray, jparams))
    return dict(pos=pos, Z=Z, cell=cell, jspec=jspec, jparams=jparams, spec=spec,
                params=params, n=len(pos))


@pytest.fixture(scope="module")
def reference(system):
    """The JAX engine with D3: its D3 parameters, initial forces and energy,
    then positions and energies after STEPS NVE steps."""
    s = system
    eng = JMDEngine(s["jspec"], s["jparams"], s["cell"], skin=SKIN, fused=False,
                    sort_atoms=False, d3=D3)
    st = eng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
    out = dict(d3_params=eng.d3_params, forces=np.asarray(st.forces)[:s["n"]],
               pe=float(st.potential_energy))
    st, (pe, ke) = eng.run(st, STEPS, dt=DT, chunk=STEPS)
    out.update(positions=np.asarray(st.positions)[:s["n"]], pe_traj=np.asarray(pe),
               ke_traj=np.asarray(ke))
    return out


def _engine(system, d3=D3):
    s = system
    return MDEngine(s["spec"], s["params"], s["cell"], skin=SKIN, d3=d3, device="cpu",
                    plain=True)


def _run_and_compare(system, reference, eng, st):
    s = system
    np.testing.assert_allclose(st.forces[: s["n"]].numpy(), reference["forces"], atol=F_TOL)
    assert abs(float(st.potential_energy) - reference["pe"]) < E_TOL
    rebuilds = eng.n_rebuilds
    st, (pe, ke) = eng.run(st, STEPS, dt=DT, chunk=STEPS)
    assert eng.n_rebuilds > rebuilds, "no device rebuild in the compared steps"
    np.testing.assert_allclose(st.positions[: s["n"]].numpy(), reference["positions"],
                               atol=X_TOL)
    np.testing.assert_allclose(pe.numpy(), reference["pe_traj"], atol=E_TOL)
    np.testing.assert_allclose(ke.numpy(), reference["ke_traj"], atol=E_TOL)
    assert torch.isfinite(st.positions).all() and torch.isfinite(st.forces).all()
    return st


def test_engine_with_d3_matches_jax(system, reference):
    """The chosen D3 parameters (cutoff 9.6 - skin - 1e-6 A, bounded by the
    box), the initial energy and forces, and 10 NVE steps with device
    rebuilds of both grids, against the JAX engine; the D3 grid of the last
    rebuild holds the host list's pairs."""
    s = system
    eng = _engine(system)
    assert dataclasses.asdict(eng.d3_params) == dataclasses.asdict(reference["d3_params"])
    assert eng.d3_params.cutoff < s["cell"][0, 0] - SKIN
    st = eng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
    n_cap, K3 = st.n_atoms_cap, eng.d3_cl_spec.neighbor_capacity
    assert st.d3_edge_src.shape == (n_cap * K3,) and st.z_numbers.tolist() == s["Z"].tolist()
    st = _run_and_compare(system, reference, eng, st)
    from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy

    dst, src, sh = neighbor_list_numpy(st.nl_positions.numpy(), eng.d3_params.cutoff + SKIN,
                                       s["cell"], (True,) * 3)
    m = st.d3_edge_mask.numpy()
    got = set(zip(st.d3_edge_dst.numpy()[m].tolist(), st.d3_edge_src.numpy()[m].tolist(),
                  *np.rint(st.d3_edge_shift.numpy()[m]).astype(int).T.tolist()))
    assert got == set(zip(dst.tolist(), src.tolist(), *np.rint(sh).astype(int).T.tolist()))


def test_engine_d3_term_equals_the_d3_calculator(system):
    """The D3 engine's initial energy, forces and stress less the no-D3
    engine's equal ``D3Calculator(cutoff_ang=engine cutoff)``: 5e-5 eV,
    eV/A, and 1e-4 of the largest stress term (tests/test_d3.py:149-195)."""
    s = system
    eng0, eng3 = _engine(system, d3=None), _engine(system)
    assert eng0.d3_params is None
    st0, st3 = (e.make_state(s["pos"], s["Z"]) for e in (eng0, eng3))
    assert st0.z_numbers is None and st0.d3_edge_src is None
    at = AtomsLite(positions=s["pos"], numbers=s["Z"], cell=s["cell"], pbc=True)
    res = D3Calculator(cutoff_ang=eng3.d3_params.cutoff, device="cpu").calculate(at)
    assert abs(float(st3.potential_energy - st0.potential_energy) - res["energy"]) < D3_TOL
    f_d3 = (st3.forces - st0.forces)[: s["n"]].numpy()
    np.testing.assert_allclose(f_d3, res["forces"], atol=D3_TOL)
    # model order (xx, yy, zz, xy, yz, zx) from the calculator's ASE Voigt
    want = -res["stress"][[0, 1, 2, 5, 3, 4]]
    np.testing.assert_allclose((st3.stress - st0.stress).numpy(), want,
                               atol=1e-4 * np.abs(want).max())


def test_d3_capacity_growth_keeps_the_trajectory(system, reference):
    """A D3 slot width cut below the system's need after ``make_state``: the
    first device rebuild overflows, the chunk is retried from its snapshot
    with grown capacities, and the trajectory still matches the JAX
    engine's."""
    s = system
    eng = _engine(system)
    st = eng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
    need = int(st.d3_edge_mask.view(st.n_atoms_cap, -1).sum(1).max())
    assert eng.d3_cl_spec.neighbor_capacity >= need
    eng.d3_cl_spec = dataclasses.replace(eng.d3_cl_spec, neighbor_capacity=need - 4)
    _run_and_compare(system, reference, eng, st)
    assert eng.n_growths >= 1 and eng.d3_cl_spec.neighbor_capacity >= need


def test_npt_with_d3_matches_jax(system):
    """``npt`` (MTK) with D3 against the JAX engine's, 3 steps from the same
    state: positions 1e-4 A, energies 1e-4 eV, the cell 1e-6 relative (the
    limits of tests/test_torch_integrators.py). The barostat sees the D3
    virial: the same run with the D3 term left out of every evaluation's
    stress ends on another cell, beyond that limit."""
    s = system
    kw = dict(integrator="npt", temperature=T0, pressure=0.0, tau_t=100.0, tau_p=20.0)
    jeng = JMDEngine(s["jspec"], s["jparams"], s["cell"], skin=SKIN, fused=False,
                     sort_atoms=False, d3=D3)
    jst, (jpe, _) = jeng.run(jeng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED),
                             NPT_STEPS, dt=DT, chunk=NPT_STEPS, **kw)
    want = np.asarray(jst.cell)
    eng = _engine(system)
    start = eng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
    st, (pe, _) = eng.run(start, NPT_STEPS, dt=DT, chunk=NPT_STEPS, **kw)
    assert torch.isfinite(st.positions).all() and float(st.volume()) != float(start.volume())
    np.testing.assert_allclose(st.positions[: s["n"]].numpy(), np.asarray(jst.positions)[: s["n"]],
                               atol=X_TOL)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), atol=E_TOL)
    np.testing.assert_allclose(st.cell.numpy(), want, atol=C_REL * np.abs(want).max())

    forces = eng._forces

    def without_d3_stress(state, compute_stress=False):
        f, e, _ = forces(state, compute_stress)
        d3, eng.d3_params = eng.d3_params, None
        try:
            return f, e, forces(state, compute_stress)[2]
        finally:
            eng.d3_params = d3

    eng._forces = without_d3_stress
    blind, _ = eng.run(start, NPT_STEPS, dt=DT, chunk=NPT_STEPS, **kw)
    assert np.abs(blind.cell.numpy() - want).max() > 10 * C_REL * np.abs(want).max()


def test_shrinking_box_narrows_the_skin_then_raises(system, monkeypatch):
    """The D3 grid (one cell) covers pairs to its cell's height: a box that
    shrinks by less than the skin narrows the rebuild test's skin to what is
    left (so the list stays complete to the cutoff); one that shrinks below
    the D3 cutoff raises, since no capacity growth can help. The engine's
    slots are not cut (a slot margin at which K is the list's capacity), so
    that the D3 grid's cover alone narrows the test; the smaller of the two
    limits is tests/test_torch_md_slots.py's."""
    s = system
    monkeypatch.setenv("SEVENNET_TPU_KMARGIN", "3.0")
    eng = _engine(system)
    st = eng.make_state(s["pos"], s["Z"], temperature=T0, seed=SEED)
    assert eng.k_model == eng.cl_spec.neighbor_capacity
    assert eng.d3_cl_spec.n_cells == (1, 1, 1)
    assert float(eng._skin_half_sq(st)) == pytest.approx((SKIN / 2) ** 2, rel=1e-4)
    L = s["cell"][0, 0]
    for shrink in (0.05, 0.2):
        scale = (L - shrink) / L
        small = st.replace(cell=st.cell * scale, positions=st.positions * scale,
                           nl_positions=st.nl_positions * scale)
        cover = (L - shrink) - eng.d3_params.cutoff
        if cover > 0:
            assert float(eng._skin_half_sq(small)) == pytest.approx((cover / 2) ** 2, rel=1e-3)
            assert float(eng._skin_half_sq(small)) < (SKIN / 2) ** 2
        else:
            assert float(eng._skin_half_sq(small)) == 0.0
            with pytest.raises(RuntimeError, match="below the D3 cutoff"):
                eng.run(small, 2, dt=DT, chunk=2)
