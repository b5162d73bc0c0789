"""The port's domain-decomposed evaluation and MD on ``torch.distributed``
(``sevennet_tpu_torch/parallel``) against the JAX package.

Ranks are spawned processes on ``gloo`` with a ``file://`` rendezvous in
the test's directory (tests/torch_parallel_worker.py); each is joined with
a timeout of its own, so a hang fails the test. One spawn of 2 ranks and
one of 4 run every job of their size; the tests read the jobs' results.

- ``distributed_compute`` on 2 ranks against the JAX ``distributed_compute``
  on a 2-device CPU mesh (the root conftest gives 8 host devices), with the
  ext conv's plain version and with its kernels' CPU twins: energy 1e-5
  relative, forces of each atom 1e-4 eV/A, stress 1e-6 eV/A^3 (the
  tolerances of tests/test_torch_model.py).
- ``DistributedMDEngine`` NVE on 4 ranks, ``dims=(4,)`` and ``(2, 1, 2)``
  (three stages, one of extent 1), 20 steps of a system hot enough to
  migrate, and on one rank in this process, against the JAX serial
  ``MDEngine(fused=False, sort_atoms=False)``: PE and KE within 5e-3 x
  max(1, |E|), atoms conserved, positions as sets within 5e-3 A, each to
  its nearest image (the limits of tests/test_parallel.py:180-194); the
  4-rank runs also against the port's serial engine, at the distributed
  slot margin and at its own default, PE and KE within 1e-4 eV and each
  atom within 1e-4 A (a migration that leaves the forces behind, as the
  JAX engine's does, fails this, and so does an engine that misses a cut
  pair that closes in between rebuilds).
- ``nose_hoover``, ``npt`` (``scale_budget=0.9``), D3 and a triclinic cell
  on 4 ranks (``dims=(2, 2)``) against the port's serial ``MDEngine``
  (itself held against JAX by tests/test_torch_integrators.py and
  tests/test_torch_md_d3.py), at the same limits, and the stress of
  ``compute_stress`` within 1e-4 of max |stress|.
- The skin test under ``npt`` on one rank in this process: the limit
  narrows by the cell's scale since the build to ``(max(0, s (cutoff + m) -
  cutoff) / 2)^2`` (float64 host formula, 1e-5 relative; the limit's bits
  at s = 1), a displacement between the two limits rebuilds only in the
  shrunk cell, and a scale below ``scale_budget`` raises before the step
  evaluates.
- ``langevin`` and ``nose_hoover`` heat a cold system toward the target
  (tests/test_parallel.py:197-241); capacities too small raise the overflow
  ``RuntimeError``; the halo exchange alone passes ``gradcheck`` in float64
  on 2 ranks, over one stage and over two (the first of extent 1).
"""

import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sevennet_tpu.md import MDEngine as JMDEngine
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu.parallel import distributed_compute as j_distributed_compute
from sevennet_tpu.parallel import partition_system as j_partition
from sevennet_tpu_torch.io.convert import params_from_numpy
from sevennet_tpu_torch.md import MDEngine
from sevennet_tpu_torch.md.state import ATOMIC_MASSES, KB_EV, thermal_velocities
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.parallel import DistributedMDEngine
from sevennet_tpu_torch.parallel.md import K_MARGIN

from . import torch_parallel_worker

torch.set_num_threads(1)
MODEL = {"cutoff": 3.0, "channel": 8, "lmax": 1, "is_parity": False, "num_convolution_layer": 2,
         "irreps_manual": ["8x0e", "8x0e+4x1e", "8x0e"], "weight_nn_hidden_neurons": [8, 8],
         "radial_basis": {"radial_basis_name": "bessel", "bessel_basis_num": 4},
         "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 2.5},
         "chemical_species": ["H", "O"], "self_connection_type": "linear",
         "conv_denominator": 8.0}
N, BOX, SKIN, STEPS, T_HOT, JOIN_S = 64, 14.0, 0.4, 20, 1500.0, 120
D3 = {"functional": "pbe", "damping": "damp_bj", "cutoff": 3.0}
TRICLINIC = np.array([[14.0, 0.0, 0.0], [3.0, 14.0, 0.0], [-2.0, 1.5, 14.0]])


def _traj_close(got, want):
    assert np.abs(got - want).max() < 5e-3 * max(1.0, np.abs(want).max()), (
        np.abs(got - want).max())


def _sorted_close(got, want, cell):
    """The same atoms within 5e-3 A as sets, each to its nearest image: an
    atom that crossed the box is wrapped only at a rebuild, and the engines
    rebuild at steps of their own. Every atom of ``got`` pairs with the
    nearest of ``want``, one to one."""
    frac = (got[:, None, :] - want[None, :, :]) @ np.linalg.inv(cell)
    d = np.linalg.norm((frac - np.round(frac)) @ cell, axis=-1)
    match = d.argmin(1)
    assert len(got) == len(want) and sorted(match) == list(range(len(want)))
    np.testing.assert_allclose(d[np.arange(len(got)), match], 0.0, atol=5e-3)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, BOX, (N, 3))
    Z = np.where(rng.random(N) < 0.5, 1, 8)
    jspec = j_build(MODEL)
    tree = jax.tree_util.tree_map(np.asarray, model_init(jax.random.PRNGKey(0), jspec))
    spec = build_model_spec(MODEL)
    return dict(pos=pos, Z=Z, cell=np.eye(3) * BOX, tree=tree, jspec=jspec, spec=spec,
                params=params_from_numpy(spec, tree),
                vel=thermal_velocities(ATOMIC_MASSES[Z], T_HOT, 1),
                tri_pos=rng.uniform(0, 1, (N, 3)) @ TRICLINIC)


def _spawn(world, jobs, tmp):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_parallel_worker.run_rank,
                         args=(r, world, f"file://{tmp / 'rendezvous'}", jobs, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    out = {}
    for name in jobs:
        res = dict(np.load(tmp / f"{name}.npz"))
        out[name] = res
    return out


def _result(results, name):
    res = results[name]
    assert "error" not in res, str(res["error"])
    return res


def _engine_job(s, dims, **kw):
    job = dict(kind="engine", model=MODEL, tree=s["tree"], cell=s["cell"], dims=dims,
               positions=s["pos"], numbers=s["Z"], velocities=s["vel"], steps=STEPS,
               engine_kw=dict(skin=SKIN), stress=True)
    job.update(kw)
    return job


@pytest.fixture(scope="module")
def two_ranks(system, tmp_path_factory):
    s = system
    jobs = {
        "compute": dict(kind="compute", model=MODEL, tree=s["tree"], cell=s["cell"],
                        positions=s["pos"], numbers=s["Z"], world=2),
        "gradcheck_1": dict(kind="gradcheck", dims=(2,)),
        "gradcheck_2": dict(kind="gradcheck", dims=(1, 2)),
    }
    return _spawn(2, jobs, tmp_path_factory.mktemp("two_ranks"))


@pytest.fixture(scope="module")
def four_ranks(system, tmp_path_factory):
    s = system
    cold = dict(velocities=None, temperature=100.0, seed=3, steps=80, chunk=40, stress=False)
    jobs = {
        "nve_4": _engine_job(s, (4,)),
        "nve_212": _engine_job(s, (2, 1, 2)),
        "nvt": _engine_job(s, (2, 2), integrator="nose_hoover",
                           run_kw=dict(temperature=300.0, tau=25.0)),
        "npt": _engine_job(s, (2, 2), integrator="npt", run_kw=dict(temperature=300.0),
                           engine_kw=dict(skin=SKIN, scale_budget=0.9)),
        "d3": _engine_job(s, (2, 2), engine_kw=dict(skin=SKIN, d3=D3)),
        "triclinic": _engine_job(s, (2, 2), cell=TRICLINIC, positions=s["tri_pos"]),
        "heat_nvt": _engine_job(s, (2, 2), integrator="nose_hoover",
                                run_kw=dict(temperature=500.0, tau=25.0), **cold),
        "heat_langevin": _engine_job(s, (2, 2), integrator="langevin",
                                     run_kw=dict(temperature=500.0, friction=0.05), **cold),
        "overflow": dict(_engine_job(s, (2, 2), engine_kw=dict(skin=SKIN, ghost_caps=(2, 2))),
                         kind="overflow", steps=2),
    }
    return _spawn(4, jobs, tmp_path_factory.mktemp("four_ranks"))


@pytest.fixture(scope="module")
def jax_serial(system):
    """The JAX serial engine's NVE run of the hot system (input order)."""
    s = system
    eng = JMDEngine(s["jspec"], jax.tree_util.tree_map(jnp.asarray, s["tree"]), s["cell"],
                    skin=SKIN, fused=False, sort_atoms=False, matmul_precision="highest")
    st = eng.make_state(s["pos"], s["Z"])
    st = st.replace(velocities=jnp.asarray(s["vel"], jnp.float32))
    st, (pe, ke) = eng.run(st, STEPS, dt=1.0, chunk=10)
    return dict(pe=np.asarray(pe), ke=np.asarray(ke), positions=np.asarray(st.positions)[:N],
                cell=s["cell"])


def _port_serial(s, integrator="nve", cell=None, pos=None, d3=None, **run_kw):
    cell = s["cell"] if cell is None else cell
    eng = MDEngine(s["spec"], s["params"], cell, skin=SKIN, device="cpu", d3=d3)
    st = eng.make_state(s["pos"] if pos is None else pos, s["Z"])
    st = st.replace(velocities=torch.as_tensor(s["vel"], dtype=torch.float32))
    st, (pe, ke) = eng.run(st, STEPS, dt=1.0, chunk=10, integrator=integrator, **run_kw)
    _, e, stress = eng._forces(st, compute_stress=True)
    order = np.argsort(st.atom_index.numpy()[:N])
    return dict(pe=pe.numpy(), ke=ke.numpy(), positions=st.positions.numpy()[:N][order],
                stress=stress.numpy(), energy=float(e), cell=cell)


@pytest.fixture(scope="module")
def port_serial_k(system):
    """The port's serial NVE run of the hot system with the distributed
    engine's slot margin (``K_MARGIN``)."""
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv("SEVENNET_TPU_KMARGIN", str(K_MARGIN))
        return _port_serial(system)


@pytest.fixture(scope="module")
def port_serial(system):
    """The port's serial NVE run of the hot system at its default slot
    margin: it cuts more slots than the distributed engine, and both keep
    every pair within the cutoff."""
    return _port_serial(system)


def _check_engine(res, want, migrated=True):
    _traj_close(res["pe"], want["pe"])
    _traj_close(res["ke"], want["ke"])
    assert int(res["n_atoms"]) == N
    _sorted_close(res["positions"], want["positions"], want["cell"])
    if migrated:
        assert int(res["n_migrated"]) > 0


@pytest.mark.parametrize("fused", ["plain", "fused"])
def test_distributed_compute_two_ranks_matches_jax_mesh(system, two_ranks, fused):
    s = system
    res = _result(two_ranks, "compute")
    species = s["jspec"].z_to_type[s["Z"]]
    jdd = j_partition(s["pos"], species, s["cell"], MODEL["cutoff"], 2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dd",))
    want = j_distributed_compute(s["jspec"], jax.tree_util.tree_map(jnp.asarray, s["tree"]),
                                 jdd, mesh)
    e_want = float(want["energy"])
    assert abs(float(res[f"energy_{fused}"]) - e_want) <= 1e-5 * abs(e_want)
    # rank 0's rows, mapped to global atoms through owner_global_idx
    f_want = np.asarray(want["forces"])[0]
    gidx = jdd.owner_global_idx[0]
    real = gidx >= 0
    np.testing.assert_allclose(res[f"forces_{fused}"][real], f_want[real], rtol=0, atol=1e-4)
    np.testing.assert_allclose(res[f"atomic_energy_{fused}"][real],
                               np.asarray(want["atomic_energy"])[0][real], rtol=0, atol=1e-5)
    np.testing.assert_allclose(res[f"stress_{fused}"], np.asarray(want["stress"]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["gradcheck_1", "gradcheck_2"])
def test_halo_exchange_gradcheck_two_ranks(two_ranks, name):
    res = _result(two_ranks, name)
    assert bool(res["ok"])
    assert int(res["swaps"]) > 0


@pytest.mark.parametrize("name", ["nve_4", "nve_212"])
def test_distributed_nve_matches_jax_serial(four_ranks, jax_serial, name):
    _check_engine(_result(four_ranks, name), jax_serial)


@pytest.mark.parametrize("name, serial", [
    pytest.param("nve_4", "port_serial_k", id="nve_4"),
    pytest.param("nve_212", "port_serial_k", id="nve_212"),
    pytest.param("nve_4", "port_serial", id="nve_4-default_margin"),
    pytest.param("nve_212", "port_serial", id="nve_212-default_margin")])
def test_distributed_nve_tracks_serial_atom_by_atom(system, four_ranks, request, name, serial):
    """Tighter than the JAX package's limits, which a half-kick with
    another atom's forces after a migration would pass: PE and KE within
    1e-4 eV of the port's serial engine, at the same slot margin and at
    its own, each atom within 1e-4 A of its serial twin (nearest image)."""
    res, want = _result(four_ranks, name), request.getfixturevalue(serial)
    assert int(res["n_migrated"]) > 0
    assert np.abs(res["pe"] - want["pe"]).max() <= 1e-4, np.abs(res["pe"] - want["pe"]).max()
    assert np.abs(res["ke"] - want["ke"]).max() <= 1e-4, np.abs(res["ke"] - want["ke"]).max()
    cell = system["cell"]
    frac = (res["positions_ordered"] - want["positions"]) @ np.linalg.inv(cell)
    dx = np.abs((frac - np.round(frac)) @ cell).max()
    assert dx <= 1e-4, dx


@pytest.mark.parametrize("fused", [False, True])
def test_world_one_matches_jax_serial(system, jax_serial, fused):
    """``dims=(1,)`` in this process, without a process group: one domain,
    no ghosts, no migration (the JAX engine's degenerate mesh)."""
    s = system
    eng = DistributedMDEngine(s["spec"], s["params"], s["cell"], dims=(1,), skin=SKIN,
                              device="cpu", fused=fused)
    st = eng.make_state(s["pos"], s["Z"], velocities=s["vel"])
    assert not bool(st.nl_overflow)
    st, (pe, ke) = eng.run(st, STEPS, dt=1.0, chunk=10)
    res = dict(pe=pe.numpy(), ke=ke.numpy(), positions=eng.gather_positions(st),
               n_atoms=st.atom_mask.sum().numpy())
    _check_engine(res, jax_serial, migrated=False)
    assert eng.n_migrated == 0 and eng.halo.n_swaps == 0


@pytest.mark.parametrize("name", ["nvt", "npt", "d3", "triclinic"])
def test_distributed_ensembles_match_serial(system, four_ranks, name):
    s = system
    res = _result(four_ranks, name)
    if name == "nvt":
        want = _port_serial(s, "nose_hoover", temperature=300.0, tau=25.0)
    elif name == "npt":
        want = _port_serial(s, "npt", temperature=300.0)
        assert float(res["cell_scale"]) != 1.0
    elif name == "d3":
        want = _port_serial(s, d3=D3)
    else:
        want = _port_serial(s, cell=TRICLINIC, pos=s["tri_pos"])
    _check_engine(res, want)
    assert abs(float(res["stress_e"]) - want["energy"]) < 5e-3 * max(1.0, abs(want["energy"]))
    smax = np.abs(want["stress"]).max()
    np.testing.assert_allclose(res["stress"], want["stress"], rtol=0, atol=1e-4 * smax)


@pytest.mark.parametrize("name", ["heat_nvt", "heat_langevin"])
def test_distributed_thermostats_heat(four_ranks, name):
    res = _result(four_ranks, name)
    T = 2 * res["ke"] / (3 * N * KB_EV)
    assert T[-1] > 250.0, T[-1]  # heated well past 100 K toward 500 K
    assert np.isfinite(res["pe"]).all()
    assert int(res["n_atoms"]) == N


def test_small_capacities_raise_overflow(four_ranks):
    res = _result(four_ranks, "overflow")
    assert "distributed MD overflow" in str(res["raised"])


def test_engine_refuses_the_cpu_without_asking(system, monkeypatch):
    s = system
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedMDEngine(s["spec"], s["params"], s["cell"])
    with pytest.raises(RuntimeError, match="need 4 ranks"):
        DistributedMDEngine(s["spec"], s["params"], s["cell"], dims=(2, 2), device="cpu")


def test_skin_test_takes_the_shrink_and_the_budget(system):
    s = system
    eng = DistributedMDEngine(s["spec"], s["params"], s["cell"], dims=(1,), skin=SKIN,
                              device="cpu", scale_budget=0.9)
    st = eng.make_state(s["pos"], s["Z"], velocities=s["vel"])
    assert eng._limit(st) is st.nl_limit
    lim = float(st.nl_limit)
    m, cut = 2.0 * np.sqrt(lim), float(s["spec"].cutoff)
    scale = 0.99

    def shrunk(state, f):
        return state.replace(cell_scale=state.cell_scale * f, positions=state.positions * f,
                             nl_positions=state.nl_positions * f)

    small = shrunk(st, scale)
    s32 = float(small.cell_scale)
    want = (max(0.0, s32 * (cut + m) - cut) / 2.0) ** 2
    assert 0.0 < want < lim
    assert float(eng._limit(small)) == pytest.approx(want, rel=1e-5)
    # an atom moved by a distance between the two limits: a rebuild only in
    # the shrunk cell
    d = np.sqrt((want + lim) / 2.0)
    bump = torch.zeros_like(st.positions)
    bump[0, 0] = d
    r0 = eng.n_rebuilds
    eng._fresh(st.replace(positions=st.positions + bump))
    assert eng.n_rebuilds == r0
    eng._fresh(small.replace(positions=small.positions + bump))
    assert eng.n_rebuilds == r0 + 1
    with pytest.raises(RuntimeError, match="scale_budget"):
        eng._fresh(shrunk(st, 0.85))
