"""The port's integrators and ensembles (``sevennet_tpu_torch/md``) against
the JAX package's (``sevennet_tpu/md``).

Integrators: each step function of both packages on the same state, driven
by the same analytic force function (harmonic springs between fixed pairs of
a 24-atom H/O cloud with 4 padded rows, written once in ``jnp`` and once in
``torch`` with the same numbers; its stress is the spring virial, with the
model's sign convention, P = +trace/3), for 20 steps in fp32. Langevin goes
through the port's ``_baoab`` with the noise the JAX step draws from its key
(rebuilt exactly as ``sevennet_tpu/md/integrators.py:62-67`` splits it).
Tolerances: positions and velocities 1e-5 of their largest magnitude; cell,
``baro`` and ``thermo`` 1e-6 relative (fp32 on both sides, ``exp`` and
``sqrt`` of two libraries, 20 steps).

Ensembles: the engine of each package with the same narrow model (8
channels, lmax 1, 2 layers, cutoff 3.5 A) on an 81-atom water box, 4 steps
of ``langevin`` (the port fed JAX's noise) and of ``npt`` (MTK): positions
1e-4 A, energies 1e-4 eV (those of tests/test_torch_md.py), cell 1e-6
relative. A Langevin chunk retried after a forced overflow redraws the same
noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import water_box
from sevennet_tpu.md import MDEngine as JMDEngine
from sevennet_tpu.md import integrators as jint
from sevennet_tpu.md.state import init_md_state as j_init
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu_torch.io.convert import params_from_numpy
from sevennet_tpu_torch.md import MDEngine, build_cell_list_spec
from sevennet_tpu_torch.md import integrators as tint
from sevennet_tpu_torch.md.state import init_md_state, step_generator
from sevennet_tpu_torch.model.build import build_model_spec

torch.set_num_threads(1)
N_ATOMS, N_PAD, STEPS = 24, 4, 20
X_REL, C_REL = 1e-5, 1e-6
T_START, T_TARGET = 200.0, 400.0


def _system(seed=0):
    """Positions, numbers, cell and spring pairs of the cloud:
    each atom tied to the next (a ring) and to a random partner, rest
    lengths 10 % off the start so that the springs pull from step 0."""
    rng = np.random.default_rng(seed)
    cell = np.diag([7.0, 7.5, 8.0]) + 0.3 * np.triu(rng.uniform(size=(3, 3)), 1)
    pos = rng.uniform(0.5, 6.5, (N_ATOMS, 3))
    Z = rng.choice([1, 8], N_ATOMS)
    i = np.concatenate([np.arange(N_ATOMS), np.arange(N_ATOMS)])
    j = np.concatenate([(np.arange(N_ATOMS) + 1) % N_ATOMS, rng.permutation(N_ATOMS)])
    keep = i != j
    i, j = i[keep], j[keep]
    r0 = np.linalg.norm(pos[j] - pos[i], axis=1) * rng.uniform(0.9, 1.1, len(i))
    return pos, Z, cell, i, j, r0


def _springs(xp, i, j, r0, k=2.0):
    """``forces_fn(state) -> (forces, energy, stress)`` of harmonic springs
    in the array module ``xp`` (``jnp`` or ``torch``)."""
    if xp is jnp:
        i, j, r0 = jnp.asarray(i), jnp.asarray(j), jnp.asarray(r0, jnp.float32)

        def scatter(n, g):
            return jnp.zeros((n, 3), jnp.float32).at[i].add(g).at[j].add(-g)
    else:
        i, j = torch.as_tensor(i), torch.as_tensor(j)
        r0 = torch.as_tensor(r0, dtype=torch.float32)

        def scatter(n, g):
            return torch.zeros((n, 3)).index_add(0, i, g).index_add(0, j, -g)

    def fn(state):
        x = state.positions
        r = x[j] - x[i]
        d = xp.sqrt(xp.sum(r * r, -1))
        g = k * (d - r0)  # dE/dd
        energy = xp.sum(0.5 * k * (d - r0) ** 2)
        gv = (g / d)[:, None] * r  # dE/dr
        forces = scatter(x.shape[0], gv)  # F_i = +dE/dr, F_j = -dE/dr
        vol = xp.abs(xp.linalg.det(state.cell))
        s = -xp.sum(r[:, :, None] * gv[:, None, :], 0) / vol
        stress = xp.stack([s[0, 0], s[1, 1], s[2, 2], s[0, 1], s[1, 2], s[2, 0]])
        return forces, energy, stress

    return fn


def _states(seed=0):
    pos, Z, cell, i, j, r0 = _system(seed)
    masses = np.array([1.008, 15.999])[(Z == 8).astype(int)]
    vel = np.random.default_rng(seed + 1).normal(size=(N_ATOMS, 3)) * np.sqrt(
        8.617333262e-5 * T_START / masses)[:, None] * np.sqrt(9.648533212e-3)
    kw = dict(masses=masses, velocities=vel, n_atoms_cap=N_ATOMS + N_PAD, seed=seed)
    species = (Z == 8).astype(np.int32)
    jst, st = j_init(pos, species, cell, **kw), init_md_state(pos, species, cell, **kw)
    jf, tf = _springs(jnp, i, j, r0), _springs(torch, i, j, r0)
    forces, energy, stress = jf(jst)
    jst = jst.replace(forces=forces, potential_energy=energy, stress=stress)
    forces, energy, stress = tf(st)
    st = st.replace(forces=forces, potential_energy=energy, stress=stress)
    return jst, st, jf, tf


def _close(got, want, what, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale, err_msg=what)


def _compare(st, jst):
    for name in ("positions", "velocities"):
        _close(getattr(st, name).numpy(), getattr(jst, name), name, X_REL)
    for name in ("cell", "baro", "thermo"):
        _close(getattr(st, name).numpy(), getattr(jst, name), name, C_REL)
    np.testing.assert_allclose(float(st.potential_energy), float(jst.potential_energy),
                               rtol=X_REL)
    assert st.step == int(jst.step)


NPT_KW = dict(temperature=T_TARGET, pressure=0.01, tau_t=20.0, tau_p=100.0)
STEPPERS = {
    "nve": (lambda m, s, f: m.nve_step(s, f, 0.5)),
    "nose_hoover": (lambda m, s, f: m.nose_hoover_step(s, f, 0.5, T_TARGET, tau=10.0)),
    "mtk_npt": (lambda m, s, f: m.mtk_npt_step(s, f, 0.5, **NPT_KW)),
    "berendsen_npt": (lambda m, s, f: m.berendsen_npt_step(s, f, 0.5, **NPT_KW)),
}


@pytest.mark.parametrize("name", sorted(STEPPERS))
def test_integrator_matches_jax(name):
    """20 steps of each deterministic integrator, analytic forces, both
    packages from the same state; the thermostat and barostat move."""
    jst, st, jf, tf = _states()
    cell0, step = st.cell, STEPPERS[name]
    for _ in range(STEPS):
        jst = step(jint, jst, jf)
        st = step(tint, st, tf)
    _compare(st, jst)
    if name in ("nose_hoover", "mtk_npt"):
        assert float(st.thermo.abs().max()) > 0
    if name == "mtk_npt":
        assert float(st.baro.abs().max()) > 0
    if name in ("mtk_npt", "berendsen_npt"):
        assert float((st.cell - cell0).abs().max()) > 1e-5


def test_langevin_matches_jax_with_its_noise():
    """BAOAB through ``_baoab`` with the noise that JAX's ``langevin_step``
    draws from the state's key, 20 steps."""
    jst, st, jf, tf = _states(seed=3)
    for _ in range(STEPS):
        _, key = jax.random.split(jst.rng)
        noise = jax.random.normal(key, jst.velocities.shape, dtype=jst.velocities.dtype)
        jst = jint.langevin_step(jst, jf, 0.5, T_TARGET, 0.05)
        st = tint._baoab(st, tf, 0.5, T_TARGET, 0.05, torch.tensor(np.asarray(noise)))
    _compare(st, jst)


def test_langevin_noise_is_the_steps_own():
    """The port's noise is a function of the state's ``(rng, step)``: the
    same state draws the same noise, the next step or another seed other
    noise; ``langevin_step`` is ``_baoab`` with it."""
    _, st, _, tf = _states()
    a, b = tint._langevin_noise(st), tint._langevin_noise(st)
    assert torch.equal(a, b)
    assert not torch.equal(a, tint._langevin_noise(st.replace(step=1)))
    assert not torch.equal(a, tint._langevin_noise(st.replace(rng=st.rng + 1)))
    assert step_generator(st).initial_seed() == step_generator(st).initial_seed()
    got = tint.langevin_step(st, tf, 0.5, T_TARGET, 0.05)
    want = tint._baoab(st, tf, 0.5, T_TARGET, 0.05, a)
    assert torch.equal(got.positions, want.positions)
    assert torch.equal(got.velocities, want.velocities)


def test_npt_conserved_quantity_matches_jax():
    """The MTK invariant of both packages on the state after 10 MTK steps
    (thermostat and barostat moving), and its drift over those steps stays
    small against the kinetic energy."""
    jst, st, jf, tf = _states(seed=5)
    h0 = float(tint.npt_conserved_quantity(st, **NPT_KW))
    for _ in range(10):
        jst = jint.mtk_npt_step(jst, jf, 0.25, **NPT_KW)
        st = tint.mtk_npt_step(st, tf, 0.25, **NPT_KW)
    got = float(tint.npt_conserved_quantity(st, **NPT_KW))
    want = float(jint.npt_conserved_quantity(jst, **NPT_KW))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs(got - h0) < 0.05 * float(st.kinetic_energy())


def test_state_volume_and_pressure_match_jax():
    jst, st, _, _ = _states(seed=7)
    np.testing.assert_allclose(float(st.volume()), float(jst.volume()), rtol=1e-6)
    np.testing.assert_allclose(float(st.pressure()), float(jst.pressure()), rtol=1e-5)
    assert st.thermo.shape == (2, 3) and st.baro.shape == (8,)


# -- the engines ---------------------------------------------------------------

CFG = {"cutoff": 3.5, "channel": 8, "lmax": 1, "is_parity": False,
       "num_convolution_layer": 2, "self_connection_type": "linear",
       "conv_denominator": 35.0, "chemical_species": ["H", "O"], "_remat": False,
       "_edge_chunk": 0}
SKIN, DT, ENG_STEPS, SEED = 0.1, 1.0, 4, 2


@pytest.fixture(scope="module")
def engines_system():
    pos, Z, cell = water_box(27)
    jspec = j_build(CFG)
    jparams = model_init(jax.random.PRNGKey(1), jspec)
    spec = build_model_spec(CFG)
    params = params_from_numpy(spec, jax.tree_util.tree_map(np.asarray, jparams))
    return dict(pos=pos, Z=Z, cell=cell, jspec=jspec, jparams=jparams, spec=spec,
                params=params, n=len(pos))


def _jax_noise(seed, cap, steps):
    """The standard normal noise of JAX's Langevin steps 0..steps-1."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(key, (cap, 3), dtype=jnp.float32)))
    return out


@pytest.mark.parametrize("integrator,kw", [
    ("langevin", dict(temperature=300.0, friction=0.05)),
    ("npt", dict(temperature=300.0, pressure=0.005, tau_t=20.0, tau_p=100.0)),
])
def test_engine_ensemble_matches_jax(engines_system, monkeypatch, integrator, kw):
    """``MDEngine.run(integrator=...)`` of both packages from the same
    state: the port's Langevin fed the JAX run's noise; MTK scales the cell
    every step and evaluates the stress with the forces."""
    s = engines_system
    jeng = JMDEngine(s["jspec"], s["jparams"], s["cell"], skin=SKIN, fused=False,
                     sort_atoms=False)
    jst = jeng.make_state(s["pos"], s["Z"], temperature=300.0, seed=SEED)
    jst, (jpe, jke) = jeng.run(jst, ENG_STEPS, dt=DT, chunk=ENG_STEPS, integrator=integrator,
                               **kw)
    eng = MDEngine(s["spec"], s["params"], s["cell"], skin=SKIN, device="cpu")
    st = eng.make_state(s["pos"], s["Z"], temperature=300.0, seed=SEED)
    assert eng._ring_nb == 0  # the atoms keep the input order
    if integrator == "langevin":
        noise = _jax_noise(SEED, int(jst.positions.shape[0]), ENG_STEPS)
        cap = st.n_atoms_cap
        monkeypatch.setattr(tint, "_langevin_noise",
                            lambda state: torch.as_tensor(noise[state.step][:cap]))
    st, (pe, ke) = eng.run(st, ENG_STEPS, dt=DT, chunk=ENG_STEPS, integrator=integrator, **kw)
    n = s["n"]
    np.testing.assert_allclose(st.positions.numpy()[:n], np.asarray(jst.positions)[:n],
                               atol=1e-4)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), atol=1e-4)
    np.testing.assert_allclose(ke.numpy(), np.asarray(jke), atol=1e-4)
    _close(st.cell.numpy(), np.asarray(jst.cell), "cell", C_REL)
    _close(st.thermo.numpy(), np.asarray(jst.thermo), "thermo", 1e-4)
    if integrator == "npt":
        assert eng.n_rebuilds > 0
        assert not np.array_equal(st.cell.numpy(), np.asarray(s["cell"], np.float32))
        _close(st.baro.numpy(), np.asarray(jst.baro), "baro", 1e-4)


def test_langevin_retry_redraws_the_same_noise(engines_system, monkeypatch):
    """Half the cell capacity: the first device rebuild overflows, the
    chunk is retried from its snapshot with grown capacities, and every
    retried step draws the noise it drew the first time; the trajectory
    equals an engine that never overflowed."""
    s = engines_system
    kw = dict(integrator="langevin", temperature=300.0, friction=0.05)
    eng = MDEngine(s["spec"], s["params"], s["cell"], skin=SKIN, device="cpu")
    st_a, _ = eng.run(eng.make_state(s["pos"], s["Z"], temperature=300.0, seed=SEED),
                      ENG_STEPS, dt=DT, chunk=ENG_STEPS, **kw)
    assert eng.n_growths == 0

    draws = []
    draw = tint._langevin_noise

    def recorded(state):
        draws.append((state.step, draw(state)))
        return draws[-1][1]

    monkeypatch.setattr(tint, "_langevin_noise", recorded)
    small = build_cell_list_spec(s["cell"], s["n"], CFG["cutoff"], SKIN)
    small = dataclasses.replace(small, cell_capacity=small.cell_capacity // 2)
    eng = MDEngine(s["spec"], s["params"], s["cell"], skin=SKIN, cl_spec=small, device="cpu")
    st_b, _ = eng.run(eng.make_state(s["pos"], s["Z"], temperature=300.0, seed=SEED),
                      ENG_STEPS, dt=DT, chunk=ENG_STEPS, **kw)
    assert eng.n_growths > 0
    steps = [k for k, _ in draws]
    assert len(steps) > len(set(steps)), "no step was retried"
    first = {}
    for k, noise in draws:
        assert torch.equal(first.setdefault(k, noise), noise), f"step {k} drew other noise"
    np.testing.assert_allclose(st_b.positions.numpy()[: s["n"]],
                               st_a.positions.numpy()[: s["n"]], atol=1e-5)
