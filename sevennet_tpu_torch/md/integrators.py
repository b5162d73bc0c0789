"""Integrators (PyTorch port of ``sevennet_tpu/md/integrators.py``):
velocity-Verlet NVE, Langevin (BAOAB) NVT, Nose-Hoover chain NVT, MTK and
Berendsen NPT.

Pure functions of :class:`~.state.MDState` in fp32: each returns a new
state and writes into none of the old one's tensors. The force evaluation
comes from the engine, ``forces_fn(state) -> (forces, energy, stress)``,
so the integrators stay model-agnostic (they also run on an analytic force
function). The NPT integrators read the state's stress: the engine computes
it on every force evaluation for them.
"""

from __future__ import annotations

import math

import torch

from .state import EV_A_AMU_TO_A_FS2, KB_EV, MDState, step_generator

__all__ = [
    "nve_step", "langevin_step", "nose_hoover_step", "berendsen_npt_step",
    "mtk_npt_step", "npt_conserved_quantity",
]


def _accel(state: MDState):
    return state.forces / state.masses[:, None] * EV_A_AMU_TO_A_FS2 * state.atom_mask[:, None]


def _ndof(state: MDState) -> torch.Tensor:
    return 3.0 * torch.clamp(state.atom_mask.sum(), min=1).to(state.positions.dtype)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _with(vec: torch.Tensor, i: int, value: torch.Tensor) -> torch.Tensor:
    """``vec`` with entry ``i`` set to ``value``, as a new tensor."""
    out = vec.clone()
    out[i] = value
    return out


def nve_step(state: MDState, forces_fn, dt: float) -> MDState:
    """One velocity-Verlet step. ``forces_fn(state) -> (forces, energy,
    stress)`` on the state's current neighbour list."""
    mask = state.atom_mask[:, None]
    v_half = state.velocities + 0.5 * dt * _accel(state)
    state = state.replace(positions=state.positions + dt * v_half * mask)
    forces, energy, stress = forces_fn(state)
    state = state.replace(forces=forces, potential_energy=energy, stress=stress)
    v_new = v_half + 0.5 * dt * _accel(state)
    return state.replace(velocities=v_new * mask, step=state.step + 1)


def _langevin_noise(state: MDState) -> torch.Tensor:
    """Standard normal noise of the velocities' shape from the step's
    generator (:func:`~.state.step_generator`)."""
    v = state.velocities
    return torch.randn(v.shape, generator=step_generator(state), dtype=v.dtype, device=v.device)


def _baoab(state: MDState, forces_fn, dt: float, temperature: float, friction: float,
           noise: torch.Tensor) -> MDState:
    """BAOAB with the O step's standard normal ``noise`` given."""
    mask = state.atom_mask[:, None]
    # B
    v = state.velocities + 0.5 * dt * _accel(state)
    # A
    x = state.positions + 0.5 * dt * v * mask
    # O
    c1 = torch.exp(_f32(-friction * dt, v))
    sigma = torch.sqrt((1.0 - c1 ** 2) * KB_EV * temperature / state.masses) * math.sqrt(
        EV_A_AMU_TO_A_FS2)
    v = c1 * v + sigma[:, None] * noise
    # A
    x = x + 0.5 * dt * v * mask
    state = state.replace(positions=x)
    forces, energy, stress = forces_fn(state)
    state = state.replace(forces=forces, potential_energy=energy, stress=stress)
    # B
    v = v + 0.5 * dt * _accel(state)
    return state.replace(velocities=v * mask, step=state.step + 1)


def langevin_step(state: MDState, forces_fn, dt: float, temperature: float,
                  friction: float) -> MDState:
    """BAOAB Langevin: B (half kick) A (half drift) O (thermostat) A B.
    ``friction`` in 1/fs, ``temperature`` in K. The noise is the step's own
    (seeded from the state's ``rng`` and ``step``)."""
    return _baoab(state, forces_fn, dt, temperature, friction, _langevin_noise(state))


def _chain_half(ke2, xi, vxi, Q, g0_kt, kT: float, dt: float):
    """Half-step sweep of a 3-link Nose-Hoover chain (Frenkel & Smit alg.
    30): chain velocities backward, the particle scale, chain positions,
    chain velocities forward. ``ke2`` is twice the thermostatted kinetic
    energy and ``g0_kt`` its target; returns ``(scale, xi, vxi)``."""
    vxi = list(vxi.unbind())
    dt2, dt4, dt8 = dt / 2.0, dt / 4.0, dt / 8.0

    def force(j, ke2):
        if j == 0:
            return (ke2 - g0_kt) / Q[0]
        return (Q[j - 1] * vxi[j - 1] ** 2 - kT) / Q[j]

    vxi[2] = vxi[2] + force(2, ke2) * dt4
    for j in (1, 0):
        vxi[j] = vxi[j] * torch.exp(-dt8 * vxi[j + 1])
        vxi[j] = vxi[j] + force(j, ke2) * dt4
        vxi[j] = vxi[j] * torch.exp(-dt8 * vxi[j + 1])
    scale = torch.exp(-dt2 * vxi[0])
    ke2 = ke2 * scale * scale
    xi = xi + dt2 * torch.stack(vxi)
    for j in (0, 1):
        vxi[j] = vxi[j] * torch.exp(-dt8 * vxi[j + 1])
        vxi[j] = vxi[j] + force(j, ke2) * dt4
        vxi[j] = vxi[j] * torch.exp(-dt8 * vxi[j + 1])
    vxi[2] = vxi[2] + force(2, ke2) * dt4
    return scale, xi, torch.stack(vxi)


def _nhc_half(state: MDState, dt: float, temperature: float, tau: float):
    """Half-step Nose-Hoover chain (M=3) of the particles; returns
    ``(scale, thermo)``."""
    kT = KB_EV * temperature
    ndof = _ndof(state)
    ke2 = 2.0 * state.kinetic_energy()  # 2*KE in eV
    # chain masses (eV*fs^2)
    q1 = ndof * kT * tau * tau
    Q = torch.stack([q1, *[_f32(kT * tau * tau, q1)] * 2])
    scale, xi, vxi = _chain_half(ke2, state.thermo[0], state.thermo[1], Q, ndof * kT, kT, dt)
    return scale, torch.stack([xi, vxi])


def nose_hoover_step(state: MDState, forces_fn, dt: float, temperature: float,
                     tau: float = 50.0) -> MDState:
    """Nose-Hoover chain (M=3) NVT: NHC half, velocity-Verlet, NHC half.
    ``tau`` is the thermostat time constant in fs (~50-100 x dt typical)."""
    scale, thermo = _nhc_half(state, dt, temperature, tau)
    state = state.replace(velocities=state.velocities * scale, thermo=thermo)
    state = nve_step(state, forces_fn, dt)
    scale, thermo = _nhc_half(state, dt, temperature, tau)
    return state.replace(velocities=state.velocities * scale, thermo=thermo)


def _sinhc(x):
    """sinh(x)/x, series for small x (x is ~v_eps*dt/4 << 1 in practice)."""
    x2 = x * x
    return 1.0 + x2 / 6.0 * (1.0 + x2 / 20.0 * (1.0 + x2 / 42.0))


def _nhc_baro_half(baro, dt: float, temperature: float, tau_p: float, W):
    """Half-step NHC (M=3) thermostatting the barostat's one degree of
    freedom (kinetic term W*v_eps^2); takes and returns the (8,) vector
    ``[v_eps, xi(3), vxi(3), eps]``."""
    kT = KB_EV * temperature
    Q = torch.full((3,), kT * tau_p * tau_p, dtype=baro.dtype, device=baro.device)
    v_eps = baro[0]
    scale, xi, vxi = _chain_half(W * v_eps * v_eps, baro[1:4], baro[4:7], Q, kT, kT, dt)
    return torch.cat([(v_eps * scale)[None], xi, vxi, baro[7:]])


def mtk_npt_step(
    state: MDState,
    forces_fn,
    dt: float,
    temperature: float,
    pressure: float = 0.0,
    tau_t: float = 100.0,
    tau_p: float = 1000.0,
) -> MDState:
    """Martyna-Tobias-Klein isotropic NPT: a Nose-Hoover piston with its own
    chain on top of the particle chain (LAMMPS ``fix npt``). Trotter
    splitting (Tuckerman, *Statistical Mechanics* ch. 5; Martyna et al.,
    Mol. Phys. 87, 1117 (1996)): chains -> v_eps -> v -> (r, h) full step ->
    forces -> v -> v_eps -> chains. ``pressure`` in eV/A^3, taus in fs.
    The positions, the rebuild's reference positions and the cell scale
    every step. The invariant is :func:`npt_conserved_quantity`."""
    mask = state.atom_mask[:, None]
    kT = KB_EV * temperature
    nf = _ndof(state)
    W = (nf + 3.0) * kT * tau_p * tau_p
    alpha = 1.0 + 3.0 / nf
    dt2, dt4 = dt / 2.0, dt / 4.0

    def veps_half(state):
        ke2 = 2.0 * state.kinetic_energy()
        G = (3.0 * state.volume() * (state.pressure() - pressure) + (3.0 / nf) * ke2) / W
        return state.replace(baro=_with(state.baro, 0, state.baro[0] + dt2 * G))

    def kick(state):
        vf = torch.exp(-dt2 * alpha * state.baro[0])
        sf = torch.exp(-dt4 * alpha * state.baro[0]) * _sinhc(dt4 * alpha * state.baro[0])
        v = state.velocities * vf + dt2 * _accel(state) * sf
        return state.replace(velocities=v * mask)

    # chains (barostat's, then the particles'), then v_eps, then v
    state = state.replace(baro=_nhc_baro_half(state.baro, dt, temperature, tau_p, W))
    scale, thermo = _nhc_half(state, dt, temperature, tau_t)
    state = state.replace(velocities=state.velocities * scale, thermo=thermo)
    state = kick(veps_half(state))

    # full-step position and cell update under the piston
    v_eps = state.baro[0]
    ef = torch.exp(dt * v_eps)
    rf = torch.exp(dt2 * v_eps) * _sinhc(dt2 * v_eps)
    x = state.positions * ef + dt * state.velocities * rf
    state = state.replace(
        positions=torch.where(mask, x, state.positions),
        nl_positions=state.nl_positions * ef,
        cell=state.cell * ef,
        baro=_with(state.baro, 7, state.baro[7] + dt * v_eps),
    )
    forces, energy, stress = forces_fn(state)
    state = state.replace(forces=forces, potential_energy=energy, stress=stress)

    # mirror: v, v_eps, chains
    state = veps_half(kick(state))
    scale, thermo = _nhc_half(state, dt, temperature, tau_t)
    state = state.replace(velocities=state.velocities * scale, thermo=thermo)
    state = state.replace(baro=_nhc_baro_half(state.baro, dt, temperature, tau_p, W))
    return state.replace(step=state.step + 1)


def npt_conserved_quantity(state: MDState, temperature: float, pressure: float,
                           tau_t: float = 100.0, tau_p: float = 1000.0) -> torch.Tensor:
    """The MTK NPT invariant H' (eV): PE + KE + thermostat and barostat
    terms + P_ext V. Its drift over a run is the NPT analogue of NVE's
    total-energy drift."""
    kT = KB_EV * temperature
    nf = _ndof(state)
    W = (nf + 3.0) * kT * tau_p * tau_p
    q1 = nf * kT * tau_t * tau_t
    Q = torch.stack([q1, *[_f32(kT * tau_t * tau_t, q1)] * 2])
    Qb = torch.full((3,), kT * tau_p * tau_p, dtype=nf.dtype, device=nf.device)
    xi, vxi = state.thermo[0], state.thermo[1]
    v_eps = state.baro[0]
    xib, vxib = state.baro[1:4], state.baro[4:7]
    h = state.potential_energy + state.kinetic_energy()
    h = h + 0.5 * W * v_eps * v_eps + pressure * state.volume()
    h = h + 0.5 * torch.sum(Q * vxi * vxi) + nf * kT * xi[0] + kT * torch.sum(xi[1:])
    h = h + 0.5 * torch.sum(Qb * vxib * vxib) + kT * torch.sum(xib)
    return h


def berendsen_npt_step(
    state: MDState,
    forces_fn,
    dt: float,
    temperature: float,
    pressure: float = 0.0,
    tau_t: float = 100.0,
    tau_p: float = 1000.0,
    compressibility: float = 4.6e-5,
) -> MDState:
    """Berendsen weak-coupling NPT (isotropic): a velocity rescale toward
    ``temperature``, a cell and position scale toward ``pressure`` (eV/A^3;
    ``compressibility`` in 1/bar, water's by default; taus in fs), then a
    velocity-Verlet step. Reads the state's virial + kinetic pressure."""
    t_now = torch.clamp(state.temperature(), min=1e-12)
    lam = torch.sqrt(1.0 + dt / tau_t * (temperature / t_now - 1.0))
    lam = torch.clamp(lam, 0.9, 1.1)
    state = state.replace(velocities=state.velocities * lam)

    bar_to_evA3 = 1.0 / 1.602176634e6  # 1 bar in eV/A^3
    beta = compressibility / bar_to_evA3  # (eV/A^3)^-1
    mu = (1.0 - dt / tau_p * beta * (pressure - state.pressure())) ** (1.0 / 3.0)
    mu = torch.clamp(mu, 0.98, 1.02)
    state = state.replace(
        positions=state.positions * mu,
        nl_positions=state.nl_positions * mu,
        cell=state.cell * mu,
    )
    return nve_step(state, forces_fn, dt)
