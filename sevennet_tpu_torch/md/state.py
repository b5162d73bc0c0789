"""MD state and physical constants (PyTorch port of
``sevennet_tpu/md/state.py``).

Units follow the ASE convention: length in Angstrom, energy in eV, mass in
amu, time in femtoseconds; ``1 eV/Angstrom/amu = 9.64853e-3 Angstrom/fs^2``.
The state is a dataclass of fp32 tensors on the engine's device; steps
return new states (:meth:`MDState.replace`) and never write into a state's
tensors, so a state kept as a snapshot stays valid.

The JAX state carries a PRNG key that Langevin splits each step; here
``rng`` is an integer seed, and a step's noise comes from a generator
seeded from ``(rng, step)`` (:func:`step_generator`). A chunk retried from
its snapshot therefore draws the same noise, as a JAX key in the state does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = ["MDState", "ATOMIC_MASSES", "init_md_state", "step_generator", "EV_A_AMU_TO_A_FS2",
           "KB_EV"]

EV_A_AMU_TO_A_FS2 = 9.648533212e-3  # (eV/A/amu) -> A/fs^2
KB_EV = 8.617333262e-5  # Boltzmann, eV/K

# standard atomic weights, index = atomic number (0 unused); unstable
# elements use their most common isotope mass
ATOMIC_MASSES = np.array([
    0.0, 1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998,
    20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
    39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933,
    58.693, 63.546, 65.38, 69.723, 72.630, 74.922, 78.971, 79.904, 83.798,
    85.468, 87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07, 102.91,
    106.42, 107.87, 112.41, 114.82, 118.71, 121.76, 127.60, 126.90, 131.29,
    132.91, 137.33, 138.91, 140.12, 140.91, 144.24, 145.0, 150.36, 151.96,
    157.25, 158.93, 162.50, 164.93, 167.26, 168.93, 173.05, 174.97, 178.49,
    180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59, 204.38,
    207.2, 208.98, 209.0, 210.0, 222.0, 223.0, 226.0, 227.0, 232.04, 231.04,
    238.03, 237.0, 244.0, 243.0, 247.0, 247.0, 251.0, 252.0, 257.0, 258.0,
    259.0, 262.0, 267.0, 270.0, 269.0, 270.0, 270.0, 278.0, 281.0, 281.0,
    285.0, 286.0, 289.0, 289.0, 293.0, 293.0, 294.0,
])


@dataclass(frozen=True)
class MDState:
    positions: torch.Tensor  # (N, 3) A
    velocities: torch.Tensor  # (N, 3) A/fs
    forces: torch.Tensor  # (N, 3) eV/A
    species: torch.Tensor  # (N,) int64 model type indices
    masses: torch.Tensor  # (N,) amu
    cell: torch.Tensor  # (3, 3)
    atom_mask: torch.Tensor  # (N,) bool
    step: int
    # neighbour bookkeeping: the dense (N, K) slot grid, receiver-major
    nl_positions: torch.Tensor  # (N, 3) positions at the last rebuild
    edge_src: torch.Tensor  # (N*K,) int64
    edge_dst: torch.Tensor  # (N*K,) int64
    edge_shift: torch.Tensor  # (N*K, 3)
    edge_mask: torch.Tensor  # (N*K,) bool
    edge_mir: torch.Tensor  # (N*K,) int64 mirror slot of each slot
    nl_overflow: torch.Tensor  # () bool: a neighbour capacity was exceeded
    ring_overflow: torch.Tensor  # () bool: a mirror left the ring window
    # () bool: at a build a grid cell was lower than its list's reach (an NPT
    # box shrank past the grid's slack; the engine re-derives the grid)
    grid_small: torch.Tensor
    # () the skin test's limit on an atom's squared displacement from
    # nl_positions: (min(skin, d_drop - cutoff) / 2)^2, d_drop the nearest
    # edge that the slot build cut (0 before the first build)
    nl_limit: torch.Tensor
    # (3, 3) the cell at the last slot build: an NPT cell scaled since then
    # narrows the limit (md/neighbor.py:shrink_limit)
    nl_cell: torch.Tensor
    potential_energy: torch.Tensor  # ()
    stress: torch.Tensor  # (6,) eV/A^3 (zeros unless the engine computed it)
    # input index of each row (tracks identity under spatial sorting)
    atom_index: torch.Tensor  # (N,) int64
    thermo: torch.Tensor  # (2, 3) Nose-Hoover chain (xi, v_xi) per link
    # MTK barostat: [v_eps, xi_b1..3, vxi_b1..3, eps] (zeros when unused)
    baro: torch.Tensor  # (8,)
    rng: int = 0  # Langevin noise seed (step_generator)
    # optional D3 dispersion term: atomic numbers (0 on padded rows) and the
    # second, longer-ranged dense slot grid (N*K3,), receiver-major
    z_numbers: Optional[torch.Tensor] = None  # (N,) int64
    d3_edge_src: Optional[torch.Tensor] = None  # (N*K3,) int64
    d3_edge_dst: Optional[torch.Tensor] = None  # (N*K3,) int64
    d3_edge_shift: Optional[torch.Tensor] = None  # (N*K3, 3)
    d3_edge_mask: Optional[torch.Tensor] = None  # (N*K3,) bool

    @property
    def n_atoms_cap(self) -> int:
        return self.positions.shape[0]

    def replace(self, **kw) -> "MDState":
        return dataclasses.replace(self, **kw)

    def kinetic_energy(self) -> torch.Tensor:
        ke = 0.5 * torch.sum(
            self.masses[:, None] * self.velocities ** 2 * self.atom_mask[:, None]
        )
        return ke / EV_A_AMU_TO_A_FS2  # amu*(A/fs)^2 -> eV

    def temperature(self) -> torch.Tensor:
        ndof = 3 * torch.clamp(self.atom_mask.sum(), min=1)
        return 2.0 * self.kinetic_energy() / (ndof * KB_EV)

    def volume(self) -> torch.Tensor:
        return torch.abs(torch.linalg.det(self.cell))

    def pressure(self) -> torch.Tensor:
        """Total pressure (eV/A^3): virial + kinetic ideal-gas term. Needs
        the engine to have filled ``stress``. The model's internal stress
        convention has P = +trace/3 (= -dE/dV); the calculator flips the
        sign for ASE."""
        p_virial = (self.stress[0] + self.stress[1] + self.stress[2]) / 3.0
        p_kin = 2.0 * self.kinetic_energy() / (3.0 * self.volume())
        return p_virial + p_kin


def step_generator(state: MDState) -> torch.Generator:
    """The generator of one step's noise, on the state's device, seeded from
    ``(state.rng, state.step)``: the same state draws the same noise."""
    gen = torch.Generator(device=state.positions.device)
    gen.manual_seed((state.rng * 0x9E3779B97F4A7C15 + state.step) % (1 << 63))
    return gen


def thermal_velocities(masses: np.ndarray, temperature: float, seed: int) -> np.ndarray:
    """Maxwell-Boltzmann velocities (A/fs) from the host numpy generator,
    centre-of-mass drift removed (``sevennet_tpu/md/state.py:129-141``)."""
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(KB_EV * temperature / masses) * np.sqrt(EV_A_AMU_TO_A_FS2)
    v = rng.normal(size=(len(masses), 3)) * sigma[:, None]
    return v - (masses[:, None] * v).sum(0) / masses.sum()


def init_md_state(
    positions,
    species,
    cell,
    atomic_numbers=None,
    masses=None,
    velocities=None,
    temperature: Optional[float] = None,
    seed: int = 0,
    n_atoms_cap: Optional[int] = None,
    n_edges_cap: int = 0,
    device="cpu",
    d3_edges_cap: int = 0,
) -> MDState:
    """A state of ``len(positions)`` atoms padded to ``n_atoms_cap`` rows
    (padded rows masked, mass 1), with an empty slot grid of
    ``n_edges_cap`` slots. Velocities: given, thermal at ``temperature``
    (numpy generator from ``seed``), or zero. ``seed`` also seeds the
    Langevin noise (``rng``); thermostat and barostat start at rest.
    ``d3_edges_cap`` > 0 adds the atomic numbers and an empty D3 slot grid
    of that many slots (the D3 fields stay None otherwise)."""
    n = len(positions)
    cap = n_atoms_cap or n
    if masses is None:
        if atomic_numbers is None:
            raise ValueError("need atomic_numbers or masses")
        masses = ATOMIC_MASSES[np.asarray(atomic_numbers)]
    masses = np.asarray(masses, np.float64)
    if velocities is None:
        velocities = (np.zeros((n, 3)) if temperature is None
                      else thermal_velocities(masses, temperature, seed))

    def pad(a, fill=0):
        a = np.asarray(a)
        if cap == len(a):
            return a
        return np.concatenate([a, np.full((cap - len(a),) + a.shape[1:], fill, a.dtype)])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    mask = np.zeros(cap, bool)
    mask[:n] = True
    zeros_i = torch.zeros(n_edges_cap, dtype=torch.int64, device=device)
    no = torch.zeros((), dtype=torch.bool, device=device)
    pos = f32(pad(np.asarray(positions, np.float64)))
    cell_t = f32(cell)
    d3 = {}
    if d3_edges_cap:
        if atomic_numbers is None:
            raise ValueError("the D3 term needs atomic_numbers")
        zeros_3 = torch.zeros(d3_edges_cap, dtype=torch.int64, device=device)
        d3 = dict(
            z_numbers=torch.as_tensor(pad(np.asarray(atomic_numbers, np.int64)), device=device),
            d3_edge_src=zeros_3, d3_edge_dst=zeros_3,
            d3_edge_shift=torch.zeros((d3_edges_cap, 3), dtype=torch.float32, device=device),
            d3_edge_mask=torch.zeros(d3_edges_cap, dtype=torch.bool, device=device))
    return MDState(
        positions=pos,
        velocities=f32(pad(np.asarray(velocities, np.float64))),
        forces=torch.zeros((cap, 3), dtype=torch.float32, device=device),
        species=torch.as_tensor(pad(np.asarray(species, np.int64)), device=device),
        masses=f32(pad(masses, fill=1.0)),
        cell=cell_t,
        atom_mask=torch.as_tensor(mask, device=device),
        step=0,
        nl_positions=pos,
        edge_src=zeros_i,
        edge_dst=zeros_i,
        edge_shift=torch.zeros((n_edges_cap, 3), dtype=torch.float32, device=device),
        edge_mask=torch.zeros(n_edges_cap, dtype=torch.bool, device=device),
        edge_mir=zeros_i,
        nl_overflow=no,
        ring_overflow=no,
        grid_small=no,
        nl_limit=torch.zeros((), dtype=torch.float32, device=device),
        nl_cell=cell_t,
        potential_energy=torch.zeros((), dtype=torch.float32, device=device),
        stress=torch.zeros(6, dtype=torch.float32, device=device),
        atom_index=torch.arange(cap, dtype=torch.int64, device=device),
        thermo=torch.zeros((2, 3), dtype=torch.float32, device=device),
        baro=torch.zeros(8, dtype=torch.float32, device=device),
        rng=int(seed),
        **d3,
    )
