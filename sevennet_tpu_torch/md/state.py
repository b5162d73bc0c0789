"""MD state and physical constants (PyTorch port of
``sevennet_tpu/md/state.py``).

Units follow the ASE convention: length in Angstrom, energy in eV, mass in
amu, time in femtoseconds; ``1 eV/Angstrom/amu = 9.64853e-3 Angstrom/fs^2``.
The state is a dataclass of fp32 tensors on the engine's device; steps
return new states (:meth:`MDState.replace`) and never write into a state's
tensors, so a state kept as a snapshot stays valid.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = ["MDState", "ATOMIC_MASSES", "init_md_state", "EV_A_AMU_TO_A_FS2", "KB_EV"]

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
    potential_energy: torch.Tensor  # ()
    stress: torch.Tensor  # (6,) eV/A^3 (zeros unless the engine computed it)
    # input index of each row (tracks identity under spatial sorting)
    atom_index: torch.Tensor  # (N,) int64

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
) -> MDState:
    """A state of ``len(positions)`` atoms padded to ``n_atoms_cap`` rows
    (padded rows masked, mass 1), with an empty slot grid of
    ``n_edges_cap`` slots. Velocities: given, thermal at ``temperature``
    (numpy generator from ``seed``), or zero."""
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
    return MDState(
        positions=pos,
        velocities=f32(pad(np.asarray(velocities, np.float64))),
        forces=torch.zeros((cap, 3), dtype=torch.float32, device=device),
        species=torch.as_tensor(pad(np.asarray(species, np.int64)), device=device),
        masses=f32(pad(masses, fill=1.0)),
        cell=f32(cell),
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
        potential_energy=torch.zeros((), dtype=torch.float32, device=device),
        stress=torch.zeros(6, dtype=torch.float32, device=device),
        atom_index=torch.arange(cap, dtype=torch.int64, device=device),
    )
