"""Minimal self-contained Atoms container (ASE-compatible subset).

The reference depends on ``ase.Atoms`` everywhere; this framework is
self-contained (ASE is optional). :class:`AtomsLite` carries exactly what the
potential needs: positions (Angstrom), atomic numbers, cell (rows = lattice
vectors), pbc flags, and optional labels. Anything with ``get_positions()`` /
``get_atomic_numbers()`` / ``get_cell()`` / ``get_pbc()`` duck-types into
:func:`as_atoms` (so real ``ase.Atoms`` objects work unchanged).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .model.build import ATOMIC_NUMBERS, CHEMICAL_SYMBOLS

__all__ = ["AtomsLite", "as_atoms"]


@dataclass
class AtomsLite:
    positions: np.ndarray  # (N, 3) Angstrom
    numbers: np.ndarray  # (N,) atomic numbers
    cell: Optional[np.ndarray] = None  # (3, 3) rows = lattice vectors
    pbc: np.ndarray = field(default_factory=lambda: np.zeros(3, bool))
    # optional labels
    energy: Optional[float] = None
    forces: Optional[np.ndarray] = None
    stress: Optional[np.ndarray] = None  # voigt 6 (xx,yy,zz,yz,xz,xy), ASE sign
    info: dict = field(default_factory=dict)

    def __post_init__(self):
        self.positions = np.asarray(self.positions, dtype=np.float64).reshape(-1, 3)
        self.numbers = np.asarray(self.numbers, dtype=np.int64).reshape(-1)
        if isinstance(self.pbc, (bool, np.bool_)):
            self.pbc = np.full(3, bool(self.pbc))
        self.pbc = np.asarray(self.pbc, dtype=bool).reshape(3)
        if self.cell is not None:
            self.cell = np.asarray(self.cell, dtype=np.float64).reshape(3, 3)
        elif self.pbc.any():
            raise ValueError("pbc set but no cell given")

    def __len__(self) -> int:
        return len(self.numbers)

    @property
    def symbols(self):
        return [CHEMICAL_SYMBOLS[z] for z in self.numbers]

    @staticmethod
    def from_symbols(symbols, positions, **kw) -> "AtomsLite":
        numbers = np.array([ATOMIC_NUMBERS[s] for s in symbols])
        return AtomsLite(positions=np.asarray(positions), numbers=numbers, **kw)

    def get_positions(self):
        return self.positions.copy()

    def get_atomic_numbers(self):
        return self.numbers.copy()

    def get_cell(self):
        return np.zeros((3, 3)) if self.cell is None else self.cell.copy()

    def get_pbc(self):
        return self.pbc.copy()

    def volume(self) -> float:
        if self.cell is None:
            return 0.0
        return float(abs(np.linalg.det(self.cell)))


def as_atoms(obj) -> AtomsLite:
    if isinstance(obj, AtomsLite):
        return obj
    # duck-typing: ase.Atoms and friends
    cell = np.asarray(obj.get_cell())
    if not np.abs(cell).max() > 0:
        cell = None
    return AtomsLite(
        positions=np.asarray(obj.get_positions()),
        numbers=np.asarray(obj.get_atomic_numbers()),
        cell=cell,
        pbc=np.asarray(obj.get_pbc()),
    )
