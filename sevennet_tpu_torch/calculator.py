"""Single-point calculator: energy, forces, stress (the port of
``sevennet_tpu/calculator.py:SevenNetTPUCalculator`` on its fused path;
reference ``SevenNetCalculator``, ``sevenn/calculator.py:20-233``).

Each request builds the neighbour list on the host, densifies the edges into
the receiver-major ``(N, K)`` slot grid with its mirror index, and runs
:func:`~sevennet_tpu_torch.model.model.model_compute`. The grid's K is the
largest neighbour count: the kernels need a rectangular grid, nothing more
(the JAX package's bucketed capacities served XLA's compile cache).

Results use ASE conventions: ``stress`` in eV/A^3, Voigt order
(xx, yy, zz, yz, xz, xy), with the reference's sign flip.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .atoms import as_atoms
from .data.graph import dense_graph_from_arrays
from .data.neighborlist import neighbor_list_numpy
from .device import resolve_device
from .model.build import ModelSpec
from .model.model import model_compute, params_to

__all__ = ["SevenNetCalculator"]

# model stress (xx,yy,zz,xy,yz,zx) -> ASE Voigt (xx,yy,zz,yz,xz,xy)
_VOIGT_REORDER = (0, 1, 2, 4, 5, 3)


class SevenNetCalculator:
    def __init__(
        self,
        spec: ModelSpec,
        params: Dict[str, Any],
        compute_stress: bool = True,
        device: Optional[str] = None,
        plain: bool = False,
    ):
        """``params``: the port's parameter tree
        (:func:`sevennet_tpu_torch.io.params_from_numpy`). Runs on ``cuda``
        unless ``device="cpu"``; ``plain=True`` runs the convolution's plain
        PyTorch version instead of the kernels (the reference path)."""
        self.device = resolve_device(device)
        self.spec = spec
        self.params = params_to(params, self.device)
        self.compute_stress = compute_stress
        self.plain = plain
        self.results: Dict[str, Any] = {}

    def graph(self, atoms):
        """The dense graph of one structure, on the calculator's device."""
        at = as_atoms(atoms)
        species = self.spec.z_to_type[at.numbers]
        if (species < 0).any():
            bad = sorted(set(at.numbers[species < 0].tolist()))
            raise ValueError(f"model does not know atomic numbers {bad}")
        dst, src, shifts = neighbor_list_numpy(
            at.positions, self.spec.cutoff, at.cell, at.pbc
        )
        return dense_graph_from_arrays(
            at.positions, species, src, dst, shifts, at.cell, device=self.device
        )

    def calculate(self, atoms) -> Dict[str, Any]:
        at = as_atoms(atoms)
        n = len(at)
        out = model_compute(
            self.spec, self.params, self.graph(at), self.compute_stress,
            device=self.device, plain=self.plain,
        )
        energy = float(out["energy"][0])
        results = {
            "energy": energy,
            "free_energy": energy,
            "forces": out["forces"].cpu().numpy()[:n],
            "energies": out["atomic_energy"].cpu().numpy()[:n],
        }
        if self.compute_stress and at.cell is not None and at.pbc.any():
            s = out["stress"][0].cpu().numpy()
            results["stress"] = -s[list(_VOIGT_REORDER)]
            results["atomic_virial"] = out["atomic_virial"].cpu().numpy()[:n]
        self.results = results
        return results

    def get_potential_energy(self, atoms) -> float:
        return self.calculate(atoms)["energy"]

    def get_forces(self, atoms) -> np.ndarray:
        return self.calculate(atoms)["forces"]

    def get_stress(self, atoms) -> np.ndarray:
        return self.calculate(atoms)["stress"]
