"""Single-point calculator: energy, forces, stress (the port of
``sevennet_tpu/calculator.py:SevenNetTPUCalculator`` on its fused path;
reference ``SevenNetCalculator``, ``sevenn/calculator.py:20-233``).

Each request builds the neighbour list on the host (the native cell list
for 256 atoms or more, :mod:`sevennet_tpu_torch.data.neighborlist`) and
sorts it by receiver; the device scatters the edges into the receiver-major
``(N, K)`` slot grid and builds the mirror index
(:func:`~sevennet_tpu_torch.data.graph.dense_graph_device`, as the JAX
package's fused calculator does), and
:func:`~sevennet_tpu_torch.model.model.model_compute` runs. The grid's K is
the largest neighbour count: the kernels need a rectangular grid, nothing
more (the JAX package's bucketed capacities served XLA's compile cache).
A multi-fidelity model serves the modality its config pins
(:func:`~sevennet_tpu_torch.scripts.modal_tools.select_modality`), else
modality 0.

Results use ASE conventions: ``stress`` in eV/A^3, Voigt order
(xx, yy, zz, yz, xz, xy), with the reference's sign flip. The model is a
spec with its parameters, or anything :func:`~sevennet_tpu_torch.io.
registry.load_model` resolves: a pretrained name ("7net-0"), a stock
``.pth``, or a checkpoint directory of the port or of the JAX package.
:meth:`SevenNetCalculator.as_ase` wraps the calculator as an ASE one.

:class:`SevenNetD3Calculator` (or :meth:`SevenNetCalculator.with_d3`) adds
Grimme D3 dispersion (:class:`~sevennet_tpu_torch.d3.D3Calculator`, on the
model's device) to the model's energy, forces and stress.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import numpy as np

from .atoms import as_atoms
from .data.graph import dense_graph_device, receiver_sorted
from .data.neighborlist import neighbor_list_numpy
from .device import resolve_device
from .model.build import ModelSpec
from .model.model import model_compute, params_to

__all__ = ["SevenNetCalculator", "SevenNetD3Calculator"]

# model stress (xx,yy,zz,xy,yz,zx) -> ASE Voigt (xx,yy,zz,yz,xz,xy)
_VOIGT_REORDER = (0, 1, 2, 4, 5, 3)


class SevenNetCalculator:
    def __init__(
        self,
        model: Union[ModelSpec, str, "os.PathLike"],
        params: Optional[Dict[str, Any]] = None,
        compute_stress: bool = True,
        device: Optional[str] = None,
        plain: bool = False,
    ):
        """``model``: a :class:`ModelSpec` with ``params``, the port's
        parameter tree (:func:`sevennet_tpu_torch.io.params_from_numpy`);
        or a pretrained name, a ``.pth`` path or a checkpoint directory
        (:func:`~sevennet_tpu_torch.io.registry.load_model`), without
        ``params``. Runs on ``cuda`` unless ``device="cpu"``; ``plain=True``
        runs the convolution's plain PyTorch version instead of the kernels
        (the reference path)."""
        self.device = resolve_device(device)
        if isinstance(model, ModelSpec):
            if params is None:
                raise ValueError("a ModelSpec needs its params")
            spec = model
        else:
            if params is not None:
                raise ValueError("params go with a ModelSpec, not with a name or path")
            from .io.registry import load_model

            spec, params = load_model(os.fspath(model))
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
        dst, src, shifts = neighbor_list_numpy(at.positions, self.spec.cutoff, at.cell, at.pbc)
        dst, src, shifts = receiver_sorted(dst, src, shifts)
        return dense_graph_device(at.positions, species, src, dst, shifts, at.cell,
                                  device=self.device)

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

    def with_d3(self, functional: str = "pbe", damping_type: str = "damp_bj",
                **d3_kwargs) -> "SevenNetD3Calculator":
        """This calculator plus D3 dispersion (keywords of
        :class:`~sevennet_tpu_torch.d3.D3Calculator`)."""
        return SevenNetD3Calculator(self, functional, damping_type, **d3_kwargs)

    def as_ase(self):
        """An ``ase.calculators.calculator.Calculator`` that serves through
        this calculator. Raises ``ImportError`` (naming ``ase``) when ASE is
        not installed; the port does not need it otherwise."""
        try:
            from ase.calculators.calculator import Calculator, all_changes
        except ImportError as exc:
            raise ImportError("as_ase() needs the 'ase' package, which is not installed") from exc

        parent = self

        class _ASECalc(Calculator):
            implemented_properties = ["energy", "free_energy", "forces", "stress", "energies"]

            def calculate(self, atoms=None, properties=None, system_changes=all_changes):
                super().calculate(atoms, properties, system_changes)
                self.results = dict(parent.calculate(self.atoms))

        return _ASECalc()


class SevenNetD3Calculator:
    """Model + Grimme D3 dispersion (the reference's ``SevenNetD3Calculator``,
    ``sevenn/calculator.py:236-314``, a SumCalculator of both): energy, free
    energy and forces summed, and the stress where both give one.

    ``model``: a :class:`SevenNetCalculator`, or what it takes (a
    :class:`ModelSpec` with ``params``, a name or a path, with ``device``).
    The D3 part runs on the model's device; ``d3_kwargs`` go to
    :class:`~sevennet_tpu_torch.d3.D3Calculator` (``cutoff_ang``,
    ``bound_by_box``)."""

    def __init__(self, model, functional: str = "pbe", damping_type: str = "damp_bj", *,
                 params=None, device: Optional[str] = None, **d3_kwargs):
        from .d3 import D3Calculator

        if isinstance(model, SevenNetCalculator):
            if params is not None or device is not None:
                raise ValueError("params and device go with a model, not with a calculator")
            base = model
        else:
            base = SevenNetCalculator(model, params, device=device)
        self.base = base
        self.d3 = D3Calculator(functional, damping_type, device=str(base.device), **d3_kwargs)
        self.results: Dict[str, Any] = {}

    def calculate(self, atoms) -> Dict[str, Any]:
        a = self.base.calculate(atoms)
        b = self.d3.calculate(atoms)
        out = dict(a)
        out["energy"] = a["energy"] + b["energy"]
        out["free_energy"] = out["energy"]
        out["forces"] = a["forces"] + b["forces"]
        if "stress" in a and "stress" in b:
            out["stress"] = a["stress"] + b["stress"]
        self.results = out
        return out

    def get_potential_energy(self, atoms) -> float:
        return self.calculate(atoms)["energy"]

    def get_forces(self, atoms) -> np.ndarray:
        return self.calculate(atoms)["forces"]
