"""Batched multi-structure inference (the port of
``sevennet_tpu/batched.py``; the reference's TorchSim interface,
``sevenn/torchsim.py:56-292``): many structures evaluated in one padded
batch and one model call, the mode of high-throughput screening.

The JAX package batches on the flat edge list; the port's model runs the
dense ``(N, K)`` slot grid, so the structures go into one dense batch
(:func:`~sevennet_tpu_torch.data.graph.batch_graphs`): atoms padded to a
multiple of 64 with one padding graph, as the JAX package pads, and K the
batch's largest neighbour count. The JAX package's memory policy
(rematerialized layers, edge chunks of 32,768) was sized for a 16 GB chip;
the port's model chunks a layer by ``chunk_threshold`` already.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence

from .atoms import as_atoms
from .data.dataset import atoms_to_graph
from .data.graph import batch_graphs
from .device import resolve_device
from .model.build import ModelSpec
from .model.model import model_compute, params_to

__all__ = ["BatchedCalculator"]

# model stress (xx,yy,zz,xy,yz,zx) -> ASE Voigt (xx,yy,zz,yz,xz,xy)
_VOIGT_REORDER = [0, 1, 2, 4, 5, 3]


def _rup(n, m):
    return int(math.ceil(max(n, 1) / m)) * m


class BatchedCalculator:
    """Evaluate a list of structures per call, one dense batch each."""

    def __init__(self, model, params=None, device: Optional[str] = None):
        """``model``: a :class:`ModelSpec` with ``params`` (the port's
        tree), or a pretrained name, ``.pth`` path or checkpoint directory
        (:func:`~sevennet_tpu_torch.io.registry.load_model`). Runs on
        ``cuda`` unless ``device="cpu"``."""
        self.device = resolve_device(device)
        if isinstance(model, ModelSpec):
            if params is None:
                raise ValueError("a ModelSpec needs its params")
            spec = model
        else:
            from .io.registry import load_model

            spec, params = load_model(os.fspath(model))
        self.spec = spec
        self.params = params_to(params, self.device)

    def batch(self, structures: Sequence):
        """The structures (as :func:`~sevennet_tpu_torch.atoms.as_atoms`
        takes them) and their dense batch on the calculator's device."""
        ats = [as_atoms(s) for s in structures]
        graphs = [atoms_to_graph(at, self.spec.cutoff, self.spec.z_to_type) for at in ats]
        n_tot = sum(len(at) for at in ats)
        gb = batch_graphs(graphs, n_atoms_cap=_rup(n_tot + 1, 64),
                          n_graphs_cap=len(graphs) + 1, device=self.device)
        return ats, gb

    def calculate(self, structures: Sequence) -> List[Dict[str, Any]]:
        """Per structure: ``energy``, ``forces``, ``energies`` (atomic) and,
        for a periodic one, ``stress`` (ASE Voigt order and sign)."""
        ats, gb = self.batch(structures)
        out = model_compute(self.spec, self.params, gb, device=self.device)
        energies = out["energy"].cpu().numpy()
        forces = out["forces"].cpu().numpy()
        atomic_e = out["atomic_energy"].cpu().numpy()
        stress = out["stress"].cpu().numpy()
        results = []
        off = 0
        for i, at in enumerate(ats):
            n = len(at)
            r = {
                "energy": float(energies[i]),
                "forces": forces[off: off + n],
                "energies": atomic_e[off: off + n],
            }
            if at.cell is not None and at.pbc.any():
                r["stress"] = -stress[i][_VOIGT_REORDER]
            results.append(r)
            off += n
        return results
