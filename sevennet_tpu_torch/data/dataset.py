"""Graph dataset: structures -> padded dense graph batches + statistics
(PyTorch port of ``sevennet_tpu/data/dataset.py``; the reference's
``SevenNetGraphDataset``, ``sevenn/train/graph_dataset.py``).

Graphs are built on the host (numpy neighbour lists) and batched into the
dense ``(N, K)`` slot layout with the mirror index that the fused conv
consumes. The statistics the reference derives for model initialization
are reproduced:

- ``per_atom_energy_mean`` / ``per_atom_energy_std``  (shift/scale sources)
- ``elemwise_reference_energies``: ridge regression (alpha=0.1, no
  intercept) of total energy on composition (``graph_dataset.py:116-130``)
- ``force_rms``
- ``avg_num_neigh`` / ``sqrt_avg_num_neigh``  (conv denominator sources)

Not ported yet (ROADMAP queue A, item "Training, the rest"): readers other
than extxyz, the multiprocess build, the disk cache and lazy batches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..atoms import AtomsLite
from ..model.build import CHEMICAL_SYMBOLS, NUM_UNIV_ELEMENT
from .graph import GraphBatch, batch_graphs, graph_from_arrays
from .neighborlist import neighbor_list_numpy

__all__ = ["GraphDataset", "atoms_to_graph"]

_LATER = "not ported yet (ROADMAP.md, queue A: training, the rest)"


def atoms_to_graph(at: AtomsLite, cutoff: float, z_to_type: np.ndarray) -> GraphBatch:
    """A single labeled graph with a flat edge list on the CPU (reference
    ``atoms_to_graph``, ``dataload.py:102-223``). Missing labels are NaN."""
    species = z_to_type[at.numbers]
    if (species < 0).any():
        bad = sorted(set(int(z) for z in at.numbers[species < 0]))
        raise ValueError(f"unknown species {bad} for this model")
    dst, src, shifts = neighbor_list_numpy(at.positions, cutoff, at.cell, at.pbc)
    dw = at.info.get("data_weight", {}) if at.info else {}
    if isinstance(dw, (int, float)):
        dw = {"energy": dw, "force": dw, "stress": dw}
    n = len(at)
    return graph_from_arrays(
        at.positions, species, src, dst, shifts, at.cell,
        energy=at.energy if at.energy is not None else np.nan,
        forces=at.forces if at.forces is not None else np.full((n, 3), np.nan),
        stress=at.stress if at.stress is not None else np.full(6, np.nan),
        data_weight=(float(dw.get("energy", 1.0)), float(dw.get("force", 1.0)),
                     float(dw.get("stress", 1.0))),
    )


@dataclass
class GraphDataset:
    atoms_list: List[AtomsLite]
    cutoff: float
    z_to_type: Optional[np.ndarray] = None
    graphs: List[GraphBatch] = field(default_factory=list)
    _stats: Optional[Dict] = None

    @staticmethod
    def from_files(path, cutoff: float, z_to_type=None) -> "GraphDataset":
        """Every frame of the extxyz file(s) ``path`` (``*.xyz`` /
        ``*.extxyz``)."""
        from .extxyz import read_extxyz

        paths = [path] if isinstance(path, str) else list(path)
        frames: List[AtomsLite] = []
        for p in paths:
            if not str(p).lower().endswith((".xyz", ".extxyz")):
                raise NotImplementedError(f"{p}: readers other than extxyz are {_LATER}")
            frames.extend(read_extxyz(str(p)))
        return GraphDataset(frames, cutoff, z_to_type)

    # -- species ------------------------------------------------------------
    @property
    def species(self) -> List[str]:
        zs = sorted({int(z) for at in self.atoms_list for z in at.numbers})
        return [CHEMICAL_SYMBOLS[z] for z in zs]

    def build(self, z_to_type: Optional[np.ndarray] = None, processes: int = 1):
        """Builds every graph (neighbour lists and labels)."""
        if processes > 1:
            raise NotImplementedError(f"the multiprocess graph build is {_LATER}")
        if z_to_type is not None:
            self.z_to_type = z_to_type
        if self.z_to_type is None:
            raise ValueError("build() needs z_to_type")
        self.graphs = [atoms_to_graph(at, self.cutoff, self.z_to_type) for at in self.atoms_list]
        return self

    def __len__(self):
        return len(self.atoms_list)

    # -- statistics ----------------------------------------------------------
    @property
    def statistics(self) -> Dict:
        if self._stats is None:
            self._stats = self._run_stat()
        return self._stats

    def _run_stat(self) -> Dict:
        energies, pae, comps, f_all, nn_all = [], [], [], [], []
        for at in self.atoms_list:
            n = len(at)
            if at.energy is not None and np.isfinite(at.energy):
                energies.append(at.energy)
                pae.append(at.energy / n)
                comps.append(np.bincount(at.numbers, minlength=NUM_UNIV_ELEMENT))
            if at.forces is not None:
                f_all.append(np.asarray(at.forces).reshape(-1))
            dst, _, _ = neighbor_list_numpy(at.positions, self.cutoff, at.cell, at.pbc)
            nn_all.append(np.bincount(dst, minlength=n))
        f_cat = np.concatenate(f_all) if f_all else np.zeros(1)
        nn_cat = np.concatenate(nn_all) if nn_all else np.zeros(1)
        pae = np.asarray(pae) if pae else np.zeros(1)
        stats = {
            "per_atom_energy_mean": float(pae.mean()),
            "per_atom_energy_std": float(pae.std()),  # ddof=0, reference correction=0
            "force_rms": float(np.sqrt((f_cat**2).mean())),
            "avg_num_neigh": float(nn_cat.mean()),
            "sqrt_avg_num_neigh": float(np.sqrt(nn_cat.mean())),
        }
        if comps:
            C = np.asarray(comps, dtype=np.float64)
            y = np.asarray(energies, dtype=np.float64)
            nonzero = C.any(axis=0)
            Cr = C[:, nonzero]
            # ridge, alpha=0.1, no intercept (reference graph_dataset.py:116-130)
            A = Cr.T @ Cr + 0.1 * np.eye(Cr.shape[1])
            coef = np.linalg.solve(A, Cr.T @ y)
            full = np.zeros(NUM_UNIV_ELEMENT)
            full[nonzero] = coef
            stats["elemwise_reference_energies"] = full.tolist()
        return stats

    # accessors mirroring the reference property names
    @property
    def per_atom_energy_mean(self):
        return self.statistics["per_atom_energy_mean"]

    @property
    def per_atom_energy_std(self):
        return self.statistics["per_atom_energy_std"]

    @property
    def elemwise_reference_energies(self):
        return self.statistics["elemwise_reference_energies"]

    @property
    def force_rms(self):
        return self.statistics["force_rms"]

    @property
    def avg_num_neigh(self):
        return self.statistics["avg_num_neigh"]

    @property
    def sqrt_avg_num_neigh(self):
        return self.statistics["sqrt_avg_num_neigh"]

    # -- batching ------------------------------------------------------------
    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        pad_multiple: int = 64,
        drop_last: bool = False,
        dense_k: int = 0,
        lazy: bool = False,
    ) -> Iterator[GraphBatch]:
        """Padded dense batches on the CPU: atom capacities rounded up to
        ``pad_multiple``, ``batch_size + 1`` graph slots, K = ``dense_k``
        (0: the dataset's largest neighbour count)."""
        if lazy:
            raise NotImplementedError(f"lazy batches are {_LATER}")
        if not self.graphs:
            raise ValueError("call build() first")
        dense_k = dense_k or self.max_neighbors()
        idx = np.arange(len(self.graphs))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        rup = lambda n: int(math.ceil(max(n, 1) / pad_multiple)) * pad_multiple  # noqa: E731
        for i in range(0, len(idx), batch_size):
            sel = idx[i : i + batch_size]
            if drop_last and len(sel) < batch_size:
                continue
            chunk = [self.graphs[j] for j in sel]
            n_at = sum(g.n_atoms_cap for g in chunk)
            yield batch_graphs(chunk, n_atoms_cap=rup(n_at + 1), n_graphs_cap=batch_size + 1,
                               dense_k=dense_k)

    def max_neighbors(self) -> int:
        """Largest per-atom neighbour count over the built graphs."""
        if not self.graphs:
            raise ValueError("call build() first")
        mx = 0
        for g in self.graphs:
            if g.edge_dst.numel():
                mx = max(mx, int(np.bincount(g.edge_dst.numpy()).max()))
        return mx

    def save_cache(self, path: str):
        raise NotImplementedError(f"the dataset disk cache is {_LATER}")

    @staticmethod
    def load_cache(path: str) -> "GraphDataset":
        raise NotImplementedError(f"the dataset disk cache is {_LATER}")

    def split(self, ratio: float, seed: int = 0):
        idx = np.arange(len(self.atoms_list))
        np.random.default_rng(seed).shuffle(idx)
        n_valid = int(len(idx) * ratio)
        valid_idx = set(idx[:n_valid].tolist())
        tr = [a for i, a in enumerate(self.atoms_list) if i not in valid_idx]
        va = [a for i, a in enumerate(self.atoms_list) if i in valid_idx]
        return (GraphDataset(tr, self.cutoff, self.z_to_type),
                GraphDataset(va, self.cutoff, self.z_to_type))
