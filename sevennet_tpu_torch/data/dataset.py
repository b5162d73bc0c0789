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

Multi-fidelity sets are :class:`~.modal_dataset.MultiModalDataset`s of
these, one per modality. Files are read by :func:`~.readers.read_structures`
(extxyz, OUTCAR, POSCAR, structure_list; others through ASE where it is
installed). The graph build may fan out over a ``fork`` pool of numpy-only
workers, batches may be built lazily, and built graphs with their
statistics go to a disk cache in the JAX package's format.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..atoms import AtomsLite
from ..model.build import CHEMICAL_SYMBOLS, NUM_UNIV_ELEMENT
from .graph import GraphBatch, batch_graphs, graph_from_arrays
from .neighborlist import NATIVE_MIN_ATOMS, neighbor_list_numpy

__all__ = ["GraphDataset", "atoms_to_graph", "graph_arrays"]

# the arrays of a graph in the disk cache, as the JAX package writes them
# (sevennet_tpu/data/dataset.py:save_cache)
CACHE_KEYS = ("positions", "species", "edge_src", "edge_dst", "edge_shift", "energy", "forces",
              "stress", "modal", "data_weight", "cell")


def graph_arrays(at: AtomsLite, cutoff: float, z_to_type: np.ndarray,
                 modal: int = 0) -> Dict[str, Any]:
    """The numpy arguments of :func:`~.graph.graph_from_arrays` for one
    labeled structure (the neighbour list and the labels, missing ones
    NaN): numpy only, so that a forked worker can build them."""
    species = z_to_type[at.numbers]
    if (species < 0).any():
        bad = sorted(set(int(z) for z in at.numbers[species < 0]))
        raise ValueError(f"unknown species {bad} for this model")
    dst, src, shifts = neighbor_list_numpy(at.positions, cutoff, at.cell, at.pbc)
    dw = at.info.get("data_weight", {}) if at.info else {}
    if isinstance(dw, (int, float)):
        dw = {"energy": dw, "force": dw, "stress": dw}
    n = len(at)
    return dict(
        positions=at.positions, species=species, edge_src=src, edge_dst=dst,
        edge_shift=shifts, cell=at.cell,
        energy=at.energy if at.energy is not None else np.nan,
        forces=at.forces if at.forces is not None else np.full((n, 3), np.nan),
        stress=at.stress if at.stress is not None else np.full(6, np.nan),
        data_weight=(float(dw.get("energy", 1.0)), float(dw.get("force", 1.0)),
                     float(dw.get("stress", 1.0))),
        modal=modal,
    )


def atoms_to_graph(at: AtomsLite, cutoff: float, z_to_type: np.ndarray,
                   modal: int = 0) -> GraphBatch:
    """A single labeled graph with a flat edge list on the CPU (reference
    ``atoms_to_graph``, ``dataload.py:102-223``), of modality ``modal``.
    Missing labels are NaN."""
    return graph_from_arrays(**graph_arrays(at, cutoff, z_to_type, modal))


class _BuildOne:
    """Picklable worker of the multiprocess build: one structure's
    :func:`graph_arrays`, numpy in and numpy out (a forked child of a
    process that has used torch's thread pool or CUDA must not touch
    either)."""

    def __init__(self, cutoff, z_to_type, modal):
        self.cutoff, self.z_to_type, self.modal = cutoff, z_to_type, modal

    def __call__(self, at):
        return graph_arrays(at, self.cutoff, self.z_to_type, self.modal)


@dataclass
class GraphDataset:
    atoms_list: List[AtomsLite]
    cutoff: float
    z_to_type: Optional[np.ndarray] = None
    graphs: List[GraphBatch] = field(default_factory=list)
    _stats: Optional[Dict] = None
    modal: int = 0  # modality index of every graph (multi-fidelity training)

    @staticmethod
    def from_files(path, cutoff: float, z_to_type=None, modal: int = 0) -> "GraphDataset":
        """Every frame of the structure file(s) ``path``, of modality
        ``modal``, read by :func:`~.readers.read_structures` (extxyz,
        OUTCAR, POSCAR/CONTCAR, structure_list; other formats through
        ``ase.io.read`` where ASE is installed)."""
        from .readers import read_structures

        paths = [path] if isinstance(path, str) else list(path)
        frames: List[AtomsLite] = []
        for p in paths:
            frames.extend(read_structures(str(p)))
        return GraphDataset(frames, cutoff, z_to_type, modal=modal)

    # -- species ------------------------------------------------------------
    @property
    def species(self) -> List[str]:
        zs = sorted({int(z) for at in self.atoms_list for z in at.numbers})
        return [CHEMICAL_SYMBOLS[z] for z in zs]

    def build(self, z_to_type: Optional[np.ndarray] = None, processes: int = 1):
        """Builds every graph (neighbour lists and labels). ``processes >
        1`` (the config key ``preprocess_num_cores``) fans the numpy work
        over a ``fork`` pool, as ``sevennet_tpu/data/dataset.py:106-128``
        and the reference's ``graph_build`` (``dataload.py:226-269``): the
        workers return numpy arrays and the graphs are made here, so no
        child touches torch. The native neighbour list is built here
        first, where a structure will use it."""
        if z_to_type is not None:
            self.z_to_type = z_to_type
        if self.z_to_type is None:
            raise ValueError("build() needs z_to_type")
        work = _BuildOne(self.cutoff, self.z_to_type, self.modal)
        if processes > 1 and len(self.atoms_list) > 1:
            import multiprocessing as mp

            if any(at.cell is not None and len(at) >= NATIVE_MIN_ATOMS for at in self.atoms_list):
                from ..native import library

                library()
            with mp.get_context("fork").Pool(processes) as pool:
                arrays = pool.map(work, self.atoms_list,
                                  chunksize=max(1, len(self.atoms_list) // (processes * 8)))
        else:
            arrays = map(work, self.atoms_list)
        self.graphs = [graph_from_arrays(**a) for a in arrays]
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
        (0: the dataset's largest neighbour count). With ``lazy=True`` each
        batch's graphs are built when it is made (the reference's
        memory-light ``SevenNetAtomsDataset``,
        ``sevennet_tpu/data/dataset.py:203-252``): ``build()`` is not
        needed, but ``z_to_type`` and ``dense_k`` are."""
        if lazy:
            if self.z_to_type is None or not dense_k:
                raise ValueError("lazy batches need z_to_type and dense_k")
            n_items = len(self.atoms_list)
        elif not self.graphs:
            raise ValueError("call build() first (or use lazy=True)")
        else:
            n_items = len(self.graphs)
        dense_k = dense_k or self.max_neighbors()
        idx = np.arange(n_items)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        rup = lambda n: int(math.ceil(max(n, 1) / pad_multiple)) * pad_multiple  # noqa: E731
        for i in range(0, len(idx), batch_size):
            sel = idx[i : i + batch_size]
            if drop_last and len(sel) < batch_size:
                continue
            chunk = ([atoms_to_graph(self.atoms_list[j], self.cutoff, self.z_to_type, self.modal)
                      for j in sel] if lazy else [self.graphs[j] for j in sel])
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

    # -- disk cache, in the JAX package's format (sevennet_tpu/data/
    #    dataset.py:266-314): a cache written by either package loads in
    #    the other ---------------------------------------------------------
    def save_cache(self, path: str):
        """Built graphs to ``{path}.npz`` (``g{i}_{key}`` arrays of
        :data:`CACHE_KEYS` and ``n``) and the cutoff and statistics to
        ``{path}.json``."""
        import json

        if not self.graphs:
            raise ValueError("call build() first")
        arrays = {f"g{i}_{key}": getattr(g, key).numpy()
                  for i, g in enumerate(self.graphs) for key in CACHE_KEYS}
        np.savez_compressed(path + ".npz", n=len(self.graphs), **arrays)
        with open(path + ".json", "w") as f:
            json.dump({"cutoff": self.cutoff, "statistics": self.statistics}, f)

    @staticmethod
    def load_cache(path: str) -> "GraphDataset":
        """The graphs and statistics of :meth:`save_cache` (no structures:
        the statistics come from the cache)."""
        import json

        z = np.load(path + ".npz")
        with open(path + ".json") as f:
            meta = json.load(f)
        ds = GraphDataset([], meta["cutoff"])
        ds.graphs = [graph_from_arrays(
            z[f"g{i}_positions"], z[f"g{i}_species"], z[f"g{i}_edge_src"],
            z[f"g{i}_edge_dst"], z[f"g{i}_edge_shift"], z[f"g{i}_cell"][0],
            energy=float(z[f"g{i}_energy"][0]), forces=z[f"g{i}_forces"],
            stress=z[f"g{i}_stress"][0], modal=int(z[f"g{i}_modal"][0]),
            data_weight=tuple(z[f"g{i}_data_weight"][0].tolist()),
        ) for i in range(int(z["n"]))]
        ds._stats = meta["statistics"]
        return ds

    def split(self, ratio: float, seed: int = 0):
        idx = np.arange(len(self.atoms_list))
        np.random.default_rng(seed).shuffle(idx)
        n_valid = int(len(idx) * ratio)
        valid_idx = set(idx[:n_valid].tolist())
        tr = [a for i, a in enumerate(self.atoms_list) if i not in valid_idx]
        va = [a for i, a in enumerate(self.atoms_list) if i in valid_idx]
        return (GraphDataset(tr, self.cutoff, self.z_to_type, modal=self.modal),
                GraphDataset(va, self.cutoff, self.z_to_type, modal=self.modal))
