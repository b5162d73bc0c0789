"""Multi-fidelity (multi-modal) dataset: per-modality datasets with combined
statistics (PyTorch port of ``sevennet_tpu/data/modal_dataset.py``; the
reference's ``SevenNetMultiModalDataset``,
``sevenn/train/modal_dataset.py:29-130``).

Each structure carries its modality index (``GraphBatch.modal``); the
shift and scale statistics are either pooled over the modalities
(``combined_mean/std/rms``) or kept per modality, a list in modal-index
order, for ``use_modal_wise_shift/scale``. Reads the reference's
multi-modal data config (``presets/multi_modal.yaml``)::

    load_trainset_path:
      - data_modality: pbe
        file_list: [{file: a.extxyz}, ...]
        data_weight: {energy: 1.0, force: 0.1, stress: 1.0}

Files are read by :meth:`GraphDataset.from_files` (any format
:func:`~.readers.read_structures` takes).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from .dataset import GraphDataset
from .graph import GraphBatch, batch_graphs

__all__ = ["MultiModalDataset", "combined_mean", "combined_std", "combined_rms"]


def combined_mean(means, sizes) -> float:
    means, sizes = np.asarray(means, float), np.asarray(sizes, float)
    return float((means * sizes).sum() / sizes.sum())


def _combined_variance(means, stds, sizes) -> float:
    means, stds, sizes = (np.asarray(a, float) for a in (means, stds, sizes))
    total = sizes.sum()
    cm = (means * sizes).sum() / total
    return float(((sizes * stds ** 2).sum() + (sizes * (means - cm) ** 2).sum()) / total)


def combined_std(means, stds, sizes) -> float:
    return float(np.sqrt(_combined_variance(means, stds, sizes)))


def combined_rms(means, stds, sizes) -> float:
    cm = combined_mean(means, sizes)
    return float(np.sqrt(cm ** 2 + _combined_variance(means, stds, sizes)))


def _weighted(info: Optional[Dict], weight: Dict[str, float]) -> Dict:
    """A structure's ``info`` with the modality's data weight multiplied
    into its own (a scalar weight applies to all three terms)."""
    info = dict(info or {})
    dw = info.get("data_weight", {})
    if isinstance(dw, (int, float)):
        dw = {"energy": dw, "force": dw, "stress": dw}
    info["data_weight"] = {k: float(dw.get(k, 1.0)) * float(weight.get(k, 1.0))
                           for k in ("energy", "force", "stress")}
    return info


@dataclass
class MultiModalDataset:
    """Per-modality datasets sharing one type map, in config order."""

    datasets: Dict[str, GraphDataset]
    modal_map: Dict[str, int]

    @staticmethod
    def from_config(entries: List[Dict], cutoff: float, modal_map=None) -> "MultiModalDataset":
        """``entries`` in the reference's multi-modal yaml format; the
        modality indices from ``modal_map``, else in entry order."""
        datasets: Dict[str, GraphDataset] = {}
        if modal_map is None:
            modal_map = {str(ent["data_modality"]): i for i, ent in enumerate(entries)}
        for ent in entries:
            name = str(ent["data_modality"])
            files = [f["file"] if isinstance(f, dict) else f for f in ent.get("file_list", [])]
            ds = GraphDataset.from_files(files, cutoff, modal=int(modal_map[name]))
            datasets[name] = ds
            # modality-level data weights multiply into per-structure weights
            # (reference: data_weight per database, multi_modal.yaml:85-88)
            if ent.get("data_weight"):
                for at in ds.atoms_list:
                    at.info = _weighted(at.info, ent["data_weight"])
        return MultiModalDataset(datasets, dict(modal_map))

    def __len__(self):
        return sum(len(d) for d in self.datasets.values())

    @property
    def species(self) -> List[str]:
        return sorted(set().union(*(d.species for d in self.datasets.values())))

    def build(self, z_to_type=None, processes: int = 1) -> "MultiModalDataset":
        for d in self.datasets.values():
            d.build(z_to_type, processes=processes)
        return self

    def split(self, ratio: float, seed: int = 777):
        """Each modality split by ``ratio`` (its own draw from ``seed``)."""
        tr, va = {}, {}
        for name, d in self.datasets.items():
            tr[name], va[name] = d.split(ratio, seed=seed)
        return MultiModalDataset(tr, self.modal_map), MultiModalDataset(va, self.modal_map)

    def max_neighbors(self) -> int:
        """Largest per-atom neighbour count over every modality's graphs."""
        return max(d.max_neighbors() for d in self.datasets.values() if d.graphs)

    # -- statistics -----------------------------------------------------------
    def _pooled(self, key_mean, key_std):
        means, stds, sizes = [], [], []
        for d in self.datasets.values():
            s = d.statistics
            means.append(s[key_mean])
            stds.append(s.get(key_std, 0.0))
            sizes.append(max(len(d), 1))
        return means, stds, sizes

    @property
    def per_atom_energy_mean(self) -> List[float]:
        """Per modality, in modal-index order (modal-wise shift); the pooled
        value is :attr:`per_atom_energy_mean_combined`."""
        by_idx = sorted(self.datasets.values(), key=lambda d: d.modal)
        return [d.per_atom_energy_mean for d in by_idx]

    @property
    def per_atom_energy_mean_combined(self) -> float:
        m, _, n = self._pooled("per_atom_energy_mean", "per_atom_energy_std")
        return combined_mean(m, n)

    @property
    def force_rms(self) -> float:
        """The pooled force rms: each modality's force mean taken as 0."""
        stds = [d.statistics["force_rms"] for d in self.datasets.values()]
        sizes = [max(len(d), 1) for d in self.datasets.values()]
        return combined_rms([0.0] * len(stds), stds, sizes)

    @property
    def avg_num_neigh(self) -> float:
        m, _, n = self._pooled("avg_num_neigh", "_none")
        return combined_mean(m, n)

    @property
    def sqrt_avg_num_neigh(self) -> float:
        return float(np.sqrt(self.avg_num_neigh))

    @property
    def elemwise_reference_energies(self) -> List[float]:
        """The ridge solution over every structure of every modality."""
        atoms = [at for d in self.datasets.values() for at in d.atoms_list]
        pooled = GraphDataset(atoms, next(iter(self.datasets.values())).cutoff)
        return pooled.statistics["elemwise_reference_energies"]

    # -- batching -------------------------------------------------------------
    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                pad_multiple: int = 64, dense_k: int = 0) -> Iterator[GraphBatch]:
        """Padded dense batches drawn from all modalities (globally shuffled
        with ``seed``), every graph carrying its modality; capacities as
        :meth:`GraphDataset.batches` gives them (K = ``dense_k``, 0: the
        largest neighbour count)."""
        if any(len(d) and not d.graphs for d in self.datasets.values()):
            raise ValueError("call build() first")
        graphs = [g for d in self.datasets.values() for g in d.graphs]
        dense_k = dense_k or self.max_neighbors()
        order = np.arange(len(graphs))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        rup = lambda n: int(math.ceil(max(n, 1) / pad_multiple)) * pad_multiple  # noqa: E731
        for i in range(0, len(order), batch_size):
            chunk = [graphs[j] for j in order[i: i + batch_size]]
            n_at = sum(g.n_atoms_cap for g in chunk)
            yield batch_graphs(chunk, n_atoms_cap=rup(n_at + 1), n_graphs_cap=batch_size + 1,
                               dense_k=dense_k)
