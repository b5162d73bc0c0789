"""Atom graphs as tensors with masks (PyTorch port of
``sevennet_tpu/data/graph.py``).

Conventions (matching the reference semantics):

- ``edge_src`` is the *sender*, ``edge_dst`` the *receiver*; messages flow
  src -> dst (``sevenn/nn/convolution.py:128-133``).
- ``edge_vec = pos[src] - pos[dst] + shift @ cell[graph(dst)]``.
- In the dense layout the edges form an ``(N, K)`` receiver-major slot grid
  (flat row ``i*K + k`` belongs to receiver ``i``); padded slots point at
  their own row (``src = dst = owner``) and are masked. ``edge_mir`` holds
  each slot's mirror edge (:func:`sevennet_tpu_torch.ops.fused_conv.mirror_map_numpy`).
- Batches (:func:`batch_graphs`) pad atoms and graphs to fixed capacities;
  padding atoms belong to the last graph slot, which is a padding graph.
- Labels use NaN for "unlabeled", like the reference loss masking
  (``sevenn/train/loss.py:49-60``).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "GraphBatch", "graph_from_arrays", "densify_edges", "dense_graph_from_arrays",
    "receiver_sorted", "dense_graph_device", "batch_graphs", "pad_graph",
]


@dataclass
class GraphBatch:
    # atoms
    positions: torch.Tensor  # (N, 3) float
    species: torch.Tensor  # (N,) int64 type indices (NOT atomic numbers)
    atom_mask: torch.Tensor  # (N,) bool
    batch: torch.Tensor  # (N,) int64 graph index
    # edges
    edge_src: torch.Tensor  # (E,) int64 sender
    edge_dst: torch.Tensor  # (E,) int64 receiver
    edge_shift: torch.Tensor  # (E, 3) float cell-shift counts
    edge_mask: torch.Tensor  # (E,) bool
    # graphs
    cell: torch.Tensor  # (G, 3, 3) float (rows are lattice vectors)
    volume: torch.Tensor  # (G,) float
    num_atoms: torch.Tensor  # (G,) int64
    graph_mask: torch.Tensor  # (G,) bool
    # dense layout only: flat mirror-edge index of every slot
    edge_mir: Optional[torch.Tensor] = None  # (E,) int64
    dense_k: int = 0  # K of the (N, K) slot grid; 0 = flat edge list
    # labels (NaN = unlabeled)
    energy: Optional[torch.Tensor] = None  # (G,) eV
    forces: Optional[torch.Tensor] = None  # (N, 3) eV/A
    stress: Optional[torch.Tensor] = None  # (G, 6) eV/A^3, -stress (xx,yy,zz,xy,yz,zx)
    # per-structure loss weights (reference loss.py:115-120)
    data_weight: Optional[torch.Tensor] = None  # (G, 3): energy/force/stress
    # multi-fidelity modality index of each graph (model/model.py:graph_modality)
    modal: Optional[torch.Tensor] = None  # (G,) int64

    @property
    def n_atoms_cap(self) -> int:
        return self.positions.shape[0]

    @property
    def n_graphs_cap(self) -> int:
        return self.cell.shape[0]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def to(self, device) -> "GraphBatch":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return replace(self, **moved)

    def edge_vectors(self, positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        pos = self.positions if positions is None else positions
        cell_per_edge = self.cell[self.batch[self.edge_dst]]
        return (
            pos[self.edge_src]
            - pos[self.edge_dst]
            + torch.einsum("ei,eij->ej", self.edge_shift, cell_per_edge)
        )


def graph_from_arrays(
    positions: np.ndarray,
    species: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_shift: np.ndarray,
    cell: Optional[np.ndarray] = None,
    device="cpu",
    dtype=np.float32,
    energy: Optional[float] = None,
    forces: Optional[np.ndarray] = None,
    stress: Optional[np.ndarray] = None,
    data_weight=None,
    modal: int = 0,
) -> GraphBatch:
    """Single graph with a flat, receiver-sorted edge list. Labels are kept
    where given (``stress`` as the 6-vector label, ``data_weight`` as the
    energy/force/stress triple); ``modal`` is the graph's modality index
    (multi-fidelity models)."""
    n = len(positions)
    e = len(edge_src)
    order = np.argsort(np.asarray(edge_dst), kind="stable")
    if cell is None:
        cell_np, volume = np.zeros((3, 3), dtype), 0.0
    else:
        cell_np = np.asarray(cell, dtype)
        volume = float(abs(np.linalg.det(np.asarray(cell, np.float64))))
    t = lambda a, d: torch.as_tensor(np.asarray(a, d), device=device)  # noqa: E731
    return GraphBatch(
        positions=t(positions, dtype),
        species=t(species, np.int64),
        atom_mask=torch.ones(n, dtype=torch.bool, device=device),
        batch=torch.zeros(n, dtype=torch.int64, device=device),
        edge_src=t(np.asarray(edge_src)[order], np.int64),
        edge_dst=t(np.asarray(edge_dst)[order], np.int64),
        edge_shift=t(np.asarray(edge_shift).reshape(e, 3)[order], dtype),
        edge_mask=torch.ones(e, dtype=torch.bool, device=device),
        cell=t(cell_np[None], dtype),
        volume=t([max(volume, 1e-3)], dtype),
        num_atoms=t([n], np.int64),
        graph_mask=torch.ones(1, dtype=torch.bool, device=device),
        energy=None if energy is None else t([energy], dtype),
        forces=None if forces is None else t(forces, dtype).reshape(n, 3),
        stress=None if stress is None else t(stress, dtype).reshape(1, 6),
        data_weight=None if data_weight is None else t([list(data_weight)], dtype),
        modal=t([modal], np.int64),
    )


def densify_edges(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_shift: np.ndarray,
    edge_mask: np.ndarray,
    n_cap: int,
    k_cap: int,
    dtype=np.float32,
):
    """Redistribute a flat dst-sorted edge list into the dense (N, K) slot
    layout the fused convolution consumes (flat row = i*K + k, receiver i).

    Padded slots get ``src = dst = owner`` (self-gather, masked); raises if
    any atom has more than ``k_cap`` neighbors.
    """
    real = np.flatnonzero(edge_mask)
    dst = edge_dst[real]
    counts = np.bincount(dst, minlength=n_cap)
    if counts.max(initial=0) > k_cap:
        raise ValueError(
            f"dense neighbor capacity {k_cap} < max neighbor count "
            f"{int(counts.max())}"
        )
    starts = np.zeros(n_cap + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(dst)) - starts[dst]
    flat = dst.astype(np.int64) * k_cap + slot
    owner = (np.arange(n_cap * k_cap) // k_cap).astype(np.int32)
    src_d = owner.copy()
    dst_d = owner.copy()
    shift_d = np.zeros((n_cap * k_cap, 3), dtype)
    mask_d = np.zeros(n_cap * k_cap, bool)
    src_d[flat] = edge_src[real]
    shift_d[flat] = edge_shift[real]
    mask_d[flat] = True
    return src_d, dst_d, shift_d, mask_d


def dense_graph_from_arrays(
    positions: np.ndarray,
    species: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_shift: np.ndarray,
    cell: Optional[np.ndarray] = None,
    device="cpu",
    dtype=np.float32,
    modal: int = 0,
) -> GraphBatch:
    """Single graph in the dense ``(N, K)`` slot layout with its mirror
    index, built on the host. ``K`` is the largest neighbour count: the
    kernels need a rectangular grid but no further padding."""
    from ..ops.fused_conv import mirror_map_numpy

    flat = graph_from_arrays(positions, species, edge_src, edge_dst, edge_shift, cell, "cpu", dtype,
                             modal=modal)
    n = flat.n_atoms_cap
    dst = flat.edge_dst.numpy()
    k = max(int(np.bincount(dst, minlength=n).max(initial=0)), 1)
    src_d, dst_d, shift_d, mask_d = densify_edges(
        flat.edge_src.numpy(), dst, flat.edge_shift.numpy(), flat.edge_mask.numpy(), n, k, dtype
    )
    mir = mirror_map_numpy(
        src_d.reshape(n, k), shift_d.reshape(n, k, 3), mask_d.reshape(n, k)
    ).reshape(-1)
    dense = replace(
        flat,
        edge_src=torch.as_tensor(src_d, dtype=torch.int64),
        edge_dst=torch.as_tensor(dst_d, dtype=torch.int64),
        edge_shift=torch.as_tensor(shift_d),
        edge_mask=torch.as_tensor(mask_d),
        edge_mir=torch.as_tensor(mir, dtype=torch.int64),
        dense_k=k,
    )
    return dense.to(device)


def receiver_sorted(edge_dst: np.ndarray, edge_src: np.ndarray, edge_shift: np.ndarray):
    """The edges in receiver order, ``(dst, src, shift)``: a stable sort by
    ``dst`` (none when they are sorted already, as the native list gives
    them), so that each receiver keeps its edges in the list's order."""
    dst = np.asarray(edge_dst, np.int64)
    if dst.size and not (dst[1:] >= dst[:-1]).all():
        order = np.argsort(dst, kind="stable")
        return dst[order], np.asarray(edge_src)[order], np.asarray(edge_shift).reshape(-1, 3)[order]
    return dst, np.asarray(edge_src), np.asarray(edge_shift).reshape(-1, 3)


def dense_graph_device(
    positions: np.ndarray,
    species: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_shift: np.ndarray,
    cell: Optional[np.ndarray] = None,
    device="cpu",
    dtype=np.float32,
    modal: int = 0,
) -> GraphBatch:
    """The graph of :func:`dense_graph_from_arrays`, bit for bit, with the
    slot grid and the mirror index built on ``device``: the host counts the
    receiver-sorted edges (:func:`receiver_sorted`) for ``K`` and each
    receiver's first edge; the device scatters the edges into the ``(N,
    K)`` grid and builds the mirror index with
    :func:`~sevennet_tpu_torch.ops.fused_conv.mirror_map` (as
    ``sevennet_tpu/calculator.py:88-160`` does on the TPU). ``K`` is the
    largest neighbour count."""
    from ..ops.fused_conv import mirror_map

    n, e = len(positions), len(edge_src)
    dst = np.asarray(edge_dst, np.int64)
    if e and (dst[1:] < dst[:-1]).any():
        raise ValueError("dense_graph_device takes edges sorted by receiver (receiver_sorted)")
    counts = np.bincount(dst, minlength=n)
    k = max(int(counts.max(initial=0)), 1)
    starts = np.zeros(n, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    dst_t = torch.as_tensor(dst, device=device)
    flat = dst_t * k + torch.arange(e, device=device) - torch.as_tensor(starts, device=device)[dst_t]
    owner = torch.arange(n * k, device=device) // k
    src_d = owner.clone()
    src_d[flat] = torch.as_tensor(np.asarray(edge_src, np.int64), device=device)
    shift_d = torch.zeros((n * k, 3), dtype=tdt, device=device)
    shift_d[flat] = torch.as_tensor(np.asarray(edge_shift, dtype).reshape(e, 3), device=device)
    mask_d = torch.zeros(n * k, dtype=torch.bool, device=device)
    mask_d[flat] = True
    mir = mirror_map(src_d.view(n, k), shift_d.view(n, k, 3), mask_d.view(n, k)).reshape(-1)
    atoms = graph_from_arrays(positions, species, np.zeros(0, np.int64), np.zeros(0, np.int64),
                              np.zeros((0, 3)), cell, device, dtype, modal=modal)
    return replace(atoms, edge_src=src_d, edge_dst=owner, edge_shift=shift_d, edge_mask=mask_d,
                   edge_mir=mir, dense_k=k)


def _pad_to(arr: np.ndarray, n: int, fill=0):
    pad = n - arr.shape[0]
    if pad < 0:
        raise ValueError(f"capacity {n} < size {arr.shape[0]}")
    if pad == 0:
        return np.asarray(arr)
    pad_block = np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([np.asarray(arr), pad_block], axis=0)


def _numpy(t: Optional[torch.Tensor]):
    return None if t is None else t.detach().cpu().numpy()


def batch_graphs(
    graphs: Sequence[GraphBatch],
    n_atoms_cap: Optional[int] = None,
    n_graphs_cap: Optional[int] = None,
    dense_k: int = 0,
    device="cpu",
    dtype=np.float32,
) -> GraphBatch:
    """Concatenates single flat graphs (:func:`graph_from_arrays`) into one
    padded batch in the dense ``(N, K)`` slot layout with its mirror index
    (the port of ``sevennet_tpu/data/graph.py:batch_graphs`` with
    ``dense_k`` set and ``with_mirror``). ``dense_k <= 0`` takes the batch's
    largest neighbour count. Padding atoms sit at position 0 with species 0
    in the last graph slot; padding graphs have volume 1, one atom, NaN
    energy and stress labels, unit data weights and modality 0."""
    from ..ops.fused_conv import mirror_map_numpy

    gs = [{k: _numpy(getattr(g, k)) for k in (
        "positions", "species", "edge_src", "edge_dst", "edge_shift", "cell", "volume",
        "energy", "forces", "stress", "data_weight", "modal")} for g in graphs]
    n_tot = sum(g["positions"].shape[0] for g in gs)
    g_tot = len(gs)
    n_cap = n_atoms_cap or n_tot
    g_cap = n_graphs_cap or g_tot
    if n_cap < n_tot or g_cap < g_tot:
        raise ValueError(f"capacities ({n_cap} atoms, {g_cap} graphs) below the batch's "
                         f"({n_tot}, {g_tot})")

    pos, spec, bat, f, esrc, edst, eshift = [], [], [], [], [], [], []
    cells, vols, natoms, energies, stresses, weights, modals = [], [], [], [], [], [], []
    a_off = 0
    for gi, g in enumerate(gs):
        n = g["positions"].shape[0]
        pos.append(g["positions"])
        spec.append(g["species"])
        bat.append(np.full((n,), gi, np.int64))
        f.append(g["forces"] if g["forces"] is not None else np.full((n, 3), np.nan, dtype))
        esrc.append(g["edge_src"] + a_off)
        edst.append(g["edge_dst"] + a_off)
        eshift.append(g["edge_shift"])
        cells.append(g["cell"][0])
        vols.append(g["volume"][0])
        natoms.append(n)
        energies.append(g["energy"][0] if g["energy"] is not None else np.nan)
        stresses.append(g["stress"][0] if g["stress"] is not None else np.full(6, np.nan))
        weights.append(g["data_weight"][0] if g["data_weight"] is not None else [1.0] * 3)
        modals.append(g["modal"][0] if g["modal"] is not None else 0)
        a_off += n

    e_src = np.concatenate(esrc).astype(np.int64)
    e_dst = np.concatenate(edst).astype(np.int64)
    if dense_k <= 0:
        dense_k = max(int(np.bincount(e_dst, minlength=n_cap).max(initial=0)), 1)
    src_d, dst_d, shift_d, mask_d = densify_edges(
        e_src, e_dst, np.concatenate(eshift).astype(dtype), np.ones(len(e_src), bool),
        n_cap, dense_k, dtype,
    )
    mir = mirror_map_numpy(
        src_d.reshape(n_cap, dense_k), shift_d.reshape(n_cap, dense_k, 3),
        mask_d.reshape(n_cap, dense_k),
    ).reshape(-1)

    def t(a, d):
        return torch.as_tensor(np.asarray(a, d), device=device)

    return GraphBatch(
        positions=t(_pad_to(np.concatenate(pos).astype(dtype), n_cap), dtype),
        species=t(_pad_to(np.concatenate(spec).astype(np.int64), n_cap), np.int64),
        atom_mask=t(_pad_to(np.ones(n_tot, bool), n_cap, fill=False), bool),
        batch=t(_pad_to(np.concatenate(bat), n_cap, fill=g_cap - 1), np.int64),
        edge_src=t(src_d, np.int64),
        edge_dst=t(dst_d, np.int64),
        edge_shift=t(shift_d, dtype),
        edge_mask=t(mask_d, bool),
        cell=t(_pad_to(np.stack(cells).astype(dtype), g_cap), dtype),
        volume=t(_pad_to(np.asarray(vols, dtype), g_cap, fill=1.0), dtype),
        num_atoms=t(_pad_to(np.asarray(natoms, np.int64), g_cap, fill=1), np.int64),
        graph_mask=t(_pad_to(np.ones(g_tot, bool), g_cap, fill=False), bool),
        edge_mir=t(mir, np.int64),
        dense_k=dense_k,
        energy=t(_pad_to(np.asarray(energies, dtype), g_cap, fill=np.nan), dtype),
        forces=t(_pad_to(np.concatenate(f).astype(dtype), n_cap), dtype),
        stress=t(_pad_to(np.stack(stresses).astype(dtype), g_cap, fill=np.nan), dtype),
        data_weight=t(_pad_to(np.asarray(weights, dtype), g_cap, fill=1.0), dtype),
        modal=t(_pad_to(np.asarray(modals, np.int64), g_cap), np.int64),
    )


def pad_graph(g: GraphBatch, n_atoms_cap: int, dense_k: int = 0, device="cpu") -> GraphBatch:
    """One flat graph as a dense batch of ``n_atoms_cap`` atoms."""
    return batch_graphs([g], n_atoms_cap=n_atoms_cap, dense_k=dense_k, device=device)
