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
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

__all__ = ["GraphBatch", "graph_from_arrays", "densify_edges", "dense_graph_from_arrays"]


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
) -> GraphBatch:
    """Single graph with a flat, receiver-sorted edge list."""
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
) -> GraphBatch:
    """Single graph in the dense ``(N, K)`` slot layout with its mirror
    index, built on the host. ``K`` is the largest neighbour count: the
    kernels need a rectangular grid but no further padding."""
    from ..ops.fused_conv import mirror_map_numpy

    flat = graph_from_arrays(positions, species, edge_src, edge_dst, edge_shift, cell, "cpu", dtype)
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
