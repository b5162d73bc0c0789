"""On-device cell-list neighbour rebuild (PyTorch port of
``sevennet_tpu/md/neighbor.py``).

Fixed capacities and overflow flags, as in the JAX package: a rebuild never
grows a tensor; it raises a flag, and the engine grows its capacities from
a snapshot and retries (``sevennet_tpu/md/engine.py:909-1018``).

Algorithm, in tensor operations on the positions' device:

1. wrap fractional coordinates, bin atoms into an ``nx*ny*nz`` grid (grid
   cell edge >= cutoff along each lattice height);
2. sort atoms by cell id; per-cell contiguous ranges;
3. for each of the 27 neighbour-cell offsets, gather up to
   ``cell_capacity`` candidates and test their distances; one row cumsum
   gives each accepted candidate its slot, one scatter writes the slots;
4. report overflow (cell or neighbour capacity exceeded).

The ``(N, 27 * cell_capacity)`` candidate tables are about 1 GB at 100k
atoms. Every lattice height must be at least the cutoff (one periodic
image per direction).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = ["CellListSpec", "build_cell_list_spec", "rebuild_neighbors"]


@dataclass(frozen=True)
class CellListSpec:
    n_cells: Tuple[int, int, int]
    cell_capacity: int
    neighbor_capacity: int
    cutoff: float  # interaction cutoff + skin

    @property
    def total_cells(self) -> int:
        nx, ny, nz = self.n_cells
        return nx * ny * nz


def build_cell_list_spec(
    cell: np.ndarray,
    n_atoms: int,
    cutoff: float,
    skin: float = 0.5,
    capacity_factor: float = 1.6,
    neighbor_capacity: int | None = None,
) -> CellListSpec:
    """Host-side: choose static grid dims and capacities."""
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    rc = cutoff + skin
    recip = np.linalg.inv(cell).T
    heights = 1.0 / np.linalg.norm(recip, axis=1)
    n_cells = np.maximum(np.floor(heights / rc).astype(int), 1)
    if (heights < rc).any():
        raise ValueError(
            f"lattice heights {heights} smaller than cutoff+skin {rc}; "
            "use the host neighbor list for small boxes"
        )
    vol = abs(np.linalg.det(cell))
    density = n_atoms / vol
    cell_vol = vol / n_cells.prod()
    cap = int(np.ceil(density * cell_vol * capacity_factor)) + 2
    if neighbor_capacity is None:
        # sphere volume * density * safety (per-atom worst case)
        expected_nbrs = 4.0 / 3.0 * np.pi * rc**3 * density
        neighbor_capacity = int(np.ceil(expected_nbrs * capacity_factor)) + 4
    return CellListSpec(
        n_cells=tuple(int(x) for x in n_cells),
        cell_capacity=cap,
        neighbor_capacity=int(neighbor_capacity),
        cutoff=rc,
    )


def cell_coords(spec: CellListSpec, positions: torch.Tensor, cell: torch.Tensor):
    """Wrapped fractional coordinates ``(N, 3)`` and integer grid cell of
    each atom ``(N, 3)``."""
    frac = positions @ torch.linalg.inv(cell)
    frac = frac - torch.floor(frac)  # wrap to [0, 1)
    grid = torch.tensor(spec.n_cells, device=positions.device)
    coords = torch.minimum(torch.clamp((frac * grid).to(torch.int64), min=0), grid - 1)
    return frac, coords


def rebuild_neighbors(spec: CellListSpec, positions, cell, atom_mask):
    """positions (N, 3), cell (3, 3), atom_mask (N,) ->
    ``(edge_src, edge_dst, edge_shift, edge_mask, overflow, pos_w)``.

    For edge e, ``vec_e = pos_w[src] + shift @ cell - pos_w[dst]``; both
    directions are emitted. The arrays are the dense slot grid of ``N *
    neighbor_capacity`` entries (``dst`` is the slot owner; the JAX
    package's compaction to ``edge_cap`` entries serves its sparse conv
    and its D3 list, which the port does not have); ``overflow`` is a 0-d
    bool tensor, ``pos_w`` the wrapped positions."""
    n = positions.shape[0]
    dev = positions.device
    nx, ny, nz = spec.n_cells
    ncells = spec.total_cells
    C, K = spec.cell_capacity, spec.neighbor_capacity

    frac, coords = cell_coords(spec, positions, cell)
    grid = torch.tensor(spec.n_cells, device=dev)
    cid = (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]
    # park padded atoms in a virtual overflow cell
    cid = torch.where(atom_mask, cid, ncells)
    counts = torch.bincount(cid, minlength=ncells + 1)
    order = torch.argsort(cid, stable=True)  # atoms sorted by cell
    starts = torch.cumsum(counts, 0) - counts
    cell_overflow = (counts[:ncells] > C).any()

    # per-cell member table (ncells, C)
    k_iota = torch.arange(C, device=dev)
    member_idx = torch.clamp(starts[:ncells, None] + k_iota[None, :], 0, n - 1)
    member_valid = k_iota[None, :] < torch.clamp(counts[:ncells, None], max=C)
    members = torch.where(member_valid, order[member_idx], n - 1)

    pos_w = frac @ cell
    rows = torch.arange(n, device=dev)
    cands, oks, shifts = [], [], []
    for off in itertools.product((-1, 0, 1), repeat=3):
        nb = coords + torch.tensor(off, device=dev)
        S = torch.div(nb, grid, rounding_mode="floor")  # periodic image shift
        nbw = nb - S * grid
        nb_cid = (nbw[:, 0] * ny + nbw[:, 1]) * nz + nbw[:, 2]
        cand = members[nb_cid]  # (N, C) sender candidates
        vec = pos_w[cand] + (S.to(pos_w.dtype) @ cell)[:, None, :] - pos_w[:, None, :]
        within = torch.sum(vec * vec, dim=-1) < spec.cutoff ** 2
        is_self = (cand == rows[:, None]) & (S == 0).all(-1)[:, None]
        cands.append(cand)
        oks.append(within & member_valid[nb_cid] & ~is_self & atom_mask[:, None]
                   & atom_mask[cand])
        shifts.append(S.to(torch.int8)[:, None, :].expand(n, C, 3))
    cand_all = torch.cat(cands, 1)  # (N, 27C)
    ok_all = torch.cat(oks, 1)
    shift_all = torch.cat(shifts, 1)  # (N, 27C, 3) int8
    slot = torch.cumsum(ok_all.to(torch.int32), 1) - 1
    keep = ok_all & (slot < K)
    r = rows[:, None].expand_as(cand_all)[keep]
    s = slot[keep].long()
    src_slots = torch.zeros((n, K), dtype=torch.int64, device=dev)
    src_slots[r, s] = cand_all[keep]
    shift_slots = torch.zeros((n, K, 3), dtype=torch.int8, device=dev)
    shift_slots[r, s] = shift_all[keep]
    valid_slots = torch.zeros((n, K), dtype=torch.bool, device=dev)
    valid_slots[r, s] = True
    neighbor_overflow = (ok_all.sum(1) > K).any()

    edge_mask = valid_slots.reshape(-1)
    edge_src = torch.where(edge_mask, src_slots.reshape(-1), 0)
    edge_dst = torch.repeat_interleave(rows, K)
    edge_shift = shift_slots.reshape(-1, 3).to(positions.dtype)
    return edge_src, edge_dst, edge_shift, edge_mask, cell_overflow | neighbor_overflow, pos_w
