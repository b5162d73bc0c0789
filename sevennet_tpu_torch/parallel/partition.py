"""Spatial domain decomposition, host side (the port of
``sevennet_tpu/parallel/partition.py``, numpy only, its arrays equal to the
JAX package's).

The redesign of the reference's LAMMPS brick decomposition and ghost-atom
scheme (``pair_e3gnn_parallel.cpp:253-301``, ``comm_brick.cpp:1057-1123``):

- the box is sliced into D slabs along one lattice axis, one rank each;
- each rank owns up to ``n_local_cap`` atoms and hosts up to
  ``n_ghost_cap`` ghost slots; ghosts are atoms owned by the two adjacent
  slabs (slab thickness must be >= cutoff) that fall within one cutoff of
  the slab boundary;
- communication is described by static index maps computed here:
  ``send_idx_left`` / ``send_idx_right`` (owned atoms to ship to each
  neighbour), and the ghost slots are ordered [left ghosts | right
  ghosts], so the exchange per layer is one swap with each neighbour of
  fixed shapes (:mod:`.comm`);
- ghost positions are rebuilt on the receiver as the owner's position plus
  a fixed lattice shift, so position gradients flow back to the owners
  through the exchange's backward.

Edges are built on the host with the full neighbour-list semantics of the
single-device path: ``dst`` is an owned atom index, ``src`` indexes the
extended array [owned | ghosts].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..data.neighborlist import neighbor_list_numpy

__all__ = ["DomainDecomposition", "partition_system"]


@dataclass
class DomainDecomposition:
    """Per-rank stacked arrays (leading axis = rank)."""

    n_devices: int
    axis: int  # lattice axis used for slabs
    cell: np.ndarray  # (3,3) global cell
    # owned atoms
    positions: np.ndarray  # (D, N_cap, 3)
    species: np.ndarray  # (D, N_cap) int32
    atom_mask: np.ndarray  # (D, N_cap) bool
    owner_global_idx: np.ndarray  # (D, N_cap) int64, -1 for padding
    # halo exchange maps (static)
    send_idx_left: np.ndarray  # (D, S_cap) int32 indices into owned slots
    send_mask_left: np.ndarray  # (D, S_cap) bool
    send_idx_right: np.ndarray
    send_mask_right: np.ndarray
    ghost_shift: np.ndarray  # (D, G_cap, 3) lattice shift counts for ghosts
    ghost_mask: np.ndarray  # (D, G_cap) bool
    n_ghost_left_cap: int  # ghosts [0:GL) from left neighbor, [GL:GL+GR) right
    # edges (dst owned, src in extended = owned ++ ghosts)
    edge_src: np.ndarray  # (D, E_cap) int32 (< N_cap + G_cap)
    edge_dst: np.ndarray  # (D, E_cap) int32 (< N_cap)
    edge_shift: np.ndarray  # (D, E_cap, 3)
    edge_mask: np.ndarray  # (D, E_cap) bool

    @property
    def n_local_cap(self):
        return self.positions.shape[1]

    @property
    def n_ghost_cap(self):
        return self.ghost_shift.shape[1]


def _round_up(n, m=8):
    return int(np.ceil(max(n, 1) / m)) * m


def partition_system(
    positions: np.ndarray,
    species: np.ndarray,
    cell: np.ndarray,
    cutoff: float,
    n_devices: int,
    axis: int = 0,
    pad_multiple: int = 8,
) -> DomainDecomposition:
    """Slab-decompose a periodic system for ``n_devices`` devices."""
    positions = np.asarray(positions, np.float64)
    species = np.asarray(species, np.int32)
    cell = np.asarray(cell, np.float64).reshape(3, 3)
    n = len(positions)

    inv = np.linalg.inv(cell)
    frac = positions @ inv
    frac -= np.floor(frac)  # wrap
    pos_w = frac @ cell

    # slab ownership along `axis` in fractional space
    slab = np.minimum((frac[:, axis] * n_devices).astype(int), n_devices - 1)

    # slab thickness must cover the cutoff (one-neighbor halo)
    recip = inv.T
    height = 1.0 / np.linalg.norm(recip[axis])
    if height / n_devices < cutoff:
        raise ValueError(
            f"slab thickness {height / n_devices:.2f} A < cutoff {cutoff}; "
            "use fewer devices or a bigger box"
        )

    owned: List[np.ndarray] = [np.where(slab == d)[0] for d in range(n_devices)]
    n_cap = _round_up(max(len(o) for o in owned), pad_multiple)

    # ghost selection: an atom is shipped to neighbor d±1 if it lies within
    # `cutoff` (fractional band) of that boundary
    band = cutoff / height  # fractional thickness of the halo band
    lo_edge = np.array([d / n_devices for d in range(n_devices)])
    hi_edge = np.array([(d + 1) / n_devices for d in range(n_devices)])

    send_left: List[np.ndarray] = []
    send_right: List[np.ndarray] = []
    for d in range(n_devices):
        f = frac[owned[d], axis]
        send_left.append(owned[d][f < lo_edge[d] + band])  # to device d-1
        send_right.append(owned[d][f > hi_edge[d] - band])  # to device d+1
    s_cap = _round_up(
        max(max(len(s) for s in send_left), max(len(s) for s in send_right)),
        pad_multiple,
    )

    # global->local owned index
    local_of = -np.ones(n, np.int64)
    for d in range(n_devices):
        local_of[owned[d]] = np.arange(len(owned[d]))

    D = n_devices
    gl_cap = gr_cap = s_cap
    g_cap = gl_cap + gr_cap

    pos_arr = np.zeros((D, n_cap, 3))
    spec_arr = np.zeros((D, n_cap), np.int32)
    mask_arr = np.zeros((D, n_cap), bool)
    gidx_arr = -np.ones((D, n_cap), np.int64)
    sil = np.zeros((D, s_cap), np.int32)
    sml = np.zeros((D, s_cap), bool)
    sir = np.zeros((D, s_cap), np.int32)
    smr = np.zeros((D, s_cap), bool)
    gshift = np.zeros((D, g_cap, 3))
    gmask = np.zeros((D, g_cap), bool)

    for d in range(D):
        o = owned[d]
        pos_arr[d, : len(o)] = pos_w[o]
        spec_arr[d, : len(o)] = species[o]
        mask_arr[d, : len(o)] = True
        gidx_arr[d, : len(o)] = o
        sil[d, : len(send_left[d])] = local_of[send_left[d]]
        sml[d, : len(send_left[d])] = True
        sir[d, : len(send_right[d])] = local_of[send_right[d]]
        smr[d, : len(send_right[d])] = True

    # ghost bookkeeping on the RECEIVER: device d's left ghosts are what
    # device d-1 sends right; right ghosts are what d+1 sends left.
    # lattice shift: crossing the periodic boundary picks up ±cell[axis]
    ghost_global: List[np.ndarray] = []
    ghost_shift_rows: List[np.ndarray] = []
    for d in range(D):
        left_src_dev = (d - 1) % D
        right_src_dev = (d + 1) % D
        gg = np.full(g_cap, -1, np.int64)
        gs = np.zeros((g_cap, 3))
        # left ghosts (from left neighbor's send_right)
        srcs = send_right[left_src_dev]
        gg[: len(srcs)] = srcs
        if left_src_dev > d or D == 1:  # wrapped around the periodic boundary
            gs[: len(srcs), axis] = -1.0
        gmask[d, : len(srcs)] = True
        # right ghosts
        srcs_r = send_left[right_src_dev]
        gg[gl_cap : gl_cap + len(srcs_r)] = srcs_r
        if right_src_dev < d or D == 1:
            gs[gl_cap : gl_cap + len(srcs_r), axis] = 1.0
        gmask[d, gl_cap : gl_cap + len(srcs_r)] = True
        ghost_global.append(gg)
        ghost_shift_rows.append(gs)
        gshift[d] = gs

    # edges per device via the host NL on the global system — fully
    # numpy-vectorized (the per-edge Python loop was O(E) and hopeless at
    # 100k+ atoms): map (src global idx, axis shift) -> ghost slot through a
    # flat lookup table keyed ``global_idx * 3 + (shift + 1)``.
    gdst, gsrc, gS = neighbor_list_numpy(pos_w, cutoff, cell, (True, True, True))
    gS_axis = np.rint(gS[:, axis]).astype(np.int64)
    if len(gS_axis) and np.abs(gS_axis).max() > 1:
        raise RuntimeError("cutoff exceeds the box length along the slab axis")
    e_caps = []
    edge_rows = []
    for d in range(D):
        own_sel = slab[gdst] == d
        ed, es, eS = gdst[own_sel], gsrc[own_sel], gS[own_sel]
        es_axis = gS_axis[own_sel]
        gg = ghost_global[d]
        gshift_ax = np.rint(ghost_shift_rows[d][:, axis]).astype(np.int64)
        lookup = -np.ones(n * 3, np.int64)
        valid = gg >= 0
        lookup[gg[valid] * 3 + gshift_ax[valid] + 1] = np.flatnonzero(valid)
        is_owned = (slab[es] == d) & (es_axis == 0)
        slot = lookup[es * 3 + es_axis + 1]
        if np.any(~is_owned & (slot < 0)):
            bad = np.flatnonzero(~is_owned & (slot < 0))[0]
            raise RuntimeError(
                f"edge source atom {es[bad]} (axis shift {es_axis[bad]}) not "
                f"in ghost map of device {d} — halo band too thin?"
            )
        src_ext = np.where(is_owned, local_of[es], n_cap + slot)
        # residual shift: full shift minus the axis part carried by the ghost
        resS = eS.copy()
        resS[~is_owned, axis] -= ghost_shift_rows[d][slot[~is_owned], axis]
        edge_rows.append((local_of[ed], src_ext, resS, None))
        e_caps.append(len(ed))

    e_cap = _round_up(max(e_caps), 64)
    esrc_arr = np.zeros((D, e_cap), np.int32)
    edst_arr = np.zeros((D, e_cap), np.int32)
    eshift_arr = np.zeros((D, e_cap, 3))
    emask_arr = np.zeros((D, e_cap), bool)
    for d, (ed, es, eS, keep) in enumerate(edge_rows):
        k = len(ed)
        edst_arr[d, :k] = ed
        esrc_arr[d, :k] = es
        eshift_arr[d, :k] = eS
        emask_arr[d, :k] = True

    return DomainDecomposition(
        n_devices=D,
        axis=axis,
        cell=cell,
        positions=pos_arr,
        species=spec_arr,
        atom_mask=mask_arr,
        owner_global_idx=gidx_arr,
        send_idx_left=sil,
        send_mask_left=sml,
        send_idx_right=sir,
        send_mask_right=smr,
        ghost_shift=gshift,
        ghost_mask=gmask,
        n_ghost_left_cap=gl_cap,
        edge_src=esrc_arr,
        edge_dst=edst_arr,
        edge_shift=eshift_arr,
        edge_mask=emask_arr,
    )
