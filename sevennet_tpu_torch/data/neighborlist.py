"""Host-side neighbor list (numpy/scipy), used for dataset building and the
calculator, equivalent to the reference's matscipy/ASE path
(``sevenn/train/dataload.py:32-88``).

Returns a *full* directed edge list without self edges: for every pair
within ``cutoff`` both directions appear. Semantics match matscipy
``neighbour_list('ijDS')``: for an edge ``(dst=i, src=j, shift=S)`` the
displacement is ``D = pos[j] + S @ cell - pos[i]``.

The port's copy of the numpy/scipy path of
``sevennet_tpu/data/neighborlist.py``; the native C++ cell list is not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["neighbor_list_numpy"]


def neighbor_list_numpy(
    positions: np.ndarray,
    cutoff: float,
    cell: Optional[np.ndarray] = None,
    pbc=(False, False, False),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute a full neighbor list.

    Returns ``(edge_dst, edge_src, shifts)`` — receiver ``i``, sender ``j``,
    integer cell shifts ``S`` with ``r_ij = pos[j] + S @ cell - pos[i]``.
    """
    positions = np.asarray(positions, dtype=np.float64)
    n = len(positions)
    if isinstance(pbc, (bool, np.bool_)):
        pbc = (bool(pbc),) * 3
    pbc = np.asarray(pbc, dtype=bool)
    if cell is None or not pbc.any():
        return _nopbc(positions, cutoff)

    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    if abs(np.linalg.det(cell)) < 1e-12:
        raise ValueError("periodic system with singular cell")

    # wrap positions along periodic axes; remember integer wraps
    inv = np.linalg.inv(cell)
    frac = positions @ inv
    wrap = np.where(pbc, np.floor(frac), 0.0)
    pos_w = (frac - wrap) @ cell

    # images needed per periodic axis: cutoff / perpendicular height
    recip = inv.T  # rows: reciprocal vectors (no 2pi)
    heights = 1.0 / np.linalg.norm(recip, axis=1)
    n_img = np.where(pbc, np.ceil(cutoff / heights).astype(int), 0)

    # all sender images in one array, one sparse distance query
    sa = np.arange(-n_img[0], n_img[0] + 1)
    sb = np.arange(-n_img[1], n_img[1] + 1)
    sc = np.arange(-n_img[2], n_img[2] + 1)
    shift_table = np.stack(
        np.meshgrid(sa, sb, sc, indexing="ij"), axis=-1
    ).reshape(-1, 3).astype(np.float64)
    center = int(np.flatnonzero((shift_table == 0).all(axis=1))[0])
    images = (
        pos_w[None, :, :] + (shift_table @ cell)[:, None, :]
    ).reshape(-1, 3)
    # keep only images within a cutoff-shell of the occupied region
    # (fractional box grown by cutoff/height per axis). Non-periodic axes
    # span the actual coordinate range: positions may lie outside [0,1)
    # there, and senders there must not be filtered out
    frac_img = images @ inv
    frac_w = pos_w @ inv
    lo = np.where(pbc, 0.0, frac_w.min(axis=0))
    hi = np.where(pbc, 1.0, frac_w.max(axis=0))
    eps = cutoff / heights + 1e-9
    in_shell = np.flatnonzero(
        ((frac_img >= lo - eps) & (frac_img <= hi + eps)).all(axis=1)
    )
    images = images[in_shell]

    tree_recv = cKDTree(pos_w)
    tree_img = cKDTree(images)
    hits = tree_recv.sparse_distance_matrix(
        tree_img, max_distance=cutoff, output_type="ndarray"
    )
    i = hits["i"].astype(np.int64)
    jj = in_shell[hits["j"].astype(np.int64)]
    k = jj // n
    j = jj % n
    keep = ~((k == center) & (i == j))
    dst, src, k = i[keep], j[keep], k[keep]
    if len(dst) == 0:
        return (
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros((0, 3), np.float64),
        )
    S = shift_table[k]
    # correct shifts back to the original (unwrapped) positions:
    # pos_w = pos - wrap@cell  =>  D = pos[j] + (S - wrap_j + wrap_i)@cell - pos[i]
    S = S - wrap[src] + wrap[dst]
    return dst, src, S


def _nopbc(positions: np.ndarray, cutoff: float):
    tree = cKDTree(positions)
    pairs = tree.query_pairs(cutoff, output_type="ndarray")  # (P, 2), i<j
    if len(pairs) == 0:
        return (
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros((0, 3), np.float64),
        )
    i, j = pairs[:, 0], pairs[:, 1]
    dst = np.concatenate([i, j])
    src = np.concatenate([j, i])
    shifts = np.zeros((len(dst), 3), dtype=np.float64)
    return dst, src, shifts
