"""Host-side neighbor list (numpy/scipy), used for dataset building and the
calculator, equivalent to the reference's matscipy/ASE path
(``sevenn/train/dataload.py:32-88``).

Returns a *full* directed edge list without self edges: for every pair
within ``cutoff`` both directions appear. Semantics match matscipy
``neighbour_list('ijDS')``: for an edge ``(dst=i, src=j, shift=S)`` the
displacement is ``D = pos[j] + S @ cell - pos[i]``.

The port's copy of ``sevennet_tpu/data/neighborlist.py``: periodic systems
of ``NATIVE_MIN_ATOMS`` atoms or more go to the native C++ cell list
(:mod:`sevennet_tpu_torch.native`), the rest, and the systems the cell list
does not take (a periodic height under the cutoff), to scipy's cKDTree.
``neighbor_list_numpy.served`` counts the lists each builder served, as the
kernels count their launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["neighbor_list_numpy", "neighbor_list_scipy", "neighbor_counts", "NATIVE_MIN_ATOMS"]

# the JAX package's threshold of the native list (sevennet_tpu/data/neighborlist.py:44)
NATIVE_MIN_ATOMS = 256


def neighbor_list_numpy(
    positions: np.ndarray,
    cutoff: float,
    cell: Optional[np.ndarray] = None,
    pbc=(False, False, False),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute a full neighbor list.

    Returns ``(edge_dst, edge_src, shifts)`` — receiver ``i``, sender ``j``,
    integer cell shifts ``S`` with ``r_ij = pos[j] + S @ cell - pos[i]``.
    The native list gives the edges receiver by receiver; scipy's are in
    its own order.
    """
    positions = np.asarray(positions, dtype=np.float64)
    n = len(positions)
    if isinstance(pbc, (bool, np.bool_)):
        pbc = (bool(pbc),) * 3
    pbc = np.asarray(pbc, dtype=bool)
    if cell is not None and pbc.any() and n >= NATIVE_MIN_ATOMS:
        from ..native import native_neighbor_list

        out = native_neighbor_list(positions, cutoff, cell, pbc)
        if out is not None:
            neighbor_list_numpy.served["native"] += 1
            return out
    neighbor_list_numpy.served["scipy"] += 1
    return neighbor_list_scipy(positions, cutoff, cell, pbc)


neighbor_list_numpy.served = {"native": 0, "scipy": 0}


def neighbor_list_scipy(
    positions: np.ndarray,
    cutoff: float,
    cell: Optional[np.ndarray] = None,
    pbc=(False, False, False),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`neighbor_list_numpy` by scipy's cKDTree alone, whatever the
    system's size."""
    positions = np.asarray(positions, dtype=np.float64)
    n = len(positions)
    if isinstance(pbc, (bool, np.bool_)):
        pbc = (bool(pbc),) * 3
    pbc = np.asarray(pbc, dtype=bool)
    if cell is None or not pbc.any():
        return _nopbc(positions, cutoff)

    pos_w, wrap, shift_table, center, images, in_shell = _images(positions, cutoff, cell, pbc)
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


def neighbor_counts(positions: np.ndarray, cutoff: float, cell: np.ndarray) -> np.ndarray:
    """Each atom's neighbour count within ``cutoff`` in a system periodic
    along all three axes: the row lengths of :func:`neighbor_list_scipy`'s
    list without forming it (a count-only kd-tree query over the same
    images)."""
    positions = np.asarray(positions, dtype=np.float64)
    pos_w, *_, images, _ = _images(positions, cutoff, cell, np.ones(3, dtype=bool))
    counts = cKDTree(images).query_ball_point(pos_w, cutoff, return_length=True)
    return np.asarray(counts, np.int64) - 1  # the atom itself


def _images(positions: np.ndarray, cutoff: float, cell, pbc: np.ndarray):
    """The wrapped positions, their integer wraps, the image shift table and
    its zero row, and the sender images within a cutoff-shell of the box
    with their flat indices (image * n + atom)."""
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
    return pos_w, wrap, shift_table, center, images[in_shell], in_shell


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
