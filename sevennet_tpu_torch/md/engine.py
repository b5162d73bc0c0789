"""MD engine (PyTorch port of ``sevennet_tpu/md/engine.py``): molecular
dynamics of one periodic system through the fused-conv model on the card,
NVE, NVT (Langevin, Nose-Hoover chain) and NPT (MTK, Berendsen).

Each step checks the skin where it evaluates the forces (one host read):
when an atom there has moved more than the state's limit since the last
slot build, the step is run again with its forces on slots rebuilt on the
device at those positions. The slots hold each atom's K nearest neighbours
of the list at cutoff + skin, so the limit is half the smaller of the skin
and ``d_drop - cutoff``, ``d_drop`` the nearest edge that the build cut
(``MDState.nl_limit``): no pair can then close from beyond ``d_drop`` to
within the cutoff before the next build, and every pair within the cutoff
holds a slot at every force evaluation. Then the engine evaluates the
model (:func:`~sevennet_tpu_torch.model.model.model_compute`) and
integrates. Capacities are fixed; a rebuild that overflows one (or breaks
the ring backward's window) raises a flag, and :meth:`MDEngine.run`
retries the chunk of steps from its snapshot with grown capacities. The
JAX package compiles each chunk into one ``lax.scan``; here the steps are
a Python loop (CUDA graphs wait on a trace: ROADMAP, tracing gap 2).
The JAX engine tests half the skin before each step and flags only cut
edges within the cutoff, so it misses a cut pair that closes in.

Large systems: when a layer's gathered edge tensor would pass
:func:`~sevennet_tpu_torch.ops.fused_conv.chunk_threshold` and the spec
asks for edge chunks (``_edge_chunk``), the engine sorts the atoms by cell
(an interleaved cell-id order that keeps every edge's mirror within a few
row chunks) and sizes the conv's ring backward (kernel B3 in vec mode, B4
bwd's slot entry in emb/sh mode at W = 1); where the ring cannot be sized
or is switched off (``SEVENNET_TPU_RING``: on by default in vec mode, off
in emb/sh mode, as in the JAX engine), the conv runs its chunked scatter
backward.

The port's engine always runs the dense fused conv (the JAX package's
``dense=True, fused=True``). The NPT integrators scale the cell, the
positions and the build's reference positions every step: the rebuild, the
slot truncation and the graph read the state's cell, and the skin test's
limit narrows by the cell's scale since the build (``MDState.nl_cell``,
:func:`~.neighbor.shrink_limit`: a pair at distance d closes by (1 - s) d
on top of the tested motion). A build at which a grid cell is lower than
its list's reach (a box that shrank past the grid's slack) raises
``grid_small``, and :meth:`MDEngine.run` re-derives the grid for that cell
and retries the chunk; capacity growth stays for capacity overflow.

D3 dispersion (``d3=``) adds :func:`~sevennet_tpu_torch.d3.d3_compute` over
a second dense slot grid at the D3 cutoff (bounded by the box), rebuilt on
the device with the model's and grown with it. Its grid usually has one
cell (the cutoff is clamped to the box height less the skin); its list
reaches the D3 cutoff plus the smaller of the skin and the grid's cover at
the build, and the skin test holds to that margin too, narrowed by the
shrink with the D3 cutoff.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..data.graph import GraphBatch, densify_edges
from ..data.neighborlist import neighbor_counts, neighbor_list_numpy
from ..device import resolve_device
from ..model.build import ModelSpec
from ..model.model import _vec_mode, model_compute, params_to
from ..ops.fused_conv import chunk_threshold, mirror_map, mirror_map_numpy
from .integrators import (berendsen_npt_step, langevin_step, mtk_npt_step, nose_hoover_step,
                          nve_step)
from .neighbor import (CellListSpec, build_cell_list_spec, cell_coords, grid_cells,
                       rebuild_neighbors, shrink_limit, skin_limit)
from .state import ATOMIC_MASSES, MDState, init_md_state, thermal_velocities

__all__ = ["MDEngine", "INTEGRATORS"]

# the fields of a state that a slot rebuild sets
_REBUILT = ("positions", "nl_positions", "edge_src", "edge_dst", "edge_shift", "edge_mask",
            "edge_mir", "nl_limit", "nl_cell", "nl_overflow", "ring_overflow", "grid_small",
            "d3_edge_src", "d3_edge_dst", "d3_edge_shift", "d3_edge_mask")

_NPT = ("npt", "npt_mtk", "npt_nose_hoover", "npt_berendsen")
INTEGRATORS = ("nve", "langevin", "nose_hoover", "nvt") + _NPT


class _Stale(Exception):
    """Raised at a force evaluation where an atom has moved past the
    state's limit since the last slot build."""


def _interleave(c: np.ndarray, n: int) -> np.ndarray:
    """Cell coordinate -> interleaved rank (0, n-1, 1, n-2, ...): circularly
    adjacent cells differ by at most 2 in rank."""
    return np.where(c * 2 < n, 2 * c, 2 * (n - 1 - c) + 1)


class MDEngine:
    def __init__(
        self,
        spec: ModelSpec,
        params,
        cell: np.ndarray,
        skin: float = 0.6,
        cl_spec: Optional[CellListSpec] = None,
        d3: Optional[dict] = None,
        device: Optional[str] = None,
        plain: bool = False,
    ):
        """``params``: the port's parameter tree. Runs on ``cuda`` unless
        ``device="cpu"``; ``plain=True`` runs the conv's plain PyTorch
        version (the reference path). The atoms are sorted by cell exactly
        when the ring backward engages (100k-atom systems).

        ``d3``: adds Grimme D3 dispersion (the engine-side analogue of the
        reference's LAMMPS ``pair d3``), a dict like ``{"functional": "pbe",
        "damping": "damp_bj", "cutoff": 12.0}`` (``damping_type`` is taken
        for ``damping``). The pair cutoff defaults to
        :func:`~sevennet_tpu_torch.d3.bounded_cutoff` and is clamped to the
        smallest box height less the skin; the CN cutoff to the pair
        cutoff."""
        self.device = resolve_device(device)
        self.spec = spec
        self.params = params_to(params, self.device)
        self.cell = np.asarray(cell, dtype=np.float64)
        self.skin = skin
        self.cl_spec = cl_spec
        self.plain = plain
        self.k_model: Optional[int] = None  # conv slot width after truncation
        self.row_chunk = 0  # ring chunk (rows); 0 = ring off
        self._ring_nb = 0  # number of ring chunks
        self._ring_w = 0  # mirror window in chunks
        self._ring_window = 0  # host-measured mirror window (rows)
        self._ring_margin = 1.15  # slack over the measured window
        self.n_rebuilds = 0  # device rebuilds so far
        self.n_growths = 0  # capacity growths so far
        self.n_regrids = 0  # grids re-derived for a shrunk box so far
        self.d3_params = None
        self.d3_cl_spec: Optional[CellListSpec] = None
        # a build's cell -> the square of half the D3 list's margin there
        self._skin_cell, self._skin_sq = None, None
        if d3:
            from ..d3 import D3Params, bounded_cutoff

            p = D3Params.from_functional(d3.get("functional", "pbe"),
                                         d3.get("damping", d3.get("damping_type", "damp_bj")))
            cut = d3.get("cutoff") or bounded_cutoff(p, self.cell, True)
            heights = 1.0 / np.linalg.norm(np.linalg.inv(self.cell).T, axis=1)
            # the cell list resolves neighbours within +-1 image only
            cut = min(cut, float(heights.min()) - self.skin - 1e-6)
            self.d3_params = dataclasses.replace(p, cutoff=cut, cn_cutoff=min(p.cn_cutoff, cut))

    # -- setup ---------------------------------------------------------------
    def make_state(self, positions, atomic_numbers, temperature: Optional[float] = None,
                   seed: int = 0, compute_forces: bool = True) -> MDState:
        """The initial state: capacities sized from one host neighbour list
        at cutoff + skin (cell list, conv slot width K from the counts within
        cutoff + 0.1 skin, the ring window), atoms wrapped into the box and,
        when the ring engages, sorted by cell; the initial slots and mirror
        map built on the host from the same list. With D3, the D3 slot width
        comes from a count-only host pass at the D3 cutoff + skin and the D3
        grid is built on the device. Thermal velocities are drawn in the
        input order, then permuted with the atoms: a structure and seed give
        the same physics whether or not the engine sorts."""
        n = len(positions)
        Z = np.asarray(atomic_numbers)
        species = self.spec.z_to_type[Z]
        if (species < 0).any():
            raise ValueError("unknown species for this model")
        pos_w = self._wrap(np.asarray(positions, np.float64))
        dst, src, sh = neighbor_list_numpy(pos_w, self.spec.cutoff + self.skin, self.cell,
                                           (True,) * 3)
        d2 = self._dist2(pos_w, dst, src, sh)
        if self.cl_spec is None:
            # adaptive neighbour capacity: the counts with a margin (the
            # reference's x1.2 edge bound, pair_e3gnn.cpp:283-288); the
            # overflow flag and growth cover later changes
            max_nbrs = int(np.bincount(dst, minlength=n).max()) if len(dst) else 8
            self.cl_spec = build_cell_list_spec(self.cell, n, self.spec.cutoff, self.skin,
                                                neighbor_capacity=int(np.ceil(max_nbrs * 1.2)) + 2)
        # distance-sorted slot truncation: the list reaches cutoff + skin,
        # the conv needs the neighbours within the cutoff. A dropped edge
        # inside the cutoff raises the overflow flag; the nearest one
        # dropped beyond it narrows the skin test (MDState.nl_limit)
        close = dst[d2 < (self.spec.cutoff + 0.1 * self.skin) ** 2]
        mx_c = int(np.bincount(close, minlength=n).max()) if len(close) else 8
        k_margin = float(os.environ.get("SEVENNET_TPU_KMARGIN", 1.05))
        k_model = int(np.ceil(mx_c * k_margin)) + 2
        if k_model > self.cl_spec.neighbor_capacity:
            self.cl_spec = dataclasses.replace(self.cl_spec, neighbor_capacity=k_model)
        self.k_model = min(k_model, self.cl_spec.neighbor_capacity)
        self._ring_window = self._host_window(pos_w, dst, src)
        n_cap = self._size_ring(n)
        if self.d3_params is not None and self.d3_cl_spec is None:
            # the D3 slot width from a count-only pass (the list itself
            # holds about 3.7e7 pairs at 3,000 atoms and 30 A), with the
            # JAX package's margin
            counts = neighbor_counts(pos_w, self.d3_params.cutoff + self.skin, self.cell)
            self.d3_cl_spec = build_cell_list_spec(
                self.cell, n, self.d3_params.cutoff, self.skin,
                neighbor_capacity=int(np.ceil((int(counts.max()) if counts.sum() else 8) * 1.15))
                + 2)

        perm = self._host_sort_perm(pos_w) if self._ring_nb else np.arange(n)
        rank = np.empty(n, np.int64)
        rank[perm] = np.arange(n)
        host_edges = self._host_initial_edges(pos_w[perm], n_cap,
                                              edges=(rank[dst], rank[src], sh, d2))
        velocities = None
        if temperature is not None:
            velocities = thermal_velocities(ATOMIC_MASSES[Z], temperature, seed)
        if host_edges is None:
            # a capacity or ring-window estimate failed: the device rebuild
            # (which sorts when the ring is on) and its growth loop take over
            perm = np.arange(n)
        else:
            pos_w, species, Z = pos_w[perm], species[perm], Z[perm]
            if velocities is not None:
                velocities = velocities[perm]
        state = init_md_state(pos_w, species, self.cell, atomic_numbers=Z,
                              velocities=velocities, seed=seed, n_atoms_cap=n_cap,
                              n_edges_cap=n_cap * self.k_model, device=self.device,
                              d3_edges_cap=self._d3_slots(n_cap))
        if host_edges is not None:
            idx = np.concatenate([perm, np.arange(n, n_cap)])
            state = state.replace(
                nl_limit=host_edges["limit"].to(self.device, torch.float32),
                edge_src=self._put(host_edges["src"], torch.int64),
                edge_dst=torch.arange(n_cap * self.k_model, device=self.device) // self.k_model,
                edge_shift=self._put(host_edges["shift"], torch.float32),
                edge_mask=self._put(host_edges["mask"], torch.bool),
                edge_mir=self._put(host_edges["mir"], torch.int64),
                atom_index=self._put(idx, torch.int64),
            )
            if self.d3_params is not None:  # the initial D3 grid, built on the device
                state = state.replace(**self._rebuild_d3(state))
        else:
            state = self._rebuild(state)
        for _ in range(3):
            ofl_nl, ofl_ring, small = self._flags(state)
            if not (ofl_nl or ofl_ring or small):
                break
            state = (self._regrid(state, state.cell) if small
                     else self._grow_capacities(state, ring_only=ofl_ring and not ofl_nl))
        if not compute_forces:
            return state
        forces, energy, stress = self._forces(state, compute_stress=True)
        return state.replace(forces=forces, potential_energy=energy, stress=stress)

    # -- internals -----------------------------------------------------------
    def _put(self, a, dtype):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _d3_slots(self, n_cap: int) -> int:
        """Slots of the D3 grid for ``n_cap`` rows (0 without D3)."""
        return n_cap * self.d3_cl_spec.neighbor_capacity if self.d3_params is not None else 0

    @staticmethod
    def _heights(cell: torch.Tensor) -> torch.Tensor:
        """Distances between opposite faces of the cell (3,)."""
        return 1.0 / torch.linalg.vector_norm(torch.linalg.inv(cell).T, dim=1)

    def _d3_cover(self, cell: torch.Tensor) -> torch.Tensor:
        """How far the D3 grid reaches past the D3 cutoff in ``cell``: a
        grid cell's smallest height less the cutoff. The stencil of +-1 grid
        cells finds every pair within a grid cell's height, so the list is
        complete to the cutoff and this much further."""
        n_cells = torch.tensor(self.d3_cl_spec.n_cells, device=cell.device)
        return (self._heights(cell) / n_cells).min() - self.d3_params.cutoff

    def _rebuild_d3(self, state: MDState) -> dict:
        """The D3 slot grid of ``state``'s positions and cell on the device,
        ``nl_overflow`` or'ed with the grid's capacity overflow and
        ``grid_small`` with a box whose grid cells are lower than the D3
        cutoff (a pair within the cutoff could be missed)."""
        src, dst, shift, mask, ofl, _ = rebuild_neighbors(
            self.d3_cl_spec, state.positions, state.cell, state.atom_mask)
        too_small = self._d3_cover(state.cell) < 0
        return dict(d3_edge_src=src, d3_edge_dst=dst, d3_edge_shift=shift, d3_edge_mask=mask,
                    nl_overflow=state.nl_overflow | ofl, grid_small=state.grid_small | too_small)

    def _skin_half_sq(self, state: MDState):
        """The rebuild test's limit on the squared displacement: the state's
        ``nl_limit``, with D3 also no more than the square of half the D3
        list's margin (the smaller of the skin and the D3 grid's cover at the
        build, ``_d3_cover``); where the cell has shrunk since the build (NPT,
        scale s = (V / V_build)^(1/3)), each narrowed by
        :func:`~.neighbor.shrink_limit` with its cutoff. On the device."""
        limit, d3_sq = state.nl_limit, None
        if self.d3_params is not None:
            if state.nl_cell is not self._skin_cell:
                cover = torch.clamp(self._d3_cover(state.nl_cell), min=0.0, max=self.skin)
                self._skin_cell, self._skin_sq = state.nl_cell, (cover / 2.0) ** 2
            d3_sq = self._skin_sq
        if state.cell is not state.nl_cell:
            scale = (state.volume() / torch.abs(torch.linalg.det(state.nl_cell))) ** (1.0 / 3.0)
            limit = shrink_limit(limit, scale, self.spec.cutoff)
            if d3_sq is not None:
                d3_sq = shrink_limit(d3_sq, scale, self.d3_params.cutoff)
        return limit if d3_sq is None else torch.minimum(limit, d3_sq)

    def _moved(self, state: MDState) -> bool:
        """Whether an atom has moved past the limit since the last slot
        build (one host read)."""
        disp = state.positions - state.nl_positions
        return bool((torch.sum(disp * disp, dim=-1) * state.atom_mask
                     > self._skin_half_sq(state)).any())

    # the host helpers take the cell (default: the initial one); an NPT
    # state's cell is the state's own
    def _cell(self, cell) -> np.ndarray:
        return self.cell if cell is None else np.asarray(cell, np.float64)

    def _wrap(self, pos: np.ndarray, cell=None) -> np.ndarray:
        cell = self._cell(cell)
        return ((pos @ np.linalg.inv(cell)) % 1.0) @ cell

    def _dist2(self, pos, dst, src, sh, cell=None) -> np.ndarray:
        vec = pos[src] + sh @ self._cell(cell) - pos[dst]
        return np.sum(vec * vec, axis=1)

    def _cell_ids(self, pos: np.ndarray, cell=None) -> np.ndarray:
        """Interleaved cell id of each atom (the order of :meth:`_sort_state`)."""
        nx, ny, nz = self.cl_spec.n_cells
        cell = self._cell(cell)
        frac = (pos @ np.linalg.inv(cell)) % 1.0
        grid = np.array([nx, ny, nz])
        c = np.clip((frac * grid).astype(np.int64), 0, grid - 1)
        return (c[:, 0] * ny + _interleave(c[:, 1], ny)) * nz + _interleave(c[:, 2], nz)

    def _host_window(self, pos, dst, src, cell=None) -> int:
        """Largest circular row distance between neighbours under the
        interleaved cell-id sort: the ring backward's window, measured on
        the system (about 1.3 x-layers of cells for a homogeneous box)."""
        n = len(pos)
        if len(dst) == 0 or n == 0:
            return 0
        rank = np.empty(n, np.int64)
        rank[np.argsort(self._cell_ids(pos, cell), kind="stable")] = np.arange(n)
        d = np.abs(rank[dst] - rank[src])
        return int(np.minimum(d, n - d).max())

    def _host_sort_perm(self, pos_w: np.ndarray, cell=None) -> np.ndarray:
        """Numpy twin of :meth:`_sort_state`'s order."""
        return np.argsort(self._cell_ids(pos_w, cell), kind="stable")

    def _host_initial_edges(self, pos_w: np.ndarray, n_cap: int, cell=None, edges=None):
        """The dense ``(N, K)`` slots and mirror map of ``cell``, built on the
        host, and the skin test's ``limit``: what the device rebuild gives,
        from ``edges = (dst, src, shift, d2)`` at cutoff + skin (computed
        here when None). Returns None when K drops an edge inside the cutoff
        or the ring window fails."""
        n, K, cell = len(pos_w), self.k_model, self._cell(cell)
        if edges is None:
            dst, src, sh = neighbor_list_numpy(pos_w, self.spec.cutoff + self.skin, cell,
                                               (True,) * 3)
            edges = (dst, src, sh, self._dist2(pos_w, dst, src, sh, cell))
        dst, src, sh, d2 = edges
        order = np.lexsort((d2, dst))
        dst, src, sh, d2 = dst[order], src[order], sh[order], d2[order]
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=n), out=starts[1:])
        keep = np.arange(len(dst)) - starts[dst] < K
        if np.any(~keep & (d2 < self.spec.cutoff ** 2)):
            return None
        src_d, _, shift_d, mask_d = densify_edges(
            src[keep].astype(np.int32), dst[keep].astype(np.int32),
            sh[keep].astype(np.float32), np.ones(int(keep.sum()), bool), n_cap, K)
        src_nk, mask_nk = src_d.reshape(n_cap, K), mask_d.reshape(n_cap, K)
        if self._ring_nb:
            d = np.mod(src_nk // self.row_chunk - np.arange(n_cap)[:, None] // self.row_chunk,
                       self._ring_nb)
            W = self._ring_w
            if np.any(mask_nk & (d > W) & (d < self._ring_nb - W)):
                return None
        mir = mirror_map_numpy(src_nk, shift_d.reshape(n_cap, K, 3), mask_nk).reshape(-1)
        d2_drop = torch.tensor(d2[~keep].min() if not keep.all() else np.inf)
        return dict(src=src_d, shift=shift_d, mask=mask_d, mir=mir,
                    limit=skin_limit(d2_drop, self.spec.cutoff, self.skin))

    def _size_ring(self, n_cap: int) -> int:
        """Sizes the ring backward from the host-measured mirror window, by
        the JAX engine's rule (``sevennet_tpu/md/engine.py:530-602``).
        ``SEVENNET_TPU_RING`` (0 or 1) says whether the ring may engage; by
        default it does in vec mode and not in emb/sh mode. Vec mode: row
        chunk RC from the spec's edge chunk, window W = ceil(window / RC)
        chunks. Emb/sh mode: RC = max(edge_chunk // K, window) rows and W =
        1. Either way nb >= 2W + 1 chunks of RC rows. Returns the atom
        capacity ``nb * RC`` (``n_cap`` when the ring stays off: chunking
        not engaged, the ring switched off, or too few chunks for the
        window; a layer that chunks then runs the chunked scatter backward).
        The JAX package rounds RC to its kernel's atom block; here RC is any
        row count."""
        self.row_chunk = self._ring_nb = self._ring_w = 0
        vec = _vec_mode(self.spec)
        ring_env = os.environ.get("SEVENNET_TPU_RING")
        use_ring = bool(int(ring_env)) if ring_env is not None else vec
        if not self.spec.edge_chunk or not use_ring:
            return self._update_spec(n_cap)
        dim_x_max = max(layer.conv.irreps_x.dim for layer in self.spec.layers)
        if n_cap * self.k_model * dim_x_max * 4 <= chunk_threshold():
            return self._update_spec(n_cap)  # the unchunked backward runs below
        if not self._ring_window:
            self._ring_window = int(np.ceil(1.5 * n_cap / max(self.cl_spec.n_cells[0], 1)))
        window = int(np.ceil(self._ring_margin * self._ring_window))
        rc0 = max(self.spec.edge_chunk // self.k_model, 1 if vec else window, 1)
        # small systems: grow RC (shrink nb) until the 2W+1 window fits
        for nb in range(n_cap // rc0, 2, -1):
            RC = -(-n_cap // nb)
            W = max(1, -(-window // RC)) if vec else 1
            if nb >= 2 * W + 1:
                self.row_chunk, self._ring_nb, self._ring_w = RC, nb, W
                return self._update_spec(nb * RC)
        return self._update_spec(n_cap)  # the window spans the box: scatter path

    def _update_spec(self, n_cap: int) -> int:
        """The spec the model runs: slot width K, ring window, edge chunk
        (``row_chunk * K`` when the ring is on)."""
        self.spec = dataclasses.replace(
            self.spec, edge_dense_k=self.k_model,
            conv_ring=self._ring_w if self._ring_nb else 0,
            edge_chunk=self.row_chunk * self.k_model if self._ring_nb else self.spec.edge_chunk)
        return n_cap

    def _rebuild(self, state: MDState, sort: bool = True) -> MDState:
        """Device rebuild: (with the ring and ``sort``, sort,) cell list,
        distance truncation to K and the skin test's limit, mirror map,
        ring-window check, overflow flags."""
        self.n_rebuilds += 1
        if sort and self._ring_nb:
            state = self._sort_state(state)
        n, K = state.n_atoms_cap, self.k_model
        src, dst, shift, mask, overflow, pos_w = rebuild_neighbors(
            self.cl_spec, state.positions, state.cell, state.atom_mask)
        limit = skin_limit(torch.full((), np.inf, device=self.device), self.spec.cutoff,
                           self.skin)
        if K < self.cl_spec.neighbor_capacity:
            src, dst, shift, mask, ofl_trunc, limit = self._truncate_sorted(
                src, shift, mask, pos_w, state.cell, n)
            overflow = overflow | ofl_trunc
        mir = mirror_map(src.view(n, K), shift.view(n, K, 3), mask.view(n, K))
        ring_bad = torch.zeros((), dtype=torch.bool, device=self.device)
        if self._ring_nb:
            # ring contract: every mirror within W chunks of its row,
            # circularly; a violation grows the row-chunk margin only
            RC, nb, W = self.row_chunk, self._ring_nb, self._ring_w
            rows = torch.arange(n, device=self.device)[:, None] // RC
            d = torch.remainder((mir // K) // RC - rows, nb)
            ring_bad = (mask.view(n, K) & (d > W) & (d < nb - W)).any()
        too_small = (self._heights(state.cell) / torch.tensor(self.cl_spec.n_cells,
                                                             device=self.device)
                     < self.cl_spec.cutoff).any()
        state = state.replace(
            positions=pos_w, nl_positions=pos_w, edge_src=src, edge_dst=dst,
            edge_shift=shift, edge_mask=mask, edge_mir=mir.reshape(-1), nl_limit=limit,
            nl_cell=state.cell, nl_overflow=state.nl_overflow | overflow,
            ring_overflow=state.ring_overflow | ring_bad,
            grid_small=state.grid_small | too_small)
        if self.d3_params is not None:
            state = state.replace(**self._rebuild_d3(state))
        return state

    def _sort_state(self, state: MDState) -> MDState:
        """Atoms permuted into interleaved cell-id order, padded rows last.
        y and z are interleaved (0, n-1, 1, n-2, ...) so that neighbours
        across the periodic boundary stay row-local; x stays raster and the
        ring backward wraps it circularly."""
        nx, ny, nz = self.cl_spec.n_cells
        _, c = cell_coords(self.cl_spec, state.positions, state.cell)
        iy = torch.where(c[:, 1] * 2 < ny, 2 * c[:, 1], 2 * (ny - 1 - c[:, 1]) + 1)
        iz = torch.where(c[:, 2] * 2 < nz, 2 * c[:, 2], 2 * (nz - 1 - c[:, 2]) + 1)
        cid = torch.where(state.atom_mask, (c[:, 0] * ny + iy) * nz + iz, nx * ny * nz)
        p = torch.argsort(cid, stable=True)
        return state.replace(
            positions=state.positions[p], velocities=state.velocities[p],
            forces=state.forces[p], species=state.species[p], masses=state.masses[p],
            atom_mask=state.atom_mask[p], nl_positions=state.nl_positions[p],
            atom_index=state.atom_index[p],
            z_numbers=None if state.z_numbers is None else state.z_numbers[p])

    def _truncate_sorted(self, src, shift, mask, pos_w, cell, n):
        """Each atom's slots sorted by distance, the first ``k_model`` kept;
        a dropped edge within the model cutoff flags overflow, and the
        nearest dropped edge sets the skin test's limit (``skin_limit``)."""
        K, Kp = self.cl_spec.neighbor_capacity, self.k_model
        src, shift, mask = src.view(n, K), shift.view(n, K, 3), mask.view(n, K)
        vec = pos_w[src] + shift @ cell - pos_w[:, None, :]
        key = torch.where(mask, torch.sum(vec * vec, dim=-1), float("inf"))
        order = torch.argsort(key, dim=1, stable=True)
        src_s, mask_s = torch.gather(src, 1, order), torch.gather(mask, 1, order)
        shift_s = torch.gather(shift, 1, order[..., None].expand(n, K, 3))
        d2_s = torch.gather(key, 1, order)  # inf on the masked slots
        ofl = (mask_s[:, Kp:] & (d2_s[:, Kp:] < self.spec.cutoff ** 2)).any()
        dst = torch.repeat_interleave(torch.arange(n, device=src.device), Kp)
        return (src_s[:, :Kp].reshape(-1), dst, shift_s[:, :Kp].reshape(-1, 3),
                mask_s[:, :Kp].reshape(-1), ofl,
                skin_limit(d2_s[:, Kp:].min(), self.spec.cutoff, self.skin))

    def _graph(self, state: MDState) -> GraphBatch:
        dev = self.device
        return GraphBatch(
            positions=state.positions, species=state.species, atom_mask=state.atom_mask,
            batch=torch.zeros(state.n_atoms_cap, dtype=torch.int64, device=dev),
            edge_src=state.edge_src, edge_dst=state.edge_dst, edge_shift=state.edge_shift,
            edge_mask=state.edge_mask, cell=state.cell[None],
            volume=torch.abs(torch.linalg.det(state.cell))[None],
            num_atoms=state.atom_mask.sum()[None],
            graph_mask=torch.ones(1, dtype=torch.bool, device=dev),
            edge_mir=state.edge_mir, dense_k=self.k_model)

    def _forces(self, state: MDState, compute_stress: bool = False):
        out = model_compute(self.spec, self.params, self._graph(state),
                            compute_stress=compute_stress, device=self.device, plain=self.plain)
        stress = (out["stress"][0] if compute_stress
                  else torch.zeros(6, dtype=torch.float32, device=self.device))
        forces, energy = out["forces"], out["energy"][0]
        if self.d3_params is not None:
            e3, f3, v3 = self._d3_term(state)
            energy, forces = energy + e3, forces + f3
            if compute_stress:
                stress = stress + v3 / state.volume()
        return forces, energy, stress

    def _d3_term(self, state: MDState):
        """D3's energy (eV), forces (eV/A) and 6-virial (eV) over the
        state's D3 grid (:func:`~sevennet_tpu_torch.d3.d3_compute`)."""
        from ..d3 import d3_compute

        ev = (state.positions[state.d3_edge_src] - state.positions[state.d3_edge_dst]
              + state.d3_edge_shift @ state.cell)
        return d3_compute(self.d3_params, state.z_numbers, state.d3_edge_dst, state.d3_edge_src,
                          ev, state.d3_edge_mask)

    def _step_fn(self, integrator: str, dt: float, **kw):
        """``(step, forces_fn)``: the integrator step ``(state, forces_fn) ->
        state`` of ``integrator`` (the JAX engine's names and keyword
        defaults) and the engine's force evaluation for it; the NPT
        integrators (and ``compute_stress=True``) evaluate the stress with
        the forces."""
        need_stress = kw.pop("compute_stress", False) or integrator in _NPT

        def forces_fn(state):
            return self._forces(state, compute_stress=need_stress)

        if integrator == "nve":
            return (lambda s, f: nve_step(s, f, dt)), forces_fn
        if integrator not in INTEGRATORS:
            raise ValueError(f"unknown integrator {integrator!r}; one of {INTEGRATORS}")
        if "temperature" not in kw:
            raise ValueError(f"integrator {integrator!r} needs temperature=")
        T = kw["temperature"]
        if integrator == "langevin":
            return (lambda s, f: langevin_step(s, f, dt, T, kw.get("friction", 0.01))), forces_fn
        if integrator in ("nose_hoover", "nvt"):
            return (lambda s, f: nose_hoover_step(s, f, dt, T, kw.get("tau", 50.0))), forces_fn
        npt = dict(pressure=kw.get("pressure", 0.0), tau_t=kw.get("tau_t", 100.0),
                   tau_p=kw.get("tau_p", 1000.0))
        if integrator == "npt_berendsen":
            return (lambda s, f: berendsen_npt_step(
                s, f, dt, T, compressibility=kw.get("compressibility", 4.6e-5), **npt)), forces_fn
        return (lambda s, f: mtk_npt_step(s, f, dt, T, **npt)), forces_fn

    def _run_chunk(self, state: MDState, length: int, step, forces_fn):
        """``length`` steps of ``step``. Each evaluates the forces on the
        current slots unless an atom has moved past the limit there; then
        the step runs again from its start (with the ring, the rows sorted
        first), its forces on slots rebuilt at the positions where it
        evaluates them: every step's positions are a function of the state
        before it, so the rebuild sees the positions the forces see. Stops
        early once a rebuild overflows or finds its grid too fine (the caller
        retries from its snapshot)."""

        built = []

        def checked(s):
            if self._moved(s):
                raise _Stale
            return forces_fn(s)

        def rebuilt(s):
            built.append(self._rebuild(s, sort=False))
            return forces_fn(built[-1])

        pe, ke = [], []
        for _ in range(length):
            try:
                state = step(state, checked)
            except _Stale:
                if self._ring_nb:
                    state = self._sort_state(state)
                built.clear()
                state = step(state, rebuilt)
                state = state.replace(**{f: getattr(built[0], f) for f in _REBUILT})
                if bool(state.nl_overflow | state.ring_overflow | state.grid_small):
                    break
            pe.append(state.potential_energy)
            ke.append(state.kinetic_energy())
        return state, pe, ke

    # -- public --------------------------------------------------------------
    def run(self, state: MDState, n_steps: int, dt: float = 1.0, integrator: str = "nve",
            chunk: int = 10, traj_path: Optional[str] = None, traj_every: int = 0, **kw):
        """``n_steps`` steps of ``integrator`` in chunks of ``chunk``; returns
        ``(state, (pe, ke))``, the potential and kinetic energy of every
        step. Integrators and their keywords (``sevennet_tpu/md/engine.py``):
        ``nve``; ``langevin`` (``temperature``, ``friction`` 0.01 1/fs);
        ``nose_hoover``/``nvt`` (``temperature``, ``tau`` 50 fs);
        ``npt``/``npt_mtk``/``npt_nose_hoover`` (``temperature``,
        ``pressure`` 0 eV/A^3, ``tau_t`` 100 fs, ``tau_p`` 1000 fs);
        ``npt_berendsen`` (the same and ``compressibility`` 4.6e-5 1/bar).
        A chunk whose rebuild overflows is retried from its snapshot with
        grown capacities, up to 3 times (Langevin redraws the same noise);
        one whose rebuild found a grid cell lower than its list's reach (an
        NPT box that shrank) is retried on a grid re-derived for that cell,
        which uses none of the 3.
        ``traj_path`` appends an extxyz frame every ``traj_every`` steps
        (rounded to chunk ends; default: every chunk), atoms in the input
        order."""
        step, forces_fn = self._step_fn(integrator, dt, **kw)
        traj_pe, traj_ke = [], []
        if traj_path and traj_every <= 0:
            traj_every = chunk
        steps_done, next_dump = 0, traj_every
        if traj_path:
            self._dump_frame(state, traj_path, append=False)
        for length in [chunk] * (n_steps // chunk) + ([n_steps % chunk] if n_steps % chunk else []):
            growths = 0
            while True:
                prev = state
                state, pe, ke = self._run_chunk(state, length, step, forces_fn)
                ofl_nl, ofl_ring, small = self._flags(state)
                if not (ofl_nl or ofl_ring or small):
                    break
                if small:  # the grid follows the cell; finitely often: it only coarsens
                    state = self._regrid(prev, state.cell)
                    continue
                if growths == 3:
                    raise RuntimeError(
                        "neighbor-list capacity overflow persisted after 3 automatic growth "
                        "attempts: the system is likely collapsing (check the potential and "
                        "the timestep)")
                growths += 1
                state = self._grow_capacities(prev, ring_only=ofl_ring and not ofl_nl)
            traj_pe += pe
            traj_ke += ke
            steps_done += length
            if traj_path and steps_done >= next_dump:
                self._dump_frame(state, traj_path, append=True)
                next_dump += traj_every
        return state, (torch.stack(traj_pe), torch.stack(traj_ke))

    @staticmethod
    def _flags(state: MDState):
        """``(nl_overflow, ring_overflow, grid_small)`` (one host read)."""
        return [bool(f) for f in torch.stack(
            [state.nl_overflow, state.ring_overflow, state.grid_small]).tolist()]

    def _regrid(self, state: MDState, cell: torch.Tensor) -> MDState:
        """The grids re-derived for ``cell``, a cell at which a build found a
        grid cell lower than its list's reach (an NPT box that shrank past
        the grid's slack), by :func:`~.neighbor.build_cell_list_spec`'s rule:
        the model's at cutoff + skin, the D3 grid's where its cells fell below
        the D3 cutoff. The capacities that grew are kept, a grid's cell
        capacity scaled to its larger cells, and with the ring the measured
        window to the thicker x-layers of cells; then the state re-created
        from the snapshot ``state`` (:meth:`_recreate`). Raises RuntimeError
        where no grid can follow: a lattice height below cutoff + skin, or
        below the D3 cutoff with one D3 grid cell."""
        c = cell.detach().cpu().double().numpy()
        heights = 1.0 / np.linalg.norm(np.linalg.inv(c).T, axis=1)
        if (heights < self.cl_spec.cutoff).any():
            raise RuntimeError(
                f"the box shrank below cutoff + skin {self.cl_spec.cutoff:.4f} A (lattice heights "
                f"{np.round(heights, 4).tolist()} A; one periodic image a side)")

        def regridded(spec: CellListSpec, n_cells) -> CellListSpec:
            ratio = np.prod(spec.n_cells) / np.prod(n_cells)
            return dataclasses.replace(spec, n_cells=n_cells, cell_capacity=int(
                np.ceil((spec.cell_capacity - 2) * ratio)) + 2)

        changed = False
        n_cells = grid_cells(c, self.cl_spec.cutoff)
        if n_cells != self.cl_spec.n_cells:
            if self._ring_window:
                self._ring_window = int(np.ceil(self._ring_window * self.cl_spec.n_cells[0]
                                                / n_cells[0]))
            self.cl_spec, changed = regridded(self.cl_spec, n_cells), True
        if self.d3_params is not None and (
                heights / np.array(self.d3_cl_spec.n_cells)).min() < self.d3_params.cutoff:
            n_cells = grid_cells(c, self.d3_cl_spec.cutoff)
            if (heights / np.array(n_cells)).min() < self.d3_params.cutoff:
                raise RuntimeError(
                    f"the box shrank below the D3 cutoff {self.d3_params.cutoff:.4f} A "
                    "(one periodic image a side); give MDEngine a smaller d3 'cutoff'")
            self.d3_cl_spec, changed = regridded(self.d3_cl_spec, n_cells), True
        if not changed:
            raise RuntimeError(f"a build found a grid cell lower than its reach, but the grids "
                               f"{self.cl_spec.n_cells} fit the cell {c.tolist()}")
        self.n_regrids += 1
        return self._recreate(state)

    def _grow_capacities(self, state: MDState, factor: float = 1.35,
                         ring_only: bool = False) -> MDState:
        """Capacities (cell occupancy, neighbour slots, conv slot width, the
        D3 grid's) ``factor`` larger, or with ``ring_only`` just the ring's window
        margin; the state re-created from the snapshot ``state``
        (:meth:`_recreate`)."""
        self.n_growths += 1
        if not ring_only:
            up8 = lambda v: -(-int(np.ceil(v)) // 8) * 8  # noqa: E731
            K_new = up8(self.cl_spec.neighbor_capacity * factor)
            self.cl_spec = dataclasses.replace(
                self.cl_spec, neighbor_capacity=K_new,
                cell_capacity=int(np.ceil(self.cl_spec.cell_capacity * factor)) + 2)
            self.k_model = min(int(np.ceil(self.k_model * factor)), K_new)
            if self.d3_cl_spec is not None:
                spec3 = self.d3_cl_spec
                self.d3_cl_spec = dataclasses.replace(
                    spec3, neighbor_capacity=int(np.ceil(spec3.neighbor_capacity * factor)),
                    cell_capacity=int(np.ceil(spec3.cell_capacity * factor)) + 2)
        else:
            self._ring_margin *= factor
        return self._recreate(state)

    def _recreate(self, state: MDState) -> MDState:
        """The state re-created at the engine's capacities and grids from the
        snapshot ``state`` (positions, velocities, identity, step), rebuilt
        on the device, forces evaluated. The thermostat, barostat and noise
        seed carry over."""
        n_real = int(state.atom_mask.sum())
        n_cap = self._size_ring(n_real)
        new = init_md_state(
            state.positions[:n_real].cpu().numpy(), state.species[:n_real].cpu().numpy(),
            state.cell.cpu().numpy(), masses=state.masses[:n_real].cpu().numpy(),
            velocities=state.velocities[:n_real].cpu().numpy(), n_atoms_cap=n_cap,
            n_edges_cap=n_cap * self.k_model, device=self.device,
            atomic_numbers=(None if state.z_numbers is None
                            else state.z_numbers[:n_real].cpu().numpy()),
            d3_edges_cap=self._d3_slots(n_cap))
        idx = torch.arange(n_cap, dtype=torch.int64, device=self.device)
        idx[:n_real] = state.atom_index[:n_real]
        new = self._rebuild(new.replace(step=state.step, atom_index=idx, rng=state.rng,
                                        thermo=state.thermo, baro=state.baro))
        forces, energy, stress = self._forces(new, compute_stress=True)
        return new.replace(forces=forces, potential_energy=energy, stress=stress)

    def _dump_frame(self, state: MDState, path: str, append: bool):
        from ..atoms import AtomsLite
        from ..data.extxyz import write_extxyz

        n = int(state.atom_mask.sum())
        t2z = {int(t): int(z) for z, t in enumerate(self.spec.z_to_type) if t >= 0}
        order = np.argsort(state.atom_index[:n].cpu().numpy())  # undo the sort
        pos = state.positions[:n].cpu().numpy()[order]
        frc = state.forces[:n].cpu().numpy()[order]
        Z = np.array([t2z[int(t)] for t in state.species[:n].cpu().numpy()[order]])
        frame = AtomsLite(positions=pos, numbers=Z, cell=state.cell.cpu().numpy(), pbc=True,
                          energy=float(state.potential_energy), forces=frc)
        write_extxyz(path, [frame], append=append)
