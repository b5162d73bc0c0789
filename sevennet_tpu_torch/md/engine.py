"""MD engine (PyTorch port of ``sevennet_tpu/md/engine.py``): NVE molecular
dynamics of one periodic system through the fused-conv model on the card.

Each step checks the skin (one host read), rebuilds the neighbour slots on
the device when an atom has moved more than half the skin, evaluates the
model (:func:`~sevennet_tpu_torch.model.model.model_compute`) and
integrates. Capacities are fixed; a rebuild that overflows one (or breaks
the ring backward's window) raises a flag, and :meth:`MDEngine.run`
retries the chunk of steps from its snapshot with grown capacities. The
JAX package compiles each chunk into one ``lax.scan``; here the steps are
a Python loop (CUDA graphs are a later lever, ROADMAP A4).

Large systems: when a layer's gathered edge tensor would pass
:func:`~sevennet_tpu_torch.ops.fused_conv.chunk_threshold` and the spec
asks for edge chunks (``_edge_chunk``), the engine sorts the atoms by cell
(an interleaved cell-id order that keeps every edge's mirror within a few
row chunks) and sizes the conv's ring backward (kernel B3); where the ring
cannot be sized, the conv runs its chunked scatter backward.

The port's engine always runs the dense fused conv (the JAX package's
``dense=True, fused=True``); D3 dispersion and integrators other than NVE
are not ported yet (ROADMAP A8, A11).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..data.graph import GraphBatch, densify_edges
from ..data.neighborlist import neighbor_list_numpy
from ..device import resolve_device
from ..model.build import ModelSpec
from ..model.model import _vec_mode, model_compute, params_to
from ..ops.fused_conv import chunk_threshold, mirror_map, mirror_map_numpy
from .integrators import nve_step
from .neighbor import CellListSpec, build_cell_list_spec, cell_coords, rebuild_neighbors
from .state import ATOMIC_MASSES, MDState, init_md_state, thermal_velocities

__all__ = ["MDEngine"]


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
        when the ring backward engages (100k-atom systems)."""
        if d3:
            raise NotImplementedError("D3 dispersion in the MD engine is not ported yet "
                                      "(ROADMAP A8)")
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

    # -- setup ---------------------------------------------------------------
    def make_state(self, positions, atomic_numbers, temperature: Optional[float] = None,
                   seed: int = 0, compute_forces: bool = True) -> MDState:
        """The initial state: capacities sized from one host neighbour list
        at cutoff + skin (cell list, conv slot width K from the counts within
        cutoff + 0.1 skin, the ring window), atoms wrapped into the box and,
        when the ring engages, sorted by cell; the initial slots and mirror
        map built on the host from the same list. Thermal velocities are
        drawn in the input order, then permuted with the atoms: a structure
        and seed give the same physics whether or not the engine sorts."""
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
        # the conv needs the neighbours within the cutoff; a dropped edge
        # inside the cutoff raises the overflow flag
        close = dst[d2 < (self.spec.cutoff + 0.1 * self.skin) ** 2]
        mx_c = int(np.bincount(close, minlength=n).max()) if len(close) else 8
        k_margin = float(os.environ.get("SEVENNET_TPU_KMARGIN", 1.05))
        k_model = int(np.ceil(mx_c * k_margin)) + 2
        if k_model > self.cl_spec.neighbor_capacity:
            self.cl_spec = dataclasses.replace(self.cl_spec, neighbor_capacity=k_model)
        self.k_model = min(k_model, self.cl_spec.neighbor_capacity)
        self._ring_window = self._host_window(pos_w, dst, src)
        n_cap = self._size_ring(n)

        perm = self._host_sort_perm(pos_w) if self._ring_nb else np.arange(n)
        rank = np.empty(n, np.int64)
        rank[perm] = np.arange(n)
        host_edges = self._host_initial_edges(pos_w[perm], n_cap,
                                              (rank[dst], rank[src], sh, d2))
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
                              velocities=velocities, n_atoms_cap=n_cap,
                              n_edges_cap=n_cap * self.k_model, device=self.device)
        if host_edges is not None:
            idx = np.concatenate([perm, np.arange(n, n_cap)])
            state = state.replace(
                edge_src=self._put(host_edges["src"], torch.int64),
                edge_dst=torch.arange(n_cap * self.k_model, device=self.device) // self.k_model,
                edge_shift=self._put(host_edges["shift"], torch.float32),
                edge_mask=self._put(host_edges["mask"], torch.bool),
                edge_mir=self._put(host_edges["mir"], torch.int64),
                atom_index=self._put(idx, torch.int64),
            )
        else:
            state = self._rebuild(state)
            for _ in range(3):
                ofl_nl, ofl_ring = bool(state.nl_overflow), bool(state.ring_overflow)
                if not (ofl_nl or ofl_ring):
                    break
                state = self._grow_capacities(state, ring_only=ofl_ring and not ofl_nl)
        if not compute_forces:
            return state
        forces, energy, stress = self._forces(state, compute_stress=True)
        return state.replace(forces=forces, potential_energy=energy, stress=stress)

    # -- internals -----------------------------------------------------------
    def _put(self, a, dtype):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _wrap(self, pos: np.ndarray) -> np.ndarray:
        return ((pos @ np.linalg.inv(self.cell)) % 1.0) @ self.cell

    def _dist2(self, pos, dst, src, sh) -> np.ndarray:
        vec = pos[src] + sh @ self.cell - pos[dst]
        return np.sum(vec * vec, axis=1)

    def _cell_ids(self, pos: np.ndarray) -> np.ndarray:
        """Interleaved cell id of each atom (the order of :meth:`_sort_state`)."""
        nx, ny, nz = self.cl_spec.n_cells
        frac = (pos @ np.linalg.inv(self.cell)) % 1.0
        grid = np.array([nx, ny, nz])
        c = np.clip((frac * grid).astype(np.int64), 0, grid - 1)
        return (c[:, 0] * ny + _interleave(c[:, 1], ny)) * nz + _interleave(c[:, 2], nz)

    def _host_window(self, pos, dst, src) -> int:
        """Largest circular row distance between neighbours under the
        interleaved cell-id sort: the ring backward's window, measured on
        the system (about 1.3 x-layers of cells for a homogeneous box)."""
        n = len(pos)
        if len(dst) == 0 or n == 0:
            return 0
        rank = np.empty(n, np.int64)
        rank[np.argsort(self._cell_ids(pos), kind="stable")] = np.arange(n)
        d = np.abs(rank[dst] - rank[src])
        return int(np.minimum(d, n - d).max())

    def _host_sort_perm(self, pos_w: np.ndarray) -> np.ndarray:
        """Numpy twin of :meth:`_sort_state`'s order."""
        return np.argsort(self._cell_ids(pos_w), kind="stable")

    def _host_initial_edges(self, pos_w: np.ndarray, n_cap: int, edges=None):
        """The initial dense ``(N, K)`` slots and mirror map, built on the
        host: what the device rebuild gives, from ``edges = (dst, src,
        shift, d2)`` at cutoff + skin (computed here when None). Returns None
        when K drops an edge inside the cutoff or the ring window fails."""
        n, K = len(pos_w), self.k_model
        if edges is None:
            dst, src, sh = neighbor_list_numpy(pos_w, self.spec.cutoff + self.skin, self.cell,
                                               (True,) * 3)
            edges = (dst, src, sh, self._dist2(pos_w, dst, src, sh))
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
        return dict(src=src_d, shift=shift_d, mask=mask_d, mir=mir)

    def _size_ring(self, n_cap: int) -> int:
        """Sizes the ring backward from the host-measured mirror window:
        row chunk RC from the spec's edge chunk, window W = ceil(window /
        RC) chunks, nb >= 2W + 1 chunks of RC rows. Returns the atom
        capacity ``nb * RC`` (``n_cap`` when the ring stays off: chunking
        not engaged, not vec mode, or too few chunks for the window, where
        the conv runs its chunked scatter backward). The JAX package rounds
        RC to its kernel's atom block; here RC is any row count."""
        self.row_chunk = self._ring_nb = self._ring_w = 0
        if not self.spec.edge_chunk or not _vec_mode(self.spec):
            return self._update_spec(n_cap)
        dim_x_max = max(layer.conv.irreps_x.dim for layer in self.spec.layers)
        if n_cap * self.k_model * dim_x_max * 4 <= chunk_threshold():
            return self._update_spec(n_cap)  # the unchunked backward runs below
        if not self._ring_window:
            self._ring_window = int(np.ceil(1.5 * n_cap / max(self.cl_spec.n_cells[0], 1)))
        window = int(np.ceil(self._ring_margin * self._ring_window))
        rc0 = max(self.spec.edge_chunk // self.k_model, 1)
        # small systems: grow RC (shrink nb) until the 2W+1 window fits
        for nb in range(n_cap // rc0, 2, -1):
            RC = -(-n_cap // nb)
            W = max(1, -(-window // RC))
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

    def _rebuild(self, state: MDState) -> MDState:
        """Device rebuild: (with the ring, sort,) cell list, distance
        truncation to K, mirror map, ring-window check, overflow flags."""
        self.n_rebuilds += 1
        if self._ring_nb:
            state = self._sort_state(state)
        n, K = state.n_atoms_cap, self.k_model
        src, dst, shift, mask, overflow, pos_w = rebuild_neighbors(
            self.cl_spec, state.positions, state.cell, state.atom_mask)
        if K < self.cl_spec.neighbor_capacity:
            src, dst, shift, mask, ofl_trunc = self._truncate_sorted(
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
        heights = 1.0 / torch.linalg.vector_norm(torch.linalg.inv(state.cell).T, dim=1)
        too_small = (heights / torch.tensor(self.cl_spec.n_cells, device=self.device)
                     < self.cl_spec.cutoff).any()
        return state.replace(
            positions=pos_w, nl_positions=pos_w, edge_src=src, edge_dst=dst,
            edge_shift=shift, edge_mask=mask, edge_mir=mir.reshape(-1),
            nl_overflow=state.nl_overflow | overflow | too_small,
            ring_overflow=state.ring_overflow | ring_bad)

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
            atom_index=state.atom_index[p])

    def _truncate_sorted(self, src, shift, mask, pos_w, cell, n):
        """Each atom's slots sorted by distance, the first ``k_model`` kept;
        a dropped edge within the model cutoff flags overflow."""
        K, Kp = self.cl_spec.neighbor_capacity, self.k_model
        src, shift, mask = src.view(n, K), shift.view(n, K, 3), mask.view(n, K)
        vec = pos_w[src] + shift @ cell - pos_w[:, None, :]
        key = torch.where(mask, torch.sum(vec * vec, dim=-1), float("inf"))
        order = torch.argsort(key, dim=1, stable=True)
        src_s, mask_s = torch.gather(src, 1, order), torch.gather(mask, 1, order)
        shift_s = torch.gather(shift, 1, order[..., None].expand(n, K, 3))
        d2_s = torch.gather(key, 1, order)
        ofl = (mask_s[:, Kp:] & (d2_s[:, Kp:] < self.spec.cutoff ** 2)).any()
        dst = torch.repeat_interleave(torch.arange(n, device=src.device), Kp)
        return (src_s[:, :Kp].reshape(-1), dst, shift_s[:, :Kp].reshape(-1, 3),
                mask_s[:, :Kp].reshape(-1), ofl)

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
        return out["forces"], out["energy"][0], stress

    def _run_chunk(self, state: MDState, length: int, dt: float):
        """``length`` NVE steps; stops early once a rebuild overflows (the
        caller retries from its snapshot)."""
        skin_half_sq = (self.skin / 2.0) ** 2
        pe, ke = [], []
        for _ in range(length):
            disp = state.positions - state.nl_positions
            if bool((torch.sum(disp * disp, dim=-1) * state.atom_mask > skin_half_sq).any()):
                state = self._rebuild(state)
                if bool(state.nl_overflow | state.ring_overflow):
                    break
            state = nve_step(state, self._forces, dt)
            pe.append(state.potential_energy)
            ke.append(state.kinetic_energy())
        return state, pe, ke

    # -- public --------------------------------------------------------------
    def run(self, state: MDState, n_steps: int, dt: float = 1.0, integrator: str = "nve",
            chunk: int = 10, traj_path: Optional[str] = None, traj_every: int = 0):
        """``n_steps`` NVE steps in chunks of ``chunk``; returns ``(state,
        (pe, ke))``, the potential and kinetic energy of every step. A chunk
        whose rebuild overflows is retried from its snapshot with grown
        capacities, up to 3 times. ``traj_path`` appends an extxyz frame
        every ``traj_every`` steps (rounded to chunk ends; default: every
        chunk), atoms in the input order."""
        if integrator != "nve":
            raise NotImplementedError(f"integrator {integrator!r} is not ported yet "
                                      "(ROADMAP A11); the port runs 'nve'")
        traj_pe, traj_ke = [], []
        if traj_path and traj_every <= 0:
            traj_every = chunk
        steps_done, next_dump = 0, traj_every
        if traj_path:
            self._dump_frame(state, traj_path, append=False)
        for length in [chunk] * (n_steps // chunk) + ([n_steps % chunk] if n_steps % chunk else []):
            for _ in range(4):
                prev = state
                state, pe, ke = self._run_chunk(state, length, dt)
                ofl_nl, ofl_ring = bool(state.nl_overflow), bool(state.ring_overflow)
                if not (ofl_nl or ofl_ring):
                    break
                state = self._grow_capacities(prev, ring_only=ofl_ring and not ofl_nl)
            else:
                raise RuntimeError(
                    "neighbor-list capacity overflow persisted after 3 automatic growth "
                    "attempts: the system is likely collapsing (check the potential and "
                    "the timestep)")
            traj_pe += pe
            traj_ke += ke
            steps_done += length
            if traj_path and steps_done >= next_dump:
                self._dump_frame(state, traj_path, append=True)
                next_dump += traj_every
        return state, (torch.stack(traj_pe), torch.stack(traj_ke))

    def _grow_capacities(self, state: MDState, factor: float = 1.35,
                         ring_only: bool = False) -> MDState:
        """Capacities (cell occupancy, neighbour slots, conv slot width)
        ``factor`` larger, or with ``ring_only`` just the ring's window
        margin; the state re-created from the snapshot ``state`` (positions,
        velocities, identity, step), rebuilt on the device, forces
        evaluated."""
        self.n_growths += 1
        if not ring_only:
            up8 = lambda v: -(-int(np.ceil(v)) // 8) * 8  # noqa: E731
            K_new = up8(self.cl_spec.neighbor_capacity * factor)
            self.cl_spec = dataclasses.replace(
                self.cl_spec, neighbor_capacity=K_new,
                cell_capacity=int(np.ceil(self.cl_spec.cell_capacity * factor)) + 2)
            self.k_model = min(int(np.ceil(self.k_model * factor)), K_new)
        else:
            self._ring_margin *= factor
        n_real = int(state.atom_mask.sum())
        n_cap = self._size_ring(n_real)
        new = init_md_state(
            state.positions[:n_real].cpu().numpy(), state.species[:n_real].cpu().numpy(),
            state.cell.cpu().numpy(), masses=state.masses[:n_real].cpu().numpy(),
            velocities=state.velocities[:n_real].cpu().numpy(), n_atoms_cap=n_cap,
            n_edges_cap=n_cap * self.k_model, device=self.device)
        idx = torch.arange(n_cap, dtype=torch.int64, device=self.device)
        idx[:n_real] = state.atom_index[:n_real]
        new = self._rebuild(new.replace(step=state.step, atom_index=idx))
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
