"""Distributed (domain-decomposed) MD on ``torch.distributed`` (the port of
``sevennet_tpu/parallel/md.py``; the counterpart of the reference's parallel
LAMMPS pair style, ``pair_e3gnn_parallel.cpp:194-506``, with the CommBrick
halo exchange, ``comm_brick.cpp:1057-1123``).

One process per domain, each holding only its own domain's slice of the
state, as LAMMPS runs one MPI rank per domain; the JAX package runs one
SPMD program over a device mesh instead. Every rank builds the same
engine, calls :meth:`DistributedMDEngine.make_state` with the whole system
(each keeps its own atoms) and then :meth:`~DistributedMDEngine.run`:

- 1-D slab or 2-D/3-D brick decomposition over ``dims`` (1-3 extents whose
  product is the group's size; rank ``r`` sits at the C-order coordinates
  of ``r``). Bricks are slabs in FRACTIONAL coordinates, so triclinic cells
  decompose into prisms.
- Halos use the CommBrick staged swap: exchange along grid axis 0, then
  along axis 1 shipping owned atoms and axis-0 ghosts, then axis 2; corner
  and edge ghosts ride along (:mod:`.comm`).
- Per evaluation the ghost positions are refreshed with the staged
  exchanges, then each layer's ghost features (the layer loop is
  :func:`.model.local_atomic_energy`, on the ext conv's kernels). Forces are
  ``-d(local energy sum)/d(positions)``: the exchange's backward carries
  the ghost cotangents home (``reverse_comm``, ``:404-441``). The energy,
  kinetic energy, virial and the overflow flag are all-reduced afterwards,
  a few scalars a step.
- The skin test runs where a step evaluates the forces and is all-reduced
  (one more scalar), so all ranks rebuild together, before the
  evaluation: atoms migrate to face neighbours axis by axis into
  fixed-capacity buffers (diagonal moves complete across the sequential
  passes, as in LAMMPS), the staged send lists are rebuilt, and the local
  cell list (:mod:`~sevennet_tpu_torch.md.neighbor`) runs on the owned and
  ghost set in a padded local frame. The slots keep each atom's
  ``k_model`` nearest neighbours, so the test's limit is half the smaller
  of the skin and ``d_drop - cutoff``, ``d_drop`` the nearest edge that any
  rank cut (all-reduced at the rebuild), narrowed by the cell's scale since
  the build under ``npt`` (:func:`~sevennet_tpu_torch.md.neighbor.
  shrink_limit`; with D3 also the D3 list's skin at the D3 cutoff): every
  pair within the cutoff then holds a slot at every evaluation. The JAX
  engine tests half the skin after the evaluation and misses a cut pair
  that closes in.
- Capacities are fixed (the ext conv's ``(NL, K)`` slot grid needs them):
  an exceeded one raises the overflow flag and :meth:`run` raises
  ``RuntimeError`` at the end of the chunk.

Integrators: ``nve``; ``nose_hoover``/``nvt`` (the chain on the all-reduced
global kinetic energy, replicated on every rank); ``langevin`` (each
rank's noise from a generator seeded by seed, rank and step); ``npt`` (the
isotropic MTK piston on the all-reduced kinetic energy and virial, with
``cell_scale`` and ``scale_budget``: the halos and cell lists are sized for
the smallest scale of the budget, and a step whose scale falls below it
raises before it evaluates). Optional D3 dispersion runs a second local
list at the D3 cutoff; ghost coordination numbers ride the exchange.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.neighborlist import neighbor_counts, neighbor_list_numpy
from ..device import resolve_device
from ..md.integrators import _chain_half, _nhc_baro_half, _sinhc
from ..md.neighbor import (CellListSpec, build_cell_list_spec, rebuild_neighbors, shrink_limit,
                           skin_limit)
from ..md.state import ATOMIC_MASSES, EV_A_AMU_TO_A_FS2, KB_EV, thermal_velocities
from ..model.build import ModelSpec
from ..model.model import params_to
from .comm import Halo, HaloExchange, _rows
from .model import check_spec, local_atomic_energy, local_gradients, virial_stress

__all__ = ["DistributedMDEngine", "DistMDState", "INTEGRATORS"]

# slot-width margin over the host counts of make_state: the capacities stay
# fixed, and the largest count within the cutoff of a water lattice that
# melts grows by about 17 % in its first 30 fs (58 to 68 at 600 atoms and
# 300-600 K, SevenNet-0 with random weights)
K_MARGIN = 1.3
INTEGRATORS = ("nve", "langevin", "nose_hoover", "nvt", "npt", "npt_mtk", "npt_nose_hoover")
_NPT = ("npt", "npt_mtk", "npt_nose_hoover")


@dataclass(frozen=True)
class DistMDState:
    """One rank's slice of the MD state (the JAX package stacks every
    device's along a leading axis)."""

    positions: torch.Tensor   # (NL, 3) global coordinates
    velocities: torch.Tensor  # (NL, 3)
    forces: torch.Tensor      # (NL, 3)
    species: torch.Tensor     # (NL,) int64
    masses: torch.Tensor      # (NL,)
    atom_mask: torch.Tensor   # (NL,) bool
    atom_index: torch.Tensor  # (NL,) int64 input index of each atom, -1 on padding
    # halo machinery, one entry per stage; the stage-s send lists index the
    # EXTENDED array after stages < s
    send_lo: Tuple[torch.Tensor, ...]       # (S_s,) int64
    send_lo_mask: Tuple[torch.Tensor, ...]  # (S_s,) bool
    send_hi: Tuple[torch.Tensor, ...]
    send_hi_mask: Tuple[torch.Tensor, ...]
    ext_mask: torch.Tensor    # (NL + 2 sum S_s,) bool: owned and ghost rows
    ext_image: torch.Tensor   # (NL + 2 sum S_s, 3) lattice images of the ghost rows
    # dense neighbour slots: src indexes the EXTENDED array [owned | ghosts]
    edge_src: torch.Tensor    # (NL, K) int64
    edge_shift: torch.Tensor  # (NL, K, 3) wraps along axes that are not decomposed
    edge_mask: torch.Tensor   # (NL, K) bool
    nl_positions: torch.Tensor  # (NL, 3)
    nl_limit: torch.Tensor    # () the skin test's squared limit (global, ``_rebuild``)
    thermo: torch.Tensor      # (2, 3) Nose-Hoover chain (replicated)
    baro: torch.Tensor        # (8,) MTK barostat [v_eps, xi(3), vxi(3), eps_log] (replicated)
    cell_scale: torch.Tensor  # () isotropic cell scale (physical cell = s * cell0)
    nl_scale: torch.Tensor    # () cell_scale at the last build (the skin test's shrink)
    p_virial: torch.Tensor    # () virial pressure of the last evaluation
    potential_energy: torch.Tensor  # () global
    kinetic_energy: torch.Tensor    # () global
    nl_overflow: torch.Tensor  # () bool, global after each step
    step: int = 0
    rng: int = 0              # noise seed (with rank and step)
    # optional D3 dispersion list (src indexes the extended set)
    d3_edge_src: Optional[torch.Tensor] = None    # (NL, K3)
    d3_edge_shift: Optional[torch.Tensor] = None  # (NL, K3, 3)
    d3_edge_mask: Optional[torch.Tensor] = None   # (NL, K3)

    def replace(self, **kw) -> "DistMDState":
        return dataclasses.replace(self, **kw)


def _pack(mask: torch.Tensor, cap: int):
    """Indices of the True entries first, packed to ``cap`` (0 beyond), their
    validity, and whether they overflow ``cap``."""
    n = mask.shape[0]
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    take = min(cap, n)
    idx = order[:take]
    if take < cap:
        idx = torch.cat([idx, idx.new_zeros(cap - take)])
    cnt = mask.sum()
    valid = torch.arange(cap, device=mask.device) < cnt
    return torch.where(valid, idx, 0), valid, cnt > cap


class DistributedMDEngine:
    """Brick-decomposed MD over ``dims`` ranks of ``group`` (default: the
    default group; the caller starts it, e.g. ``nccl`` with one card a rank,
    or ``gloo`` for ranks that share a card or run on the CPU).

    The arguments of the JAX engine, ``mesh`` replaced by ``dims`` and
    ``group``: ``axes`` maps grid axes to cell axes (by default the cell
    axes with the largest plane spacings; ``axis`` for a 1-D grid);
    ``local_cap``, ``ghost_caps`` and ``migrate_cap`` fix the capacities
    (sized from the first state when None); ``d3`` adds D3 dispersion;
    ``scale_budget`` < 1 sizes the halos for the smallest cell scale an
    ``npt`` run may reach. ``fused``: the ext conv's kernels (default on
    ``cuda``) or its plain version (default on the CPU). Runs on ``cuda``
    unless ``device="cpu"``."""

    def __init__(
        self,
        spec: ModelSpec,
        params,
        cell: np.ndarray,
        dims: Sequence[int] = (1,),
        group=None,
        skin: float = 0.6,
        axis: Optional[int] = None,
        axes: Optional[Sequence[int]] = None,
        local_cap: Optional[int] = None,
        ghost_caps: Optional[Sequence[int]] = None,
        migrate_cap: Optional[int] = None,
        fused: Optional[bool] = None,
        d3: Optional[dict] = None,
        scale_budget: float = 1.0,
        device: Optional[str] = None,
    ):
        check_spec(spec)
        cell = np.asarray(cell, np.float64).reshape(3, 3)
        self.device = resolve_device(device)
        self.s_min = float(min(scale_budget, 1.0))
        if not self.s_min > 0.5:
            raise ValueError("scale_budget must be in (0.5, 1]")
        # the ext conv runs the scatter backward; a layer's rows are chunked
        # past chunk_threshold (edge chunks of the spec, else 32,768 edges)
        self.spec = dataclasses.replace(spec, conv_ring=0,
                                        edge_chunk=spec.edge_chunk or 32768)
        self.plain = not (self.device.type == "cuda" if fused is None else fused)
        self.params = params_to(params, self.device)
        self.cell = cell
        self.halo = Halo(dims, self.device, group)
        self.dims = self.halo.dims
        self.D = self.halo.size
        self.rank = self.halo.rank
        self.coords = self.halo.coords
        self.n_stages = len(self.dims)
        self.skin = float(skin)
        self.rc = float(spec.cutoff) + self.skin
        self.d3_params = None
        if d3:
            from ..d3 import D3Params, bounded_cutoff

            p = D3Params.from_functional(d3.get("functional", "pbe"),
                                         d3.get("damping", d3.get("damping_type", "damp_bj")))
            cut = d3.get("cutoff") or bounded_cutoff(p, cell, True)
            heights0 = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=0)
            cut = min(cut, float(heights0.min()) - self.skin - 1e-6)
            self.d3_params = dataclasses.replace(p, cutoff=cut, cn_cutoff=min(p.cn_cutoff, cut))
        self.rc_ghost = self.rc
        # fractional-space brick geometry (triclinic-ready): bricks are slabs
        # in the fractional coordinate u_a; halo band widths convert the
        # cutoff through the plane spacing h_a
        inv_full = np.linalg.inv(cell)
        heights_all = 1.0 / np.linalg.norm(inv_full, axis=0)
        if axes is None:
            if axis is not None and self.n_stages == 1:
                axes = (int(axis),)
            else:
                axes = tuple(int(i) for i in np.argsort(-heights_all)[: self.n_stages])
        self.axes: Tuple[int, ...] = tuple(int(a) for a in axes)
        if len(self.axes) != self.n_stages or len(set(self.axes)) != self.n_stages:
            raise ValueError(f"axes {self.axes} must name {self.n_stages} distinct cell axes")
        self.inv_cols = tuple(np.asarray(inv_full[:, a], np.float64) for a in self.axes)
        self.h = tuple(float(heights_all[a]) for a in self.axes)
        if self.d3_params is not None:
            # the D3 cutoff must fit the brick: ghosts come from face
            # neighbours only, so the halo cannot pass one brick width
            wmin = min((self.h[s] / self.dims[s] for s in range(self.n_stages)
                        if self.dims[s] > 1), default=np.inf)
            cut = float(self.d3_params.cutoff)
            if cut + self.skin > wmin:
                cut = wmin - self.skin - 1e-6
                if cut <= 2.0:
                    raise ValueError("brick too thin for any useful D3 cutoff")
                self.d3_params = dataclasses.replace(
                    self.d3_params, cutoff=cut, cn_cutoff=min(self.d3_params.cn_cutoff, cut))
            self.rc_ghost = max(self.rc, float(self.d3_params.cutoff) + self.skin)
            t2z = np.zeros(spec.num_species, np.int64)
            for z, t in enumerate(np.asarray(spec.z_to_type)):
                if t >= 0:
                    t2z[int(t)] = z
            self.t2z = torch.as_tensor(t2z, device=self.device)
        self.u_w = tuple(1.0 / self.dims[s] for s in range(self.n_stages))
        # halo band: the widest cutoff any term needs, at the smallest cell
        # scale of the NPT budget (fractional widths grow as the cell shrinks)
        self.u_rc = tuple(self.rc_ghost / (self.h[s] * self.s_min) for s in range(self.n_stages))
        self.w = tuple(self.h[s] / self.dims[s] for s in range(self.n_stages))
        for s in range(self.n_stages):
            if self.w[s] * self.s_min < self.rc_ghost and self.dims[s] > 1:
                raise ValueError(
                    f"brick width {self.w[s] * self.s_min:.2f} (at the NPT scale budget) along "
                    f"cell axis {self.axes[s]} < halo width {self.rc_ghost:.2f}: use fewer ranks, "
                    "a bigger box, or a smaller d3 cutoff")
        self.axis = self.axes[0]
        self.local_cap = local_cap
        self.ghost_caps = list(ghost_caps) if ghost_caps else None
        self.migrate_cap = migrate_cap
        self.cl_spec: Optional[CellListSpec] = None
        self.d3_cl_spec: Optional[CellListSpec] = None
        self.k_model: Optional[int] = None
        self.n_atoms = 0
        self.n_rebuilds = 0  # rebuilds so far (the same on every rank)
        self.n_migrated = 0  # atoms this rank has sent to a neighbour so far
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)  # noqa: E731
        self._cell_t = t(cell)
        self._inv_t = t(inv_full)
        self._inv_cols_t = [t(c) for c in self.inv_cols]
        self._det0 = float(abs(np.linalg.det(cell)))

    # ------------------------------------------------------------------
    # host-side initial decomposition (numpy, the same on every rank)
    # ------------------------------------------------------------------
    def _owner_coords(self, frac: np.ndarray) -> np.ndarray:
        out = np.zeros((len(frac), self.n_stages), int)
        for s, a in enumerate(self.axes):
            out[:, s] = np.minimum((frac[:, a] * self.dims[s]).astype(int), self.dims[s] - 1)
        return out

    def _linear_device(self, coords: np.ndarray) -> np.ndarray:
        """Brick coords -> rank (C order over ``dims``)."""
        lin = np.zeros(len(coords), int)
        for s in range(self.n_stages):
            lin = lin * self.dims[s] + coords[:, s]
        return lin

    def _size_ghost_caps(self, frac: np.ndarray):
        """Per-stage ghost capacities from the atoms in each brick's halo band
        (the band of the brick extended by the halo along earlier stages),
        with the JAX package's margin."""
        n = len(frac)
        self.ghost_caps = []
        for s in range(self.n_stages):
            a = self.axes[s]
            best = 8
            for d in range(self.D):
                rem, dc = d, []
                for t in range(self.n_stages - 1, -1, -1):
                    dc.append(rem % self.dims[t])
                    rem //= self.dims[t]
                dc = dc[::-1]
                sel = np.ones(n, bool)
                for t in range(s):
                    lo = dc[t] * self.u_w[t] - self.u_rc[t]
                    hi = (dc[t] + 1) * self.u_w[t] + self.u_rc[t]
                    u = frac[:, self.axes[t]]
                    inside = (((u - lo) % 1.0 <= (hi - lo)) if self.dims[t] > 1
                              else np.ones(n, bool))
                    sel &= inside
                if self.dims[s] == 1:
                    cnt = 0
                else:
                    u = frac[sel][:, a]
                    lo_face = dc[s] * self.u_w[s]
                    hi_face = (dc[s] + 1) * self.u_w[s]
                    near_lo = (lo_face - u) % 1.0 <= self.u_rc[s]
                    near_hi = (u - hi_face) % 1.0 <= self.u_rc[s]
                    cnt = max(int(near_lo.sum()), int(near_hi.sum()))
                best = max(best, cnt)
            self.ghost_caps.append(int(-(-int(best * 1.6 + 8) // 8) * 8))

    def _size_cell_lists(self, pos: np.ndarray):
        """The local frame's cell (brick, two halos and a decoupling gap
        along each decomposed axis, the whole lattice vector scaled so that
        prisms keep their shape) and its cell lists. The slot widths come
        from the host neighbour counts: K at cutoff + skin and the conv's
        ``k_model`` within cutoff + 0.1 skin (the slots are cut to it by
        distance; the nearest cut edge narrows the skin test), each x
        K_MARGIN + 4 (the serial engine grows its capacities and takes x 1.2
        + 2 and x 1.05 + 2; these are fixed), and
        with D3 its width at the D3 cutoff + skin (x 1.15 + 2)."""
        fake = self.cell.copy()
        occ = 1.0
        for s, a in enumerate(self.axes):
            if self.dims[s] > 1:
                f_a = self.u_w[s] + (2 + 2.2) * self.u_rc[s]
                fake[a] = self.cell[a] * f_a
                occ *= (self.u_w[s] + 2 * self.u_rc[s]) / f_a
        self.fake_cell = fake
        self._fake_t = torch.as_tensor(fake, dtype=torch.float32, device=self.device)
        n_eff = int(np.ceil((self.local_cap + 2 * sum(self.ghost_caps)) / occ))
        n = len(pos)
        dst, src, sh = neighbor_list_numpy(pos, self.rc, self.cell, (True,) * 3)
        vec = pos[src] + sh @ self.cell - pos[dst]
        d2 = np.sum(vec * vec, axis=1)
        mx = int(np.bincount(dst, minlength=n).max()) if len(dst) else 8
        close = dst[d2 < (self.spec.cutoff + 0.1 * self.skin) ** 2]
        mx_c = int(np.bincount(close, minlength=n).max()) if len(close) else 8
        self.k_model = int(np.ceil(mx_c * K_MARGIN)) + 4
        k_full = max(int(np.ceil(mx * K_MARGIN)) + 4, self.k_model)
        self.cl_spec = build_cell_list_spec(fake * self.s_min, n_eff, self.spec.cutoff, self.skin,
                                            neighbor_capacity=k_full)
        if self.d3_params is not None:
            counts = neighbor_counts(pos, self.d3_params.cutoff + self.skin, self.cell)
            k3 = int(np.ceil((int(counts.max()) if counts.sum() else 8) * 1.15)) + 2
            self.d3_cl_spec = build_cell_list_spec(fake * self.s_min, n_eff,
                                                   float(self.d3_params.cutoff), self.skin,
                                                   neighbor_capacity=k3)

    def make_state(self, positions, atomic_numbers, temperature: Optional[float] = None,
                   seed: int = 0, velocities=None) -> DistMDState:
        """This rank's state of the whole system ``positions`` (every rank
        passes the same): its own atoms (in input order), capacities sized
        on the first call, the halos and lists built, forces evaluated.
        Velocities: given, thermal at ``temperature`` (numpy generator from
        ``seed``, as the serial engine draws them), or zero."""
        pos = np.asarray(positions, np.float64)
        n = len(pos)
        frac = pos @ np.linalg.inv(self.cell)
        frac -= np.floor(frac)
        pos = frac @ self.cell
        owner = self._linear_device(self._owner_coords(frac))
        counts = np.bincount(owner, minlength=self.D)
        if self.local_cap is None:
            self.local_cap = int(-(-int(counts.max() * 1.3 + 8) // 8) * 8)
        NL = self.local_cap
        if self.ghost_caps is None:
            self._size_ghost_caps(frac)
        if self.migrate_cap is None:
            self.migrate_cap = max(max(self.ghost_caps) // 2, 16)
        if self.cl_spec is None:
            self._size_cell_lists(pos)

        Z = np.asarray(atomic_numbers)
        species = self.spec.z_to_type[Z]
        if (species < 0).any():
            raise ValueError("unknown species for this model")
        masses = ATOMIC_MASSES[Z]
        if velocities is not None:
            vel = np.asarray(velocities, np.float64)
        elif temperature is None:
            vel = np.zeros_like(pos)
        else:
            vel = thermal_velocities(masses, temperature, seed)
        sel = np.flatnonzero(owner == self.rank)
        if len(sel) > NL:
            raise RuntimeError("distributed MD overflow: local_cap too small")
        self.n_atoms = n

        def pad(a, fill, dtype):
            out = np.full((NL,) + np.shape(a)[1:], fill, dtype)
            out[: len(sel)] = np.asarray(a)[sel]
            return torch.as_tensor(out, device=self.device)

        dev = self.device
        f32 = torch.float32
        zero = torch.zeros((), dtype=f32, device=dev)
        P = pad(pos, 0.0, np.float32)
        state = DistMDState(
            positions=P, velocities=pad(vel, 0.0, np.float32),
            forces=torch.zeros((NL, 3), dtype=f32, device=dev),
            species=pad(species, 0, np.int64), masses=pad(masses, 1.0, np.float32),
            atom_mask=torch.arange(NL, device=dev) < len(sel),
            atom_index=pad(np.arange(n), -1, np.int64),
            send_lo=(), send_lo_mask=(), send_hi=(), send_hi_mask=(),
            ext_mask=torch.zeros(NL, dtype=torch.bool, device=dev),
            ext_image=torch.zeros((NL, 3), dtype=f32, device=dev),
            edge_src=torch.zeros((NL, 1), dtype=torch.int64, device=dev),
            edge_shift=torch.zeros((NL, 1, 3), dtype=f32, device=dev),
            edge_mask=torch.zeros((NL, 1), dtype=torch.bool, device=dev),
            nl_positions=P, nl_limit=torch.zeros((), dtype=f32, device=dev),
            thermo=torch.zeros((2, 3), dtype=f32, device=dev),
            baro=torch.zeros(8, dtype=f32, device=dev),
            cell_scale=torch.ones((), dtype=f32, device=dev),
            nl_scale=torch.ones((), dtype=f32, device=dev),
            p_virial=zero, potential_energy=zero, kinetic_energy=zero,
            nl_overflow=torch.zeros((), dtype=torch.bool, device=dev),
            step=0, rng=int(seed),
        )
        state = self._rebuild(state)
        e_loc, forces, geps = self._evaluate(state, virial=True)
        return self._finish(state, e_loc, forces=forces, p_virial=self._p_virial(state, geps))

    # ------------------------------------------------------------------
    # rank-local pieces
    # ------------------------------------------------------------------
    def _extend(self, state: DistMDState, x: torch.Tensor) -> torch.Tensor:
        """``x`` of the owned rows with every stage's ghost rows appended,
        differentiable (:class:`~.comm.HaloExchange`)."""
        for s in range(self.n_stages):
            x = HaloExchange.apply(x, self.halo, s, state.send_lo[s], state.send_lo_mask[s],
                                   state.send_hi[s], state.send_hi_mask[s])
        return x

    def _extend_const(self, state: DistMDState, x: torch.Tensor) -> torch.Tensor:
        for s in range(self.n_stages):
            x = self.halo.extend(s, x, state.send_lo[s], state.send_lo_mask[s],
                                 state.send_hi[s], state.send_hi_mask[s])
        return x

    def _to_local_frame(self, pos: torch.Tensor, scale) -> torch.Tensor:
        """Shift into the rank's local (padded) frame: subtract (origin_u -
        u_rc) lattice vectors along each decomposed axis."""
        out = pos
        for s, a in enumerate(self.axes):
            if self.dims[s] > 1:
                off_u = self.coords[s] * self.u_w[s] - self.u_rc[s]
                out = out - off_u * (self._cell_t[a] * scale)[None, :]
        return out

    def _migrate_axis(self, s, payload, amask, scale):
        """One axis pass of migration on the rank's rows ``payload`` (float64
        columns: position, velocity, species, mass, input index, force); returns
        the new rows and mask and the overflow flag."""
        NL = payload.shape[0]
        Dv, d = self.dims[s], self.coords[s]
        u = payload[:, :3].float() @ self._inv_cols_t[s] / scale
        own = torch.clamp((u * Dv).to(torch.int64), 0, Dv - 1)
        rel = own - d
        stay = (rel == 0) & amask
        none = torch.zeros_like(stay)
        if Dv == 1:
            # the rank owns the whole extent: nothing migrates
            go_lo, go_hi = none, none
        elif Dv == 2:
            # both neighbours are one rank: send once
            go_lo, go_hi = (rel != 0) & amask, none
        else:
            go_lo = ((rel == -1) | (rel == Dv - 1)) & amask
            go_hi = ((rel == 1) | (rel == -(Dv - 1))) & amask
        too_far = amask & ~(stay | go_lo | go_hi)
        M = self.migrate_cap
        idx_l, vm_l, ofl_l = _pack(go_lo, M)
        idx_r, vm_r, ofl_r = _pack(go_hi, M)
        self.n_migrated += int((go_lo | go_hi).sum())

        def bundle(idx, vm):
            return torch.cat([_rows(payload, idx, vm), vm[:, None].to(payload.dtype)], 1)

        arr_lo, arr_hi = self.halo.swap(s, bundle(idx_l, vm_l), bundle(idx_r, vm_r))
        new = torch.cat([payload[stay], arr_lo[arr_lo[:, -1] > 0, :-1],
                         arr_hi[arr_hi[:, -1] > 0, :-1]])
        n_total = new.shape[0]
        new = new[:NL]
        fill = payload.new_zeros((NL - new.shape[0], payload.shape[1]))
        fill[:, 7] = 1.0
        fill[:, 8] = -1.0
        new = torch.cat([new, fill])
        mask = torch.arange(NL, device=payload.device) < min(n_total, NL)
        ofl = too_far.any() | ofl_l | ofl_r | (n_total > NL)
        return new, mask, ofl

    def _slots(self, spec: CellListSpec, loc, ext_mask, scale, NL, k_keep: int = 0):
        """The rank's owned rows of the local cell list over the extended
        set: ``(src, shift, mask)`` of ``(NL, K)`` slots (``k_keep`` > 0:
        the nearest ``k_keep`` of each row), the overflow flag (a capacity,
        a cut edge within the model cutoff, or an owned edge that wraps a
        decomposed axis: the gap failed) and the squared distance of the
        nearest cut edge (inf: none)."""
        Next = loc.shape[0]
        fake = self._fake_t * scale
        src, _, shift, mask, ofl, loc_w = rebuild_neighbors(spec, loc, fake, ext_mask)
        K = spec.neighbor_capacity
        src = src.view(Next, K)[:NL]
        shift = shift.view(Next, K, 3)[:NL]
        mask = mask.view(Next, K)[:NL]
        d2_drop = torch.full((), float("inf"), device=loc.device)
        if k_keep and k_keep < K:
            vec = loc_w[src] + shift @ fake - loc_w[:NL, None, :]
            key = torch.where(mask, torch.sum(vec * vec, dim=-1), float("inf"))
            order = torch.argsort(key, dim=1, stable=True)
            src, mask = torch.gather(src, 1, order), torch.gather(mask, 1, order)
            shift = torch.gather(shift, 1, order[..., None].expand(NL, K, 3))
            d2 = torch.gather(key, 1, order)  # inf on the masked slots
            ofl = ofl | (mask[:, k_keep:] & (d2[:, k_keep:] < self.spec.cutoff ** 2)).any()
            d2_drop = d2[:, k_keep:].min()
            src, shift, mask = src[:, :k_keep], shift[:, :k_keep], mask[:, :k_keep]
        for s, a in enumerate(self.axes):
            if self.dims[s] > 1:
                ofl = ofl | ((shift[..., a].abs() > 0.5) & mask).any()
        return src, shift, mask, ofl, d2_drop

    def _rebuild(self, state: DistMDState) -> DistMDState:
        """Migration (axis by axis), staged send lists and ghost images,
        local neighbour lists, the skin test's limit from the nearest edge
        that any rank cut (one all-reduce); the local overflow flag."""
        self.n_rebuilds += 1
        NL = state.positions.shape[0]
        scale = state.cell_scale
        cell_s = self._cell_t * scale
        frac = state.positions @ self._inv_t / scale
        pos = (frac - torch.floor(frac)) @ cell_s
        ofl = torch.zeros((), dtype=torch.bool, device=self.device)
        # the forces travel with their atoms (the JAX engine leaves them in
        # the old row order, so a step after a migration kicks atoms with
        # other atoms' forces)
        payload = torch.cat([t.double() for t in (
            pos, state.velocities, state.species[:, None], state.masses[:, None],
            state.atom_index[:, None], state.forces)], 1)
        amask = state.atom_mask
        for s in range(self.n_stages):
            payload, amask, o = self._migrate_axis(s, payload, amask, scale)
            ofl = ofl | o
        pos = payload[:, :3].float()

        send_lo, mlo, send_hi, mhi = [], [], [], []
        ext_pos, ext_mask = pos, amask
        ext_image = torch.zeros_like(pos)
        for s, a in enumerate(self.axes):
            cap = self.ghost_caps[s]
            if self.dims[s] > 1:
                u = ext_pos @ self._inv_cols_t[s] / scale
                origin = self.coords[s] * self.u_w[s]
                band_lo = ext_mask & (u < origin + self.u_rc[s])
                band_hi = ext_mask & (u >= origin + self.u_w[s] - self.u_rc[s])
            else:
                band_lo = band_hi = torch.zeros_like(ext_mask)
            slo, vlo, o1 = _pack(band_lo, cap)
            shi, vhi, o2 = _pack(band_hi, cap)
            ofl = ofl | o1 | o2
            rows = torch.cat([ext_pos, ext_image, ext_mask[:, None].float()], 1)
            from_lo, from_hi = self.halo.swap(s, _rows(rows, slo, vlo), _rows(rows, shi, vhi))
            gl, gh = from_lo[:, 6] > 0.5, from_hi[:, 6] > 0.5
            if self.dims[s] > 1:
                # the periodic seam: ghosts that cross the cell boundary
                # shift by the whole lattice vector of the decomposed axis
                # (their image counts carry it to the evaluations)
                for rows_in, ghost, edge, sign in ((from_lo, gl, 0, -1.0),
                                                   (from_hi, gh, self.dims[s] - 1, 1.0)):
                    if self.coords[s] == edge:
                        rows_in[:, :3] += sign * ghost[:, None] * cell_s[a]
                        rows_in[:, 3 + a] += sign * ghost
            ext_pos = torch.cat([ext_pos, from_lo[:, :3], from_hi[:, :3]])
            ext_image = torch.cat([ext_image, from_lo[:, 3:6], from_hi[:, 3:6]])
            ext_mask = torch.cat([ext_mask, gl, gh])
            send_lo.append(slo)
            mlo.append(vlo)
            send_hi.append(shi)
            mhi.append(vhi)

        loc = self._to_local_frame(ext_pos, scale)
        src, shift, emask, o, d2_drop = self._slots(self.cl_spec, loc, ext_mask, scale, NL,
                                                    self.k_model)
        ofl = ofl | o
        # a cut pair between ranks closes by both owners' displacements,
        # each held by its own rank's test: the limit is global
        limit = skin_limit(self.halo.all_reduce(d2_drop, op="min"), self.spec.cutoff, self.skin)
        d3 = {}
        if self.d3_params is not None:
            s3, sh3, m3, o3, _ = self._slots(self.d3_cl_spec, loc, ext_mask, scale, NL)
            ofl = ofl | o3
            d3 = dict(d3_edge_src=s3, d3_edge_shift=sh3, d3_edge_mask=m3)
        return state.replace(
            positions=pos, velocities=payload[:, 3:6].float(),
            species=payload[:, 6].long(), masses=payload[:, 7].float(), atom_mask=amask,
            atom_index=payload[:, 8].long(), forces=payload[:, 9:12].float(),
            send_lo=tuple(send_lo), send_lo_mask=tuple(mlo),
            send_hi=tuple(send_hi), send_hi_mask=tuple(mhi),
            ext_mask=ext_mask, ext_image=ext_image,
            edge_src=src, edge_shift=shift, edge_mask=emask, nl_positions=pos,
            nl_limit=limit, nl_scale=scale, nl_overflow=state.nl_overflow | ofl, **d3)

    # ------------------------------------------------------------------
    # energy, forces, virial
    # ------------------------------------------------------------------
    def _dst(self, NL: int, K: int) -> torch.Tensor:
        return torch.arange(NL, device=self.device).repeat_interleave(K)

    def _local_energy(self, state: DistMDState, pos, eps):
        """Masked atomic energies of the owned atoms: the ghost positions
        through the staged exchange (plus their lattice images), then the
        layer loop with a staged feature exchange per layer, and D3."""
        NL, K = state.edge_src.shape
        cell_s = self._cell_t * state.cell_scale
        ext_pos = self._extend(state, pos) + state.ext_image @ cell_s
        ev = (ext_pos[state.edge_src.reshape(-1)] - pos[self._dst(NL, K)]
              + state.edge_shift.reshape(-1, 3) @ cell_s)
        if eps is not None:
            ev = ev + ev @ eps  # strain probe: dE/d(eps[b,a]) = sum_e r_b f_a
        e_at = local_atomic_energy(self.spec, self.params, state.species, state.atom_mask, ev,
                                   state.edge_mask.reshape(-1), state.edge_src,
                                   lambda x: self._extend(state, x), plain=self.plain)
        if self.d3_params is not None:
            e_at = e_at + self._d3_local_energy(state, pos, ext_pos, eps)
        return e_at

    def _d3_local_energy(self, state: DistMDState, pos, ext_pos, eps):
        """D3 dispersion energy attributed to the owned receivers: CN exactly
        for the owned atoms over the local D3 list (complete, the halo spans
        the D3 cutoff), ghost CN over the exchange, pair energies with the
        1/2 double-count factor, so that the sum over all ranks is exact.
        The CN exchange's backward carries the dC6/dCN force term home
        (``kernel_get_dC6_dCNij``, ``pair_d3.cu:796``)."""
        from .. import d3 as d3mod

        p3 = self.d3_params
        NL, K3 = state.d3_edge_src.shape
        src3 = state.d3_edge_src.reshape(-1)
        dst3 = self._dst(NL, K3)
        m3 = state.d3_edge_mask.reshape(-1)
        cell_s = self._cell_t * state.cell_scale
        ev = ext_pos[src3] - pos[dst3] + state.d3_edge_shift.reshape(-1, 3) @ cell_s
        if eps is not None:
            ev = ev + ev @ eps
        em = m3.to(ev.dtype)
        unit = ev.new_tensor([1.0, 0.0, 0.0])
        r_ang = torch.linalg.vector_norm(torch.where(m3[:, None], ev, unit), dim=-1)
        z_own = torch.where(state.atom_mask, self.t2z[state.species], 0)
        z_ext = self._extend_const(state, z_own[:, None].float())[:, 0].round().long()
        zi = torch.clamp(z_own, 0, 94)[dst3]
        zj = torch.clamp(z_ext, 0, 94)[src3]
        cn_own = d3mod.d3_cn(p3, zi, zj, r_ang, em, dst3, NL)
        cn_ext = self._extend(state, cn_own[:, None])[:, 0]
        e_pair = d3mod.d3_pair_energy(p3, zi, zj, r_ang, em, cn_own[dst3], cn_ext[src3])
        e_at = torch.zeros(NL, dtype=ev.dtype, device=ev.device).index_add(0, dst3, e_pair)
        return e_at * d3mod.AU_TO_EV * state.atom_mask.to(ev.dtype)

    def _evaluate(self, state: DistMDState, virial: bool = False):
        """``(local energy sum, forces, strain-probe gradient or None)``:
        forces are ``-d(local sum)/d(positions)`` through the exchange; with
        ``virial`` the probe's gradient all-reduced over the ranks."""
        e_at, g_pos, geps = local_gradients(
            lambda pos, eps: self._local_energy(state, pos, eps), state.positions, self.halo,
            strain=virial)
        forces = -g_pos * state.atom_mask[:, None].to(g_pos.dtype)
        return e_at.double().sum(), forces, geps

    def _p_virial(self, state: DistMDState, geps) -> torch.Tensor:
        # P_virial = +trace(stress) / 3 with stress = -geps / V
        vol = self._det0 * state.cell_scale ** 3
        return -(geps[0, 0] + geps[1, 1] + geps[2, 2]) / (3.0 * vol)

    def _local_ke(self, state: DistMDState, v) -> torch.Tensor:
        m = state.masses[:, None] * state.atom_mask[:, None]
        return 0.5 * torch.sum((m * v * v).double()) / EV_A_AMU_TO_A_FS2

    def _global_ke(self, state: DistMDState, v) -> torch.Tensor:
        return self.halo.all_reduce(self._local_ke(state, v)).float()

    def _limit(self, state: DistMDState) -> torch.Tensor:
        """The skin test's limit: ``nl_limit``, and with D3 at most the
        square of half the skin (the D3 list, sized for the scale budget,
        reaches the D3 cutoff + skin), each narrowed by the cell's scale
        since the build (:func:`~sevennet_tpu_torch.md.neighbor.shrink_limit`,
        s = cell_scale / nl_scale)."""
        if state.cell_scale is state.nl_scale:
            return state.nl_limit
        scale = state.cell_scale / state.nl_scale
        limit = shrink_limit(state.nl_limit, scale, self.spec.cutoff)
        if self.d3_params is not None:
            skin_sq = torch.full_like(limit, (self.skin / 2.0) ** 2)
            limit = torch.minimum(limit, shrink_limit(skin_sq, scale,
                                                      float(self.d3_params.cutoff)))
        return limit

    def _fresh(self, state: DistMDState) -> DistMDState:
        """``state`` (at the positions where a step evaluates the forces,
        with the step's velocities), rebuilt when any rank's atom has moved
        past the limit since the last build: one all-reduce and one host
        read, which also carry whether the cell scale fell below the
        ``scale_budget`` that sized the halos (then RuntimeError, on every
        rank). A rebuild migrates atoms, so the caller reads the velocities
        and the mask back from the result."""
        disp = state.positions - state.nl_positions
        moved = (torch.sum(disp * disp, -1) * state.atom_mask > self._limit(state)).any()
        flag = torch.maximum(moved.double(), 2.0 * (state.cell_scale < self.s_min).double())
        flag = float(self.halo.all_reduce(flag, op="max"))
        if flag >= 2.0:
            raise RuntimeError(
                f"the npt cell scale {float(state.cell_scale):.6f} fell below the engine's "
                f"scale_budget {self.s_min:g}, for which the halos and cell lists were sized: "
                "build the engine with a smaller scale_budget")
        if flag > 0:
            state = self._rebuild(state)
        return state

    def _finish(self, state: DistMDState, e_loc, **upd) -> DistMDState:
        """The end of a step: one all-reduce of the energy, the kinetic
        energy and the overflow flag."""
        state = state.replace(**upd)
        vals = torch.stack([e_loc.double(), self._local_ke(state, state.velocities),
                            state.nl_overflow.double()])
        tot = self.halo.all_reduce(vals)
        return state.replace(potential_energy=tot[0].float(), kinetic_energy=tot[1].float(),
                             nl_overflow=torch.as_tensor(bool(tot[2] > 0), device=self.device))

    # ------------------------------------------------------------------
    # integrators
    # ------------------------------------------------------------------
    def _accel(self, state: DistMDState, forces):
        return (forces / state.masses[:, None] * EV_A_AMU_TO_A_FS2
                * state.atom_mask[:, None])

    def _ndof(self) -> float:
        return 3.0 * max(self.n_atoms, 1)

    def _nhc_half(self, state: DistMDState, v, thermo, dt, temperature, tau, ke=None):
        """Half-step Nose-Hoover chain (M=3) on the GLOBAL kinetic energy
        (the JAX engine's ``_nhc_half_global``): the all-reduced inputs keep
        the replicated chain identical on every rank. Returns ``(v,
        thermo)``."""
        kT = KB_EV * temperature
        ndof = self._ndof()
        ke = self._global_ke(state, v) if ke is None else ke
        Q = torch.tensor([ndof * kT * tau * tau, kT * tau * tau, kT * tau * tau],
                         dtype=v.dtype, device=v.device)
        scale, xi, vxi = _chain_half(2.0 * ke, thermo[0], thermo[1], Q, ndof * kT, kT, dt)
        return v * scale, torch.stack([xi, vxi])

    def _noise(self, state: DistMDState) -> torch.Tensor:
        """This rank's standard normal noise of the step: a generator seeded
        by (seed, rank, step)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((state.rng * 0x9E3779B97F4A7C15 + self.rank * 0x85EBCA6B
                         + state.step) % (1 << 63))
        v = state.velocities
        return torch.randn(v.shape, generator=gen, dtype=v.dtype, device=v.device)

    def _step(self, state: DistMDState, integrator: str, dt: float, kw) -> DistMDState:
        mask = state.atom_mask[:, None]
        if integrator in ("nose_hoover", "nvt"):
            v, thermo = self._nhc_half(state, state.velocities, state.thermo, dt,
                                       kw["temperature"], kw.get("tau", 50.0),
                                       ke=state.kinetic_energy)
            state = state.replace(velocities=v, thermo=thermo)
        if integrator in _NPT:
            return self._mtk_step(state, dt, kw)
        if integrator == "langevin":
            T, friction = kw["temperature"], kw.get("friction", 0.01)
            v = state.velocities + 0.5 * dt * self._accel(state, state.forces)
            x = state.positions + 0.5 * dt * v * mask
            c1 = float(np.exp(-friction * dt))
            sigma = torch.sqrt((1.0 - c1 ** 2) * KB_EV * T / state.masses) * float(
                np.sqrt(EV_A_AMU_TO_A_FS2))
            v = c1 * v + sigma[:, None] * self._noise(state)
            state = state.replace(positions=x + 0.5 * dt * v * mask)
        else:
            v = state.velocities + 0.5 * dt * self._accel(state, state.forces)
            state = state.replace(positions=state.positions + dt * v * mask)
        state = self._fresh(state.replace(velocities=v))
        v, mask = state.velocities, state.atom_mask[:, None]
        e_loc, forces, _ = self._evaluate(state)
        v = (v + 0.5 * dt * self._accel(state, forces)) * mask
        thermo = state.thermo
        if integrator in ("nose_hoover", "nvt"):
            v, thermo = self._nhc_half(state, v, thermo, dt, kw["temperature"],
                                       kw.get("tau", 50.0))
        return self._finish(state, e_loc, velocities=v, forces=forces, thermo=thermo,
                            step=state.step + 1)

    def _mtk_step(self, state: DistMDState, dt: float, kw) -> DistMDState:
        """MTK isotropic NPT with a REPLICATED barostat: every rank runs the
        same piston and chain arithmetic on the all-reduced kinetic energy
        and virial pressure (the serial twin is ``md/integrators.py:
        mtk_npt_step``; LAMMPS ``fix npt`` over the parallel pair style)."""
        T = kw["temperature"]
        pressure = kw.get("pressure", 0.0)
        tau_t, tau_p = kw.get("tau_t", 100.0), kw.get("tau_p", 1000.0)
        kT = KB_EV * T
        ndof = self._ndof()
        W = (ndof + 3.0) * kT * tau_p * tau_p
        alpha = 1.0 + 3.0 / ndof
        dt2, dt4 = dt / 2.0, dt / 4.0
        mask = state.atom_mask[:, None]

        def veps_half(v, baro, p_vir, s):
            ke2 = 2.0 * self._global_ke(state, v)
            vol = self._det0 * s ** 3
            p_int = p_vir + ke2 / (3.0 * vol)
            G = (3.0 * vol * (p_int - pressure) + (3.0 / ndof) * ke2) / W
            return torch.cat([(baro[0] + dt2 * G)[None], baro[1:]])

        def kick(v, baro, forces):
            vf = torch.exp(-dt2 * alpha * baro[0])
            sf = torch.exp(-dt4 * alpha * baro[0]) * _sinhc(dt4 * alpha * baro[0])
            return (v * vf + dt2 * self._accel(state, forces) * sf) * mask

        baro = _nhc_baro_half(state.baro, dt, T, tau_p, W)
        v, thermo = self._nhc_half(state, state.velocities, state.thermo, dt, T, tau_t,
                                   ke=state.kinetic_energy)
        baro = veps_half(v, baro, state.p_virial, state.cell_scale)
        v = kick(v, baro, state.forces)
        # the full-step drift of positions and cell under the piston
        v_eps = baro[0]
        ef = torch.exp(dt * v_eps)
        rf = torch.exp(dt2 * v_eps) * _sinhc(dt2 * v_eps)
        x = state.positions * ef + dt * v * rf
        state = self._fresh(state.replace(positions=torch.where(mask, x, state.positions),
                                          velocities=v, nl_positions=state.nl_positions * ef,
                                          cell_scale=state.cell_scale * ef))
        v, mask = state.velocities, state.atom_mask[:, None]
        baro = torch.cat([baro[:7], (baro[7] + dt * v_eps)[None]])
        e_loc, forces, geps = self._evaluate(state, virial=True)
        p_vir = self._p_virial(state, geps)
        v = kick(v, baro, forces)
        baro = veps_half(v, baro, p_vir, state.cell_scale)
        v, thermo = self._nhc_half(state, v, thermo, dt, T, tau_t)
        baro = _nhc_baro_half(baro, dt, T, tau_p, W)
        return self._finish(state, e_loc, velocities=v, forces=forces, thermo=thermo,
                            baro=baro, p_virial=p_vir, step=state.step + 1)

    # ------------------------------------------------------------------
    # public
    # ------------------------------------------------------------------
    def run(self, state: DistMDState, n_steps: int, dt: float = 1.0, chunk: int = 10,
            integrator: str = "nve", **kw):
        """``n_steps`` steps of ``integrator`` (nve | langevin |
        nose_hoover/nvt | npt; ``temperature``, and optionally ``friction``
        0.01 1/fs, ``tau`` 50 fs, ``pressure`` 0 eV/A^3, ``tau_t`` 100 fs,
        ``tau_p`` 1000 fs) on every rank together; returns ``(state, (pe,
        ke))``, the global potential and kinetic energy of every step.
        Raises ``RuntimeError`` at the end of a chunk in which a capacity
        overflowed."""
        if integrator not in INTEGRATORS:
            raise ValueError(f"unknown integrator {integrator!r}; one of {INTEGRATORS}")
        if integrator != "nve" and "temperature" not in kw:
            raise ValueError(f"integrator {integrator!r} needs temperature=")
        pes, kes = [], []
        for length in [chunk] * (n_steps // chunk) + ([n_steps % chunk] if n_steps % chunk
                                                      else []):
            for _ in range(length):
                state = self._step(state, integrator, float(dt), kw)
                pes.append(state.potential_energy)
                kes.append(state.kinetic_energy)
            if bool(state.nl_overflow):
                raise RuntimeError(
                    "distributed MD overflow: grow local/ghost/migrate capacities")
        return state, (torch.stack(pes), torch.stack(kes))

    def compute_stress(self, state: DistMDState):
        """Single point: ``(energy, stress (6,), forces (NL, 3))``: the
        global energy, the strain-probe stress (xx, yy, zz, xy, yz, zx) of
        all ranks, and this rank's forces."""
        e_loc, forces, geps = self._evaluate(state, virial=True)
        vol = self._det0 * state.cell_scale ** 3
        return self.halo.all_reduce(e_loc).float(), virial_stress(geps, vol), forces

    def gather_positions(self, state: DistMDState) -> np.ndarray:
        """Every rank's owned positions on every rank (an all-gather), in no
        particular order, as in the JAX package."""
        return self.gather(state, state.positions, ordered=False)

    def gather(self, state: DistMDState, rows: torch.Tensor, ordered: bool = True) -> np.ndarray:
        """``rows`` (per owned atom, e.g. ``state.forces``) of every rank on
        every rank; ``ordered``: in the input order of the atoms."""
        packed = torch.cat([rows.detach().double().reshape(rows.shape[0], -1),
                            state.atom_index[:, None].double()], 1)
        parts = torch.cat(self.halo.all_gather(packed)).numpy()
        parts = parts[parts[:, -1] >= 0]
        if ordered:
            parts = parts[np.argsort(parts[:, -1], kind="stable")]
        return parts[:, :-1].reshape((len(parts),) + tuple(rows.shape[1:])).astype(
            np.float32)
