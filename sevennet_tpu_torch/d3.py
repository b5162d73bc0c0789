"""Grimme D3 dispersion correction (BJ and zero damping), the PyTorch port
of ``sevennet_tpu/d3.py``.

The same physics as the reference's CUDA implementation
(``sevenn/pair_e3gnn/pair_d3.cu``, exposed to ASE through ctypes in
``sevenn/calculator.py:317-618``):

- fractional coordination numbers ``CN_i = sum_j 1/(1+exp(-K1((4/3)
  (rcov_i+rcov_j)/r - 1)))`` (``kernel_get_coordination_number``,
  ``pair_d3.cu:1035``);
- C6 from Gaussian-weighted interpolation over Grimme's reference points
  (``get_dC6_dCNij``, ``:796``; the derivative here comes from autograd);
- E = -1/2 sum_ij [ s6 C6 f6(r) + s8 C8 f8(r) ], BJ damping
  ``f_n = r^n/(r^n + (a1 sqrt(C8/C6) + a2)^n)`` or zero damping;
- forces and virial from the gradient of the energy in the edge vectors.

The functions take tensors on any device and work in their dtype (fp32 on
the main path, as the JAX package). Parameter tables are this package's own
copy, ``d3data/d3_params.npz``.

:func:`d3_compute` walks the edge list in chunks sized from a byte budget
(:data:`CHUNK_BYTES`), so that its memory stays bounded whatever the edge
count; the chunks never change the function. It runs in three passes, as
the reference's CUDA does in three kernels: the coordination numbers; each
chunk's pair energy with its gradients in the edge vectors and in the CN of
both ends; the CN's edge terms chained with the summed ``dE/dCN``. Its
per-atom and total sums accumulate in float64 (each edge's terms stay in
the input dtype).

Masked edges may carry anything (the MD engine's dense slot grid has empty
slots and rows of padded atoms with Z = 0, where the C6 fallback's softmax
over no valid reference is NaN). Their inputs are replaced by a harmless
pair before the math, so that no NaN is formed and then multiplied by 0.

Units: inputs in Angstrom, outputs in eV (eV/A for forces).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device

__all__ = [
    "D3Params", "d3_cn", "d3_pair_energy", "d3_energy", "d3_compute", "bounded_cutoff",
    "D3Calculator", "FUNCTIONAL_PARAMS_BJ", "FUNCTIONAL_PARAMS_ZERO", "CHUNK_BYTES",
]

AU_TO_ANG = 0.52917726
AU_TO_EV = 27.21138505
K1 = 16.0
K3 = -4.0
# byte budget of one chunk's temporaries in d3_compute, and their bytes per
# edge for a 4-byte float (the saved (5, 5) blocks and their gradients:
# 1.3 KB an edge at the peak of a 192-atom request on an H100)
CHUNK_BYTES = 2 << 30
EDGE_BYTES = 1536
# the pair that masked edges compute instead of theirs: H-H at 1 A
_SAFE_Z = 1

# (rs6/a1, s18/s8, rs18/a2) per functional, BJ damping (s6 = 1 unless noted);
# values from the standard dftd3 parameterization (reference setfuncpar_bj)
FUNCTIONAL_PARAMS_BJ: Dict[str, Tuple[float, float, float, float]] = {
    # name: (s6, a1, s8, a2)
    "pbe": (1.0, 0.4289, 0.7875, 4.4407),
    "pbe0": (1.0, 0.4145, 1.2177, 4.8593),
    "pbesol": (1.0, 0.4466, 2.9491, 6.1742),
    "revpbe": (1.0, 0.5238, 2.3550, 3.5016),
    "rpbe": (1.0, 0.1820, 0.8318, 4.0094),
    "b-lyp": (1.0, 0.4298, 2.6996, 4.2359),
    "b-p": (1.0, 0.3946, 3.2822, 4.8516),
    "b3-lyp": (1.0, 0.3981, 1.9889, 4.4211),
    "tpss": (1.0, 0.4535, 1.9435, 4.4752),
    "hf": (1.0, 0.3385, 0.9171, 2.8830),
    "hse06": (1.0, 0.383, 2.310, 5.685),
    "scan": (1.0, 0.538, 0.0, 5.42),
    "r2scan": (1.0, 0.4948, 0.7898, 5.7308),
    "b97-d": (1.0, 0.5545, 2.2609, 3.2297),
}

# zero damping: (s6, rs6, s18) with rs18=1, alp=14
FUNCTIONAL_PARAMS_ZERO: Dict[str, Tuple[float, float, float]] = {
    "pbe": (1.0, 1.217, 0.722),
    "pbe0": (1.0, 1.287, 0.928),
    "revpbe": (1.0, 0.923, 1.010),
    "b-lyp": (1.0, 1.094, 1.682),
    "b3-lyp": (1.0, 1.261, 1.703),
    "tpss": (1.0, 1.166, 1.105),
    "hf": (1.0, 1.158, 1.746),
}


@lru_cache(maxsize=1)
def _load_tables() -> Dict[str, np.ndarray]:
    path = os.path.join(os.path.dirname(__file__), "d3data", "d3_params.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


_TABLES: Dict[tuple, Dict[str, torch.Tensor]] = {}


def _tables(device, dtype) -> Dict[str, torch.Tensor]:
    """The tables as tensors of ``dtype`` on ``device`` (cached)."""
    key = (str(device), dtype)
    if key not in _TABLES:
        _TABLES[key] = {k: torch.as_tensor(v, device=device).to(dtype)
                        for k, v in _load_tables().items()}
    return _TABLES[key]


@dataclass(frozen=True)
class D3Params:
    s6: float
    s8: float
    a1: float  # rs6 for zero damping
    a2: float  # rs18 for zero damping
    damping: str = "bj"  # 'bj' | 'zero'
    alp: float = 14.0
    cutoff: float = float(np.sqrt(9000.0) * AU_TO_ANG)  # ~50 A
    cn_cutoff: float = float(np.sqrt(1600.0) * AU_TO_ANG)  # ~21 A

    @staticmethod
    def from_functional(name: str, damping: str = "bj") -> "D3Params":
        name = name.lower()
        if damping in ("bj", "damp_bj"):
            s6, a1, s8, a2 = FUNCTIONAL_PARAMS_BJ[name]
            return D3Params(s6=s6, s8=s8, a1=a1, a2=a2, damping="bj")
        s6, rs6, s18 = FUNCTIONAL_PARAMS_ZERO[name]
        return D3Params(s6=s6, s8=s18, a1=rs6, a2=1.0, damping="zero")


def _safe(zi, zj, r_ang, em):
    """The inputs of masked edges (``em == 0``) replaced by a pair with valid
    references at a finite distance: their terms are then finite, and the
    mask makes them (and their gradients) zero."""
    live = em > 0
    return (torch.where(live, zi, _SAFE_Z), torch.where(live, zj, _SAFE_Z),
            torch.where(live, r_ang, 1.0))


def _edge_inputs(numbers, edge_dst, edge_src, edge_vec, edge_mask):
    """``(zi, zj, r_ang, em)`` of the edges: the atomic numbers of both ends
    (clipped to the tables), the length of each edge (1 A for masked ones)
    and the mask in the vectors' dtype."""
    z = torch.clamp(numbers, 0, 94)
    unit = edge_vec.new_tensor([1.0, 0.0, 0.0])
    r_ang = torch.linalg.vector_norm(torch.where(edge_mask[:, None], edge_vec, unit), dim=-1)
    return z[edge_dst], z[edge_src], r_ang, edge_mask.to(edge_vec.dtype)


def _cn_terms(params: D3Params, zi, zj, r_ang, em):
    """Each edge's term of its receiver's coordination number."""
    rcov = _tables(r_ang.device, r_ang.dtype)["rcov"]  # a.u., index z-1
    zi, zj, r_safe = _safe(zi, zj, r_ang, em)
    r = r_safe / AU_TO_ANG
    rco = rcov[zi - 1] + rcov[zj - 1]  # already scaled by 4/3
    damp_cn = 1.0 / (1.0 + torch.exp(-K1 * (rco / r - 1.0)))
    return damp_cn * em * (r_ang < params.cn_cutoff)


def d3_cn(params: D3Params, zi, zj, r_ang, em, edge_dst, n):
    """Fractional coordination numbers by receiver
    (``kernel_get_coordination_number``, ``pair_d3.cu:1035``)."""
    cn = r_ang.new_zeros(n)
    return cn.index_add(0, edge_dst, _cn_terms(params, zi, zj, r_ang, em))


def d3_pair_energy(params: D3Params, zi, zj, r_ang, em, cni, cnj):
    """Per-edge D3 energy (a.u., with the 1/2 double-count factor) given
    CN values for both edge ends. Differentiable in ``r_ang`` and the CN
    inputs (the CN dependence carries the dC6/dCN force contribution,
    ``kernel_get_dC6_dCNij``, ``pair_d3.cu:796``)."""
    t = _tables(r_ang.device, r_ang.dtype)
    zi, zj, r_safe = _safe(zi, zj, r_ang, em)
    r = r_safe / AU_TO_ANG

    refs_c6 = t["c6ab_c6"][zi, zj]  # (E, 5, 5)
    refs_cn1 = t["c6ab_cn1"][zi, zj]
    refs_cn2 = t["c6ab_cn2"][zi, zj]
    valid = refs_c6 > -0.5
    d2 = (refs_cn1 - cni[:, None, None]) ** 2 + (refs_cn2 - cnj[:, None, None]) ** 2
    w = torch.where(valid, torch.exp(K3 * d2), 0.0)
    wsum = torch.sum(w, dim=(1, 2))
    # guard: if all weights underflow, fall back to the closest reference.
    # The floor must keep wsum**2 representable in fp32 (the quotient-rule
    # backward divides by it): 1e-30 underflowed to 0 -> NaN forces.
    big = torch.where(valid, -d2, -torch.inf)
    fallback = torch.softmax(big.reshape(big.shape[0], -1) * 1e3, dim=-1)
    w_flat = torch.where(
        (wsum > 1e-15)[:, None],
        w.reshape(w.shape[0], -1) / torch.clamp(wsum, min=1e-15)[:, None],
        fallback,
    )
    c6 = torch.sum(w_flat * refs_c6.reshape(refs_c6.shape[0], -1), dim=-1)  # a.u.

    r2r4 = t["r2r4"]
    r42 = r2r4[zi - 1] * r2r4[zj - 1]
    c8 = 3.0 * c6 * r42

    r2 = r * r
    r6 = r2 * r2 * r2
    r8 = r6 * r2
    within = em * (r_ang < params.cutoff)

    if params.damping == "bj":
        rr = params.a1 * torch.sqrt(3.0 * r42) + params.a2
        rr2 = rr * rr
        rr6 = rr2 * rr2 * rr2
        rr8 = rr6 * rr2
        e6 = c6 / (r6 + rr6)
        e8 = c8 / (r8 + rr8)
    else:  # zero damping
        r0 = t["r0ab"][zi - 1, zj - 1] / AU_TO_ANG
        t6 = (r / (params.a1 * r0)) ** (-params.alp)
        f6 = 1.0 / (1.0 + 6.0 * t6)
        t8 = (r / (params.a2 * r0)) ** (-(params.alp + 2.0))
        f8 = 1.0 / (1.0 + 6.0 * t8)
        e6 = f6 * c6 / r6
        e8 = f8 * c8 / r8

    return -0.5 * (params.s6 * e6 + params.s8 * e8) * within


def d3_energy(params: D3Params, numbers, edge_dst, edge_src, edge_vec,
              edge_mask) -> torch.Tensor:
    """Total D3 energy (eV) over a padded full edge list, in one pass.

    ``numbers`` (N,) atomic numbers (padding zeros allowed); ``edge_dst``
    receiver i, ``edge_src`` sender j (both (i,j) and (j,i) present; pair
    terms carry a 1/2 factor); ``edge_vec`` (E, 3) r_j - r_i in Angstrom;
    ``edge_mask`` (E,). Differentiable in ``edge_vec`` by autograd."""
    zi, zj, r_ang, em = _edge_inputs(numbers, edge_dst, edge_src, edge_vec, edge_mask)
    cn = d3_cn(params, zi, zj, r_ang, em, edge_dst, numbers.shape[0])
    e_pair = d3_pair_energy(params, zi, zj, r_ang, em, cn[edge_dst], cn[edge_src])
    return torch.sum(e_pair) * AU_TO_EV


def chunk_edges(dtype: torch.dtype) -> int:
    """Edges per chunk of :func:`d3_compute` under :data:`CHUNK_BYTES`."""
    return max(1, CHUNK_BYTES // (EDGE_BYTES * torch.finfo(dtype).bits // 32))


def _accumulate(forces, v6, dst, src, ev, g):
    """Adds the edge gradients ``g = dE/d(edge_vec)`` to the forces (the
    receiver gets +g, the sender -g) and to the summed 6-virial terms, in
    the accumulators' dtype."""
    g = g.to(forces.dtype)
    forces.index_add_(0, dst, g)
    forces.index_add_(0, src, -g)
    v6 += torch.cat([ev * g, ev[:, [0, 1, 2]] * g[:, [1, 2, 0]]], dim=1).sum(0)


def d3_compute(params: D3Params, numbers, dst, src, ev, emask, chunk: Optional[int] = None):
    """Energy (eV), per-atom forces (eV/A) and 6-virial (model order
    xx,yy,zz,xy,yz,zx; eV) from a padded full edge list: the gradient of
    :func:`d3_energy` in the edge vectors (the reference computes the same
    derivatives by hand in ``kernel_get_forces_with_dC6``,
    ``pair_d3.cu:1783``), in chunks of ``chunk`` edges (default: from
    :data:`CHUNK_BYTES`). Every edge's terms are computed in the vectors'
    dtype; the per-atom and total sums (CN, dE/dCN, forces, energy,
    virial) accumulate in float64, then return in that dtype: an atom's
    force sums tens of thousands of edge terms at the full cutoff, whose
    fp32 atomic sums in no fixed order would differ between runs and chunk
    sizes by more than the terms' own rounding."""
    n, n_edges = numbers.shape[0], dst.shape[0]
    step = chunk or chunk_edges(ev.dtype)
    spans = [(a, min(a + step, n_edges)) for a in range(0, n_edges, step)]
    dtype, acc = ev.dtype, torch.float64
    ev = ev.detach()

    def inputs(a, b, vec):
        return _edge_inputs(numbers, dst[a:b], src[a:b], vec, emask[a:b])

    # pass 1: coordination numbers
    cn = ev.new_zeros(n, dtype=acc)
    with torch.no_grad():
        for a, b in spans:
            cn.index_add_(0, dst[a:b], _cn_terms(params, *inputs(a, b, ev[a:b])).to(acc))
    cn = cn.to(dtype)
    energy = ev.new_zeros((), dtype=acc)
    dcn = ev.new_zeros(n, dtype=acc)  # dE/dCN
    forces = ev.new_zeros((n, 3), dtype=acc)
    v6 = ev.new_zeros(6, dtype=acc)
    # pass 2: pair energies, their gradients in the vectors and in both CNs
    for a, b in spans:
        vec = ev[a:b].detach().requires_grad_(True)
        cni = cn[dst[a:b]].requires_grad_(True)
        cnj = cn[src[a:b]].requires_grad_(True)
        with torch.enable_grad():
            e_pair = d3_pair_energy(params, *inputs(a, b, vec), cni, cnj) * AU_TO_EV
            g, g_i, g_j = torch.autograd.grad(e_pair.sum(), (vec, cni, cnj))
        energy += e_pair.detach().sum(dtype=acc)
        dcn.index_add_(0, dst[a:b], g_i.to(acc))
        dcn.index_add_(0, src[a:b], g_j.to(acc))
        _accumulate(forces, v6, dst[a:b], src[a:b], ev[a:b], g)
    # pass 3: the CN's edge terms chained with dE/dCN of their receiver
    dcn = dcn.to(dtype)
    for a, b in spans:
        vec = ev[a:b].detach().requires_grad_(True)
        with torch.enable_grad():
            t = torch.sum(_cn_terms(params, *inputs(a, b, vec)) * dcn[dst[a:b]])
            (g,) = torch.autograd.grad(t, vec)
        _accumulate(forces, v6, dst[a:b], src[a:b], ev[a:b], g)
    return energy.to(dtype), forces.to(dtype), (-v6).to(dtype)


def bounded_cutoff(params: D3Params, cell, pbc) -> float:
    """OPT-IN pair-cutoff bound for periodic boxes: three box heights
    (never below the CN cutoff). Truncates the lattice sum relative to
    dftd3's fixed ~50 A cutoff; the MD engine uses it, the default
    calculator keeps the full cutoff so that its values match the
    reference's CUDA D3 goldens
    (``tests/unit_tests/test_calculator.py:192-231``)."""
    if cell is None or not np.asarray(pbc).any():
        return params.cutoff
    inv = np.linalg.inv(np.asarray(cell, np.float64))
    heights = 1.0 / np.linalg.norm(inv.T, axis=1)
    return float(min(params.cutoff, max(3.0 * heights.max(), params.cn_cutoff)))


class D3Calculator:
    """Standalone ASE-style D3 calculator (the analogue of the reference's
    ``D3Calculator``, ``sevenn/calculator.py:387-618``). Builds the full
    edge list on the host (:func:`~sevennet_tpu_torch.data.neighborlist.
    neighbor_list_numpy`) at the full cutoff, or at :func:`bounded_cutoff`
    with ``bound_by_box``; runs :func:`d3_compute` on ``cuda`` unless
    ``device="cpu"``, in ``dtype`` (float32, as the JAX package; float64
    for a reference)."""

    def __init__(self, functional: str = "pbe", damping_type: str = "damp_bj",
                 cutoff_ang: Optional[float] = None, bound_by_box: bool = False,
                 device: Optional[str] = None, dtype: torch.dtype = torch.float32):
        damping = "bj" if "bj" in damping_type else "zero"
        p = D3Params.from_functional(functional, damping)
        if cutoff_ang is not None:
            p = D3Params(s6=p.s6, s8=p.s8, a1=p.a1, a2=p.a2, damping=p.damping,
                         alp=p.alp, cutoff=cutoff_ang, cn_cutoff=min(p.cn_cutoff, cutoff_ang))
        self.params = p
        self.bound_by_box = bound_by_box
        self.device = resolve_device(device)
        self.dtype = dtype
        self.results: Dict = {}

    def edges(self, atoms):
        """``(numbers, dst, src, edge_vec, mask)`` of one structure on the
        calculator's device: the host list and its vectors (float64 on the
        host, then ``dtype``)."""
        from .atoms import as_atoms
        from .data.neighborlist import neighbor_list_numpy

        at = as_atoms(atoms)
        cutoff = (bounded_cutoff(self.params, at.cell, at.pbc)
                  if self.bound_by_box else self.params.cutoff)
        dst, src, S = neighbor_list_numpy(at.positions, cutoff, at.cell, at.pbc)
        ev = at.positions[src] - at.positions[dst]
        if at.cell is not None:
            ev = ev + S @ at.cell
        dev = self.device
        return (torch.as_tensor(np.asarray(at.numbers, np.int64), device=dev),
                torch.as_tensor(dst, device=dev), torch.as_tensor(src, device=dev),
                torch.as_tensor(ev, device=dev).to(self.dtype),
                torch.ones(len(dst), dtype=torch.bool, device=dev))

    def calculate(self, atoms) -> dict:
        from .atoms import as_atoms

        at = as_atoms(atoms)
        e, forces, virial = d3_compute(self.params, *self.edges(at))
        results = {
            "energy": float(e),
            "free_energy": float(e),
            "forces": forces.cpu().numpy(),
        }
        if at.cell is not None and at.pbc.any():
            s = virial.cpu().numpy() / max(at.volume(), 1e-3)
            results["stress"] = -s[[0, 1, 2, 4, 5, 3]]  # ASE voigt
        self.results = results
        return results
