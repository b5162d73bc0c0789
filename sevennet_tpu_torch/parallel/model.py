"""Distributed (domain-decomposed) energy, forces and stress on
``torch.distributed`` (the port of ``sevennet_tpu/parallel/model.py``).

Layer-synchronous halo exchange: before every convolution the owned node
features (after self-interaction 1) are shipped to the neighbours' ghost
rows (:class:`~.comm.HaloExchange`), the reference's per-segment
``forward_comm`` (``pair_e3gnn_parallel.cpp:358-390``). Each rank
differentiates only its LOCAL energy sum; the exchange's backward routes
the ghost rows' cotangents to their owners (``reverse_comm``, ``:404-441``),
and the energy and the virial are all-reduced afterwards: no collective
sits inside the differentiated sum but the exchange.

The JAX package runs the flat edge list with the XLA conv; the port
densifies each rank's edges into the ``(N_local, K)`` slot grid with
senders indexing ``[owned | ghosts]`` and runs the ext conv
(:func:`~sevennet_tpu_torch.ops.fused_conv.fused_conv_apply_ext_vec` in vec
mode, :func:`~sevennet_tpu_torch.ops.fused_conv.fused_conv_apply_ext` in
emb/sh mode), whose backward is the chunked scatter: the mirror gather
needs a symmetric list, which a domain boundary breaks.

Stress uses the strain trick: the edge vectors are strained by a zero
``(3, 3)`` probe ``eps`` and ``dE/d(eps)`` is the virial (the reference's
``EdgePreprocess`` strain, ``sevenn/nn/edge_embedding.py:34-61``).
:func:`local_atomic_energy` is the layer loop of this module and of the
distributed MD engine (:mod:`.md`), the exchange given as an argument.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.graph import densify_edges
from ..device import resolve_device
from ..model.build import ModelSpec
from ..model.model import _vec_mode, conv_row_chunk, edge_emb_sh, edge_embed_spec, params_to
from ..ops.fused_conv import fused_conv_apply_ext, fused_conv_apply_ext_vec
from ..ops.gate import gate_apply
from ..ops.linear import linear_apply
from ..ops.mlp import scalar_mlp_apply
from ..ops.tensor_product import fctp_apply
from .comm import Halo, HaloExchange

__all__ = ["distributed_compute", "make_distributed_compute", "dd_to_device_arrays",
           "local_atomic_energy", "check_spec"]


def check_spec(spec: ModelSpec):
    """Distributed runs serve single-fidelity models, as the JAX package's
    layer loop does (it appends no modality one-hot)."""
    if spec.num_modalities > 1:
        raise ValueError("distributed MD serves single-fidelity models: the layer loop "
                         "appends no modality one-hot (nor does the JAX package's)")


def local_atomic_energy(
    spec: ModelSpec,
    params: Dict,
    species: torch.Tensor,
    atom_mask: torch.Tensor,
    ev: torch.Tensor,
    edge_mask: torch.Tensor,
    src_nk: torch.Tensor,
    extend: Callable[[torch.Tensor], torch.Tensor],
    *,
    plain: bool,
) -> torch.Tensor:
    """Masked atomic energies ``(NL,)`` of a rank's owned atoms.

    ``ev (NL*K, 3)``: the edge vectors of the receiver-major slot grid (any
    value on masked slots); ``src_nk (NL, K)``: senders in ``[owned |
    ghosts]``; ``extend(x)``: ``x`` of the owned rows with the ghost rows
    appended, through the halo exchange. ``plain=True`` runs the conv's
    plain version, else the ext conv's kernels (their plain twins on CPU
    tensors)."""
    NL, K = src_nk.shape
    dtype = ev.dtype
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], dtype=dtype, device=ev.device)
    ev3 = torch.where(edge_mask[:, None], ev, sentinel).T.contiguous()
    coef = params["edge_embedding"]["bessel_coeffs"]
    vec_mode = _vec_mode(spec)
    if not vec_mode:
        emb, sh = edge_emb_sh(spec, coef, ev3, edge_mask)
        emb_nk, sh_nk = emb.view(NL, K, -1), sh.view(NL, K, -1)

    onehot = F.one_hot(species, spec.num_species).to(dtype)
    x = linear_apply(spec.embed_linear, params["onehot_to_feature_x"], onehot)
    for layer in spec.layers:
        t = layer.t
        if layer.sc_type == "nequip":
            sc = fctp_apply(layer.sc_fctp, params[f"{t}_self_connection_intro"], x, onehot)
        elif layer.sc_type == "linear":
            sc = linear_apply(layer.sc_linear, params[f"{t}_self_connection_intro"], x)
        else:
            sc = None
        x1 = linear_apply(layer.si1, params[f"{t}_self_interaction_1"], x)
        x_ext = extend(x1)
        conv_p = params[f"{t}_convolution"]
        row_chunk = conv_row_chunk(spec, NL, K, layer.conv.irreps_x.dim)
        if vec_mode:
            xc = fused_conv_apply_ext_vec(
                layer.conv, layer.radial_mlp, conv_p["weight_nn"], coef,
                edge_embed_spec(spec, layer), x_ext, ev3, src_nk, plain=plain,
                row_chunk=row_chunk)
        else:
            xc = fused_conv_apply_ext(
                layer.conv, layer.radial_mlp, conv_p["weight_nn"], x_ext, emb_nk, sh_nk, src_nk,
                plain=plain, row_chunk=row_chunk)
        xc = xc / conv_p["denominator"][0]
        xc = linear_apply(layer.si2, params[f"{t}_self_interaction_2"], xc)
        if sc is not None:
            xc = xc + sc
        x = gate_apply(layer.gate, xc)

    if spec.readout_as_fcn:
        e_scaled = scalar_mlp_apply(spec.readout_fcn, params["readout_FCN"], x)
    else:
        h = linear_apply(spec.readout1, params["reduce_input_to_hidden"], x)
        e_scaled = linear_apply(spec.readout2, params["reduce_hidden_to_energy"], h)
    e_scaled = e_scaled[:, 0]
    rs = params["rescale_atomic_energy"]
    if spec.rescale_mode == "species":
        shift, scale = rs["shift"][species], rs["scale"][species]
    else:
        shift, scale = rs["shift"][0], rs["scale"][0]
    return (e_scaled * scale + shift) * atom_mask.to(dtype)


def virial_stress(geps: torch.Tensor, volume) -> torch.Tensor:
    """Stress (xx, yy, zz, xy, yz, zx) from the strain probe's gradient
    ``geps[b, a] = sum_e r_b f_a`` (the model's convention)."""
    return -torch.stack([geps[0, 0], geps[1, 1], geps[2, 2],
                         geps[0, 1], geps[1, 2], geps[2, 0]]) / volume


def local_gradients(energy_of: Callable, pos: torch.Tensor, halo, strain: bool):
    """Differentiate this rank's LOCAL energy sum: ``energy_of(pos, eps)``
    gives the masked atomic energies of the owned atoms, ``eps`` the zero
    strain probe (None without ``strain``). Returns ``(atomic energies,
    d(sum)/d(pos), d(sum)/d(eps) all-reduced or None)``: the edge vectors
    are local, so the per-rank virials add up exactly."""
    pos = pos.detach().requires_grad_(True)
    eps = (torch.zeros((3, 3), dtype=pos.dtype, device=pos.device, requires_grad=True)
           if strain else None)
    with torch.enable_grad():
        e_at = energy_of(pos, eps)
        grads = torch.autograd.grad(e_at.sum(), (pos, eps) if strain else (pos,))
    return e_at.detach(), grads[0], halo.all_reduce(grads[1]) if strain else None


def dd_to_device_arrays(dd) -> Dict[str, np.ndarray]:
    """DomainDecomposition -> dict of stacked per-rank arrays, with ghost
    species precomputed on the host (species are static; only features and
    positions are exchanged at run time)."""
    D = dd.n_devices
    gl = dd.n_ghost_left_cap
    ghost_species = np.zeros((D, dd.n_ghost_cap), np.int32)
    for d in range(D):
        left_src = (d - 1) % D
        right_src = (d + 1) % D
        ls = dd.species[left_src][dd.send_idx_right[left_src]]
        ls = np.where(dd.send_mask_right[left_src], ls, 0)
        rs = dd.species[right_src][dd.send_idx_left[right_src]]
        rs = np.where(dd.send_mask_left[right_src], rs, 0)
        ghost_species[d, : len(ls)] = ls
        ghost_species[d, gl : gl + len(rs)] = rs
    return {
        "positions": dd.positions.astype(np.float32),
        "species": dd.species,
        "atom_mask": dd.atom_mask,
        "send_idx_left": dd.send_idx_left,
        "send_mask_left": dd.send_mask_left,
        "send_idx_right": dd.send_idx_right,
        "send_mask_right": dd.send_mask_right,
        "ghost_shift": dd.ghost_shift.astype(np.float32),
        "ghost_mask": dd.ghost_mask,
        "ghost_species": ghost_species,
        "edge_src": dd.edge_src,
        "edge_dst": dd.edge_dst,
        "edge_shift": dd.edge_shift.astype(np.float32),
        "edge_mask": dd.edge_mask,
    }


def make_distributed_compute(spec: ModelSpec, group=None, device: Optional[str] = None,
                             fused: Optional[bool] = None):
    """Returns ``fn(params, dd_arrays, cell)`` -> this rank's ``{energy ()
    (all ranks' sum), atomic_energy (N_cap,), forces (N_cap, 3), stress
    (6,) (all ranks')}``, run by every rank of ``group`` (the default
    group; one rank per slab of the decomposition) on ``device`` (``cuda``
    unless ``"cpu"``). ``fused``: the ext conv's kernels (default on
    ``cuda``) or, with False (default on the CPU), its plain version."""
    check_spec(spec)
    dev = resolve_device(device)
    plain = not (dev.type == "cuda" if fused is None else fused)

    def fn(params, dd_arrays, cell):
        D = dd_arrays["positions"].shape[0]
        halo = Halo((D,), dev, group)
        r = halo.rank
        params = params_to(params, dev)

        def put(key, dtype):
            return torch.as_tensor(np.asarray(dd_arrays[key][r]), device=dev).to(dtype)

        NL = dd_arrays["positions"].shape[1]
        src, dst = dd_arrays["edge_src"][r], dd_arrays["edge_dst"][r]
        shift, emask = dd_arrays["edge_shift"][r], dd_arrays["edge_mask"][r]
        order = np.argsort(np.where(emask, dst, NL), kind="stable")
        src, dst, shift, emask = src[order], dst[order], shift[order], emask[order]
        counts = np.bincount(dst[emask], minlength=NL)
        K = max(int(counts.max(initial=0)), 1)
        src_d, dst_d, shift_d, mask_d = densify_edges(src, dst, shift, emask, NL, K)

        cell_t = torch.as_tensor(np.asarray(cell, np.float32), device=dev)
        maps = (put("send_idx_left", torch.int64), put("send_mask_left", torch.bool),
                put("send_idx_right", torch.int64), put("send_mask_right", torch.bool))
        atom_mask = put("atom_mask", torch.bool)
        src_t = torch.as_tensor(src_d, device=dev).long()
        dst_t = torch.as_tensor(dst_d, device=dev).long()
        shift_t = torch.as_tensor(shift_d, device=dev)
        mask_t = torch.as_tensor(mask_d, device=dev)

        def extend(x):
            return HaloExchange.apply(x, halo, 0, *maps)

        ghost_off = put("ghost_shift", torch.float32) @ cell_t
        species = put("species", torch.int64)

        def energy_of(pos, eps):
            ext_pos = extend(pos) + torch.cat([torch.zeros_like(pos), ghost_off])
            ev = ext_pos[src_t] - pos[dst_t] + shift_t @ cell_t
            ev = ev + ev @ eps
            return local_atomic_energy(spec, params, species, atom_mask, ev, mask_t,
                                       src_t.view(NL, K), extend, plain=plain)

        e_atoms, g_pos, g_eps = local_gradients(energy_of, put("positions", torch.float32),
                                                halo, strain=True)
        energy = halo.all_reduce(e_atoms.double().sum()).float()
        volume = torch.abs(torch.linalg.det(cell_t))
        return {
            "energy": energy,
            "atomic_energy": e_atoms,
            "forces": -g_pos * atom_mask[:, None].to(g_pos.dtype),
            "stress": virial_stress(g_eps, volume),
        }

    return fn


def distributed_compute(spec: ModelSpec, params, dd, group=None, device: Optional[str] = None,
                        fused: Optional[bool] = None):
    """Partition -> per-rank arrays -> this rank's compute (every rank of
    ``group`` calls it with the same ``dd``, which each computes on its
    host: the partition itself is not sent)."""
    fn = make_distributed_compute(spec, group, device, fused)
    return fn(params, dd_to_device_arrays(dd), dd.cell)
