"""Model forward (energy) and its derivatives on the dense fused-conv path
(PyTorch port of ``sevennet_tpu/model/model.py:342-564``).

Forces and stress are gradients of the energy with respect to the edge
vectors, as the reference's ``ForceStressOutputFromEdge``
(``sevenn/nn/force_output.py:139-230``). The edges form the dense ``(N, K)``
receiver-major slot grid with a mirror index; the convolution is the fused
conv (:mod:`sevennet_tpu_torch.ops.fused_conv`), whose forward and backward
run hand-written kernels on the card: in vec mode (:func:`_vec_mode`) on
the edge vectors, otherwise on an embedding and spherical harmonics
computed here in plain PyTorch.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..data.graph import GraphBatch
from ..device import resolve_device
from ..ops.fused_conv import (
    EdgeEmbedSpec,
    chunk_threshold,
    fused_conv_apply,
    fused_conv_apply_vec,
)
from ..ops.gate import gate_apply
from ..ops.linear import linear_apply
from ..ops.mlp import scalar_mlp_apply
from ..ops.radial import bessel_basis, poly_cutoff, xplor_cutoff
from ..ops.tensor_product import fctp_apply
from ..so3.spherical import spherical_harmonics
from .build import ModelSpec

__all__ = ["model_energy", "model_compute", "params_to", "edge_emb_sh", "conv_row_chunk",
           "graph_modality"]


def edge_embed_spec(spec: ModelSpec, layer) -> EdgeEmbedSpec:
    kind, arg = spec.cutoff_fn
    return EdgeEmbedSpec(
        n_basis=layer.radial_mlp.dims[0],
        cutoff=float(spec.cutoff),
        cutoff_kind=str(kind),
        cutoff_arg=float(arg),
        lmax=int(spec.lmax_edge),
    )


def params_to(params, device: torch.device):
    """The parameter dictionary with every tensor on ``device``."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params


def _vec_mode(spec: ModelSpec) -> bool:
    """Vec-mode fused conv: the kernels compute the Bessel basis, envelope
    and spherical harmonics from the raw edge vectors. It needs normalized
    spherical harmonics (the reference default; checkpoints older than
    SevenNet 0.10 have them off). ``SEVENNET_TPU_VEC=0`` selects the emb/sh
    conv for any model. The JAX package's rule
    (``sevennet_tpu/model/model.py:70-81``), whose ``conv_fused`` the port
    does not read: it always runs the fused conv."""
    if not spec.normalize_sph:
        return False
    return bool(int(os.environ.get("SEVENNET_TPU_VEC", 1)))


def graph_modality(spec: ModelSpec, graph: GraphBatch) -> torch.Tensor:
    """The modality index of every graph slot of a multi-fidelity model:
    the spec's pinned modality (:func:`~sevennet_tpu_torch.scripts.
    modal_tools.select_modality`) over ``graph.modal`` over 0, as
    ``sevennet_tpu/model/model.py:394-402`` chooses it."""
    if spec.pinned_modal >= 0 or graph.modal is None:
        fill = max(spec.pinned_modal, 0)
        return torch.full((graph.n_graphs_cap,), fill, dtype=torch.int64, device=graph.device)
    return graph.modal.long()


def edge_emb_sh(spec: ModelSpec, coef, ev3, edge_mask):
    """Emb/sh mode: ``emb (N*K, n_basis)``, zero on padded slots, and
    ``sh (N*K, dim_f)`` of the (sentinel-guarded) edge vectors ``ev3 (3,
    N*K)``, in plain PyTorch (``sevennet_tpu/model/model.py:379-390``)."""
    ev = ev3.T
    r = torch.linalg.vector_norm(ev, dim=-1)
    kind, arg = spec.cutoff_fn
    if kind == "poly_cut":
        env = poly_cutoff(r, spec.cutoff, p=int(arg))
    else:
        env = xplor_cutoff(r, spec.cutoff, arg)
    emb = bessel_basis(r, coef, spec.cutoff) * (env * edge_mask.to(ev.dtype))[:, None]
    sh = spherical_harmonics(spec.lmax_edge, ev, normalize=spec.normalize_sph)
    return emb, sh


def graph_sum(batch: torch.Tensor, values: torch.Tensor, n_graphs: int) -> torch.Tensor:
    """Per-graph sums of per-atom ``values`` (rows by ``batch``), in the
    values' dtype but accumulated in float64: ``index_add`` on CUDA adds
    atomically in no fixed order, and in fp32 the rounding of 100k adds
    into one graph reaches about 1e-5 of the sum (0.7 eV of a 99,999-atom
    water box's 47,547 eV between two runs)."""
    out = torch.zeros((n_graphs,) + values.shape[1:], dtype=torch.float64, device=values.device)
    return out.index_add(0, batch, values.double()).to(values.dtype)


def conv_row_chunk(spec: ModelSpec, n_atoms: int, K: int, dim_x: int) -> int:
    """Row chunk of one conv layer: ``spec.edge_chunk // K`` rows when the
    spec asks for edge chunks and the layer's gathered edge tensor ``(N*K,
    dim_x)`` would pass :func:`chunk_threshold`, else 0 (unchunked). The
    rule of ``sevennet_tpu/model/model.py:116-147``."""
    if spec.edge_chunk and n_atoms * K * dim_x * 4 > chunk_threshold():
        return spec.edge_chunk // K
    return 0


def model_energy(
    spec: ModelSpec,
    params: Dict[str, Any],
    graph: GraphBatch,
    edge_vec3: torch.Tensor,
    plain: bool = False,
) -> Dict[str, torch.Tensor]:
    """Per-atom and per-graph energies from explicit ``(3, N*K)`` edge
    vectors. ``plain=True`` runs the convolution's plain PyTorch version.
    The conv runs in vec mode or, when :func:`_vec_mode` says no, in emb/sh
    mode. A layer whose :func:`conv_row_chunk` is set runs the chunked
    backward (the ring one when ``spec.conv_ring`` is set), in either
    mode."""
    dtype = edge_vec3.dtype
    K = graph.dense_k
    n_atoms = graph.n_atoms_cap
    # padded slots get a sentinel vector past the cutoff: the clamped
    # envelope zeroes their messages and gradients
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], dtype=dtype, device=edge_vec3.device)
    ev3 = torch.where(graph.edge_mask[None, :], edge_vec3, sentinel[:, None])
    coef = params["edge_embedding"]["bessel_coeffs"]
    src_nk = graph.edge_src.view(n_atoms, K)
    mir_nk = graph.edge_mir.view(n_atoms, K)
    vec_mode = _vec_mode(spec)
    if not vec_mode:
        emb, sh = edge_emb_sh(spec, coef, ev3, graph.edge_mask)
        emb_nk, sh_nk = emb.view(n_atoms, K, -1), sh.view(n_atoms, K, -1)

    onehot = F.one_hot(graph.species, spec.num_species).to(dtype)
    # multi-fidelity: the per-atom modality one-hot appended to the inputs of
    # the linears the spec names (sevennet_tpu/model/model.py:394-413)
    if spec.num_modalities > 1:
        modal = graph_modality(spec, graph)
        modal_oh = F.one_hot(modal, spec.num_modalities).to(dtype)[graph.batch]

    def with_modal(name, v):
        if spec.num_modalities > 1 and name in spec.modal_linears:
            return torch.cat([v, modal_oh], dim=-1)
        return v

    x = linear_apply(spec.embed_linear, params["onehot_to_feature_x"],
                     with_modal("onehot_to_feature_x", onehot))
    for layer in spec.layers:
        t = layer.t
        if layer.sc_type == "nequip":
            sc = fctp_apply(layer.sc_fctp, params[f"{t}_self_connection_intro"], x, onehot)
        elif layer.sc_type == "linear":
            sc = linear_apply(layer.sc_linear, params[f"{t}_self_connection_intro"], x)
        else:
            sc = None
        x = linear_apply(layer.si1, params[f"{t}_self_interaction_1"],
                         with_modal(f"{t}_self_interaction_1", x))
        conv_p = params[f"{t}_convolution"]
        row_chunk = conv_row_chunk(spec, n_atoms, K, layer.conv.irreps_x.dim)
        if vec_mode:
            x = fused_conv_apply_vec(
                layer.conv, layer.radial_mlp, conv_p["weight_nn"], coef,
                edge_embed_spec(spec, layer), x, ev3, src_nk, mir_nk, plain=plain,
                row_chunk=row_chunk, ring=spec.conv_ring,
            )
        else:
            x = fused_conv_apply(layer.conv, layer.radial_mlp, conv_p["weight_nn"], x,
                                 emb_nk, sh_nk, src_nk, mir_nk, plain=plain,
                                 row_chunk=row_chunk, ring=spec.conv_ring)
        x = x / conv_p["denominator"][0]
        x = linear_apply(layer.si2, params[f"{t}_self_interaction_2"],
                         with_modal(f"{t}_self_interaction_2", x))
        if sc is not None:
            x = x + sc
        x = gate_apply(layer.gate, x)

    if spec.readout_as_fcn:
        e_scaled = scalar_mlp_apply(spec.readout_fcn, params["readout_FCN"], x)
    else:
        h = linear_apply(spec.readout1, params["reduce_input_to_hidden"],
                         with_modal("reduce_input_to_hidden", x))
        e_scaled = linear_apply(spec.readout2, params["reduce_hidden_to_energy"], h)
    e_scaled = e_scaled[:, 0]

    rs = params["rescale_atomic_energy"]
    if spec.rescale_mode == "modal":
        # modal-wise shift and scale, (modalities, species) where the spec
        # says so, per species otherwise (sevennet_tpu/model/model.py:480-498)
        m_atom = graph_modality(spec, graph)[graph.batch]
        shift = (rs["shift"][m_atom, graph.species] if spec.use_modal_wise_shift
                 else rs["shift"][graph.species])
        scale = (rs["scale"][m_atom, graph.species] if spec.use_modal_wise_scale
                 else rs["scale"][graph.species])
    elif spec.rescale_mode == "species":
        shift, scale = rs["shift"][graph.species], rs["scale"][graph.species]
    else:
        shift, scale = rs["shift"][0], rs["scale"][0]
    e_atom = (e_scaled * scale + shift) * graph.atom_mask.to(dtype)
    e_graph = graph_sum(graph.batch, e_atom, graph.n_graphs_cap) * graph.graph_mask.to(dtype)
    return {"atomic_energy": e_atom, "energy": e_graph}


def model_compute(
    spec: ModelSpec,
    params: Dict[str, Any],
    graph: GraphBatch,
    compute_stress: bool = True,
    device: Optional[str] = None,
    plain: bool = False,
    create_graph: bool = False,
) -> Dict[str, torch.Tensor]:
    """Energy, forces, stress and atomic virial of a dense-layout graph.

    Forces: ``F_i = sum_{e: dst=i} f_e - sum_{e: src=i} f_e`` with
    ``f_e = dE/d(edge_vec_e)``; the sender-side sums go through the mirror
    index. Per-atom virial at the sender, stress ``virial / V`` in the
    reference Voigt order (xx, yy, zz, xy, yz, zx). Runs on ``cuda`` unless
    ``device="cpu"``; ``plain=True`` uses the conv's plain version.

    ``create_graph=True`` (training) keeps the autograd graph: every output
    is a differentiable function of the parameters, forces and stress
    through the conv's differentiable backward (the second derivative a
    force or stress loss needs, which the JAX package gets by composing
    ``jax.grad``). Otherwise the outputs are detached. The chunked and ring
    conv of large systems are first order only: ``create_graph=True`` with a
    layer that :func:`conv_row_chunk` chunks raises."""
    dev = resolve_device(device)
    if graph.device != dev:
        graph = graph.to(dev)
    params = params_to(params, dev)
    if graph.dense_k <= 0 or graph.edge_mir is None:
        raise ValueError("model_compute needs a dense graph with a mirror index")
    n, K = graph.n_atoms_cap, graph.dense_k
    if create_graph and not plain and any(
            conv_row_chunk(spec, n, K, layer.conv.irreps_x.dim) for layer in spec.layers):
        raise NotImplementedError(
            "the chunked and ring conv backward have no second derivative (nor has the JAX "
            "package's): train on smaller structures, with _edge_chunk: 0, or with a larger "
            "SEVENNET_TPU_CHUNK_THRESHOLD")
    ev3 = graph.edge_vectors().T.contiguous().detach().requires_grad_(True)
    with torch.enable_grad():
        out = model_energy(spec, params, graph, ev3, plain=plain)
        (fij3,) = torch.autograd.grad(out["energy"].sum(), ev3, create_graph=create_graph)
    if not create_graph:
        out = {k: v.detach() for k, v in out.items()}
    ev3 = ev3.detach()
    mir = graph.edge_mir
    pf3 = fij3.reshape(3, n, K).sum(2)
    nf3 = fij3[:, mir].reshape(3, n, K).sum(2)
    am = graph.atom_mask.to(fij3.dtype)
    out["forces"] = ((pf3 - nf3) * am[None, :]).T

    if compute_stress:
        r0, r1, r2 = ev3[0], ev3[1], ev3[2]
        f0, f1, f2 = fij3[0], fij3[1], fij3[2]
        v6 = torch.stack([r0 * f0, r1 * f1, r2 * f2, r0 * f1, r1 * f2, r2 * f0])
        # per-atom virial at the SENDER: the src-side sum via the mirror rows
        atomic_virial = (-v6[:, mir].reshape(6, n, K).sum(2)).T
        virial_graph = graph_sum(graph.batch, atomic_virial, graph.n_graphs_cap)
        out["atomic_virial"] = atomic_virial
        out["stress"] = virial_graph / graph.volume[:, None]
    return out
