"""Import weights from the reference's frozen TorchScript deployments (the
port's copy of ``sevennet_tpu/io/torchscript_import.py``).

The reference deploys LAMMPS models as *frozen* TorchScript
(``sevenn/scripts/deploy.py:16-178``): ``torch.jit.freeze`` inlines every
parameter as a ``prim::Constant`` of the graph, so ``state_dict()`` is
empty. This module recovers the parameters from the frozen constants (in
the order of their first use, which for e3nn's generated code is the
modules' execution order) and rebuilds the architecture by matching the
constants' shapes against a grid of candidate model specs.

Constants, by kind:
- 0-dim scalars: activation ``normalize2mom`` factors, masking fills; not
  parameters, skipped.
- 3-D tensors of odd dimensions equal to a Wigner 3j table (up to sign):
  the tensor products' tables, skipped (kept for pre-0.11 sign fixes).
- ``(1,)`` tensors: the conv denominators (equal values pooled into one
  constant by freezing) and the final scale and shift.
- everything else: weights, consumed in execution order.

The state dict recovered is the one the JAX importer recovers, bit for
bit; the parameters are the port's CPU fp32 tensors.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..model.build import build_model_spec
from ..so3.wigner import real_wigner_3j
from .torch_checkpoint import (
    _version_lt,
    params_from_torch_state_dict,
    patch_old_config,
    sort_old_conv_weights,
    spec_config_from_checkpoint,
)

__all__ = ["load_deployed_model", "deployed_metadata"]

_METADATA_KEYS = (
    "chemical_symbols_to_index",
    "cutoff",
    "num_species",
    "model_type",
    "version",
    "dtype",
    "time",
    "comm_size",
)

# the architecture axes the metadata does not record, searched by
# load_deployed_model
_GRID = (
    ("num_convolution_layer", tuple(range(2, 7))),
    ("lmax", (1, 2, 3)),
    ("is_parity", (True, False)),
    ("self_connection_type", ("nequip", "linear")),
    ("_full_last_layer", (False, True)),
)


def deployed_metadata(path: str) -> Dict[str, str]:
    """The deployment's ``_extra_files`` entries that are present."""
    ef = {k: b"" for k in _METADATA_KEYS}
    torch.jit.load(path, map_location="cpu", _extra_files=ef)
    return {k: v.decode() for k, v in ef.items() if v}


def _scalar_of(node):
    """Float value if ``node`` is a scalar constant producer, else None."""
    if node.kind() != "prim::Constant":
        return None
    try:
        v = node.outputsAt(0).toIValue()
    except Exception:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    return None


def _find_explicit_scale(node, depth=0):
    """Explicit scalar multiplier on the data input of a weight-consuming op.

    e3nn's generated code leaves the path normalization as an
    ``aten::mul(x, alpha)`` on the *input* for some instruction kinds and
    folds it into the weight for others (where freezing bakes it in). The
    explicit part is found here; the importer divides the rest out of the
    constant (see ``_try_match``).
    """
    if depth > 3:
        return None
    if node.kind() == "aten::mul":
        for inp in node.inputs():
            s = _scalar_of(inp.node())
            if s is not None:
                return s
            try:
                v = inp.node().outputsAt(0).toIValue()
            except Exception:
                v = None
            if v is not None and hasattr(v, "numel") and v.numel() == 1:
                return float(v)
        return None
    if node.kind() in ("aten::einsum",):
        for inp in node.inputs():
            if inp.node().kind() == "prim::ListConstruct":
                for el in inp.node().inputs():
                    s = _find_explicit_scale(el.node(), depth + 1)
                    if s is not None:
                        return s
        return None
    return None


def _ordered_constants(module) -> List[Tuple[np.ndarray, float]]:
    """(tensor, explicit scale) for every tensor constant of the frozen
    graph, ordered by first consumer (the modules' execution order). Only
    the graph's top-level nodes are walked, not nested blocks."""
    g = module.graph
    const_vals = {}
    for n in g.nodes():
        if n.kind() == "prim::Constant":
            out = n.outputsAt(0)
            if out.type().kind() == "TensorType":
                t = out.toIValue()
                if t is not None and t.numel() > 0 and t.dim() > 0:
                    const_vals[out.debugName()] = t.detach().cpu().numpy()

    seen = set()
    ordered: List[Tuple[np.ndarray, float]] = []
    for n in g.nodes():
        for inp in n.inputs():
            dn = inp.debugName()
            if dn in const_vals and dn not in seen:
                seen.add(dn)
                scale = 1.0
                # the data operand rides the sibling input of this consumer
                for sib in n.inputs():
                    if sib.debugName() == dn:
                        continue
                    s = _find_explicit_scale(sib.node())
                    if s is not None:
                        scale = s
                        break
                ordered.append((const_vals[dn], scale))
    return ordered


def _is_w3j(t: np.ndarray) -> bool:
    """True when ``t`` matches a Wigner 3j table (up to overall sign)."""
    if t.ndim != 3 or any(d % 2 == 0 for d in t.shape):
        return False
    ls = tuple((d - 1) // 2 for d in t.shape)
    try:
        ref = np.asarray(real_wigner_3j(*ls), dtype=np.float64)
    except Exception:
        return False
    if ref.shape != t.shape:
        return False
    td = t.astype(np.float64)
    return bool(np.allclose(ref, td, atol=1e-5) or np.allclose(ref, -td, atol=1e-5))


def _lin_entry(key, lspec):
    return (key, lspec.weight_shapes, "flat", [a for _, _, a in lspec.instructions])


def _fctp_entry(key, fspec):
    # operand 2 is the species one-hot (0e): the trivial w3j(l, 0, l) table
    # contributes 1/sqrt(2l+1), so T = pw/sqrt(dim_out) = 1/sqrt(fan)
    Ts = [pw / np.sqrt(fspec.irreps_out[io].ir.dim) for (_, _, io, pw) in fspec.instructions]
    return (key, fspec.weight_shapes, "flat", Ts)


def _expected_entries(spec):
    """(state-dict key, [path shapes], kind, [path norms T]) in deployed
    execution order. The frozen constant of a path equals
    ``raw_weight * T / s``, where s is the explicit scalar left in the code
    (``_find_explicit_scale``); the walk recovers raw = const * s / T.
    """
    yield ("edge_embedding.basis_function.coeffs", [(spec.radial_basis_num,)], "raw", [1.0])
    yield _lin_entry("onehot_to_feature_x.linear.weight", spec.embed_linear)
    for L in spec.layers:
        t = L.t
        if L.sc_type == "nequip":
            yield _fctp_entry(f"{t}_self_connection_intro.fc_tensor_product.weight", L.sc_fctp)
        elif L.sc_type == "linear":
            yield _lin_entry(f"{t}_self_connection_intro.linear.weight", L.sc_linear)
        yield _lin_entry(f"{t}_self_interaction_1.linear.weight", L.si1)
        dims = L.radial_mlp.dims
        for i in range(len(dims) - 1):
            # e3nn's FullyConnectedNet divides by sqrt(fan_in) at run time;
            # freezing folds that into the constant
            yield (f"{t}_convolution.weight_nn.layer{i}.weight", [(dims[i], dims[i + 1])],
                   "flat2d", [1.0 / np.sqrt(dims[i])])
        yield (f"{t}_convolution.denominator", [(1,)], "denom", [1.0])
        yield _lin_entry(f"{t}_self_interaction_2.linear.weight", L.si2)
    yield _lin_entry("reduce_input_to_hidden.linear.weight", spec.readout1)
    yield _lin_entry("reduce_hidden_to_energy.linear.weight", spec.readout2)
    yield ("rescale_atomic_energy.scale", [(1,)], "rescale", [1.0])
    yield ("rescale_atomic_energy.shift", [(1,)], "rescale", [1.0])


def _try_match(spec, consts) -> Optional[Dict[str, np.ndarray]]:
    """Walk the expected parameter sequence against the constant stream.

    ``consts``: list of ``(tensor, explicit_scale)``. Each path constant is
    brought to checkpoint form by ``raw = const * (s / T)``. Returns a
    reference-layout flat state dict, or None on a mismatch. Denominators
    that freezing pooled into one constant (equal values) are restored to
    every layer.
    """
    sd: Dict[str, np.ndarray] = {}
    pos = 0
    first_denom: Optional[np.ndarray] = None

    def _peek():
        return consts[pos][0] if pos < len(consts) else None

    for key, shapes, kind, Ts in _expected_entries(spec):
        if kind == "denom":
            nxt = _peek()
            if (nxt is not None and nxt.shape == (1,)
                    and (first_denom is None or not np.array_equal(nxt, first_denom))):
                sd[key] = nxt
                pos += 1
            elif first_denom is not None:
                sd[key] = first_denom  # the pooled constant
            else:
                return None
            if first_denom is None:
                first_denom = sd[key]
            continue
        parts = []
        for shape, T in zip(shapes, Ts):
            nxt = _peek()
            if kind == "rescale" and nxt is not None and nxt.ndim == 1:
                shape = nxt.shape  # a species-wise (n,) rescale
            if nxt is None or nxt.shape != tuple(shape):
                return None
            s = consts[pos][1]
            if kind in ("flat", "flat2d"):
                nxt = nxt * (s / T)
            parts.append(nxt)
            pos += 1
        if kind == "flat":
            sd[key] = np.concatenate([p.reshape(-1) for p in parts])
        else:
            sd[key] = parts[0]
    if pos != len(consts):
        return None
    return sd


def load_deployed_model(path: str, return_state: bool = False,
                        config: Optional[Dict[str, Any]] = None):
    """Frozen deployed ``.pt`` -> ``(spec, params)``, the parameters as the
    port's CPU fp32 tensors (hand them to
    :class:`~sevennet_tpu_torch.calculator.SevenNetCalculator`); with
    ``return_state`` also the config and the reference-layout state dict.

    The hyperparameters the ``_extra_files`` metadata does not carry
    (layer count, lmax, parity, self-connection type, a full last layer)
    are recovered by matching the constants' shapes over a grid of 120
    candidates; exactly one may match, else ``ValueError``. ``config``
    gives model-config keys the artifact cannot tell (``irreps_manual``,
    ``cutoff_function``, ...; SevenNet-0's deployment needs both): they
    join the inferred config, and a key of the grid given there fixes that
    axis. Without it the search is the JAX importer's.
    """
    meta = deployed_metadata(path)
    module = torch.jit.load(path, map_location="cpu")
    consts, w3j_consts = [], {}
    for t, s in _ordered_constants(module):
        if _is_w3j(t):
            ls = tuple((d - 1) // 2 for d in t.shape)
            w3j_consts[ls] = t
        else:
            consts.append((t, s))

    shapes = [c[0].shape for c in consts]
    bessel_num = int(shapes[0][0])
    channel = int(shapes[1][1])
    symbols = meta["chemical_symbols_to_index"].split()

    # radial-MLP hidden widths: the first chain of constants from
    # (bessel_num, h) after the embedding linear (misread when the channel
    # count equals bessel_num, as in the JAX importer)
    hidden: List[int] = []
    for i in range(2, len(shapes) - 1):
        if len(shapes[i]) == 2 and shapes[i][0] == bessel_num:
            j = i
            while len(shapes[j + 1]) == 2 and shapes[j + 1][0] == shapes[j][1]:
                hidden.append(int(shapes[j][1]))
                j += 1
            break
    if not hidden:
        hidden = [64, 64]

    # the readout's hidden width from the hidden->energy linear, (hidden, 1)
    readout_hidden = int(shapes[-3][0]) if len(shapes[-3]) == 2 else 0

    base_cfg: Dict[str, Any] = {
        "chemical_species": symbols,
        "cutoff": float(meta["cutoff"]),
        "channel": channel,
        "radial_basis": {"radial_basis_name": "bessel", "bessel_basis_num": bessel_num},
        "weight_nn_hidden_neurons": hidden,
        "_readout_hidden_mul": readout_hidden,
        "version": meta.get("version", "0.0.0"),
    }
    given = dict(config or {})
    base_cfg.update({k: v for k, v in given.items() if k not in dict(_GRID)})
    base_cfg = patch_old_config(base_cfg)
    base_cfg.pop("version", None)

    keys = [k for k, _ in _GRID]
    axes = [(given[k],) if k in given else values for k, values in _GRID]
    matches = []
    for values in itertools.product(*axes):
        cfg = dict(base_cfg, **dict(zip(keys, values)))
        try:
            spec = build_model_spec(cfg)
        except Exception:
            continue
        sd = _try_match(spec, consts)
        if sd is not None:
            matches.append((cfg, sd))
    if not matches:
        raise ValueError(f"no architecture candidate matches the constant stream of {path}")
    if len(matches) > 1:
        raise ValueError(
            f"ambiguous architecture for {path}: "
            f"{[{k: m[0][k] for k in ('num_convolution_layer', 'lmax', 'is_parity', 'self_connection_type')} for m in matches]}"
        )
    cfg, sd = matches[0]
    cfg = spec_config_from_checkpoint(cfg, sd)
    spec = build_model_spec(cfg)
    if _version_lt(str(meta.get("version", "0.0.0")), (0, 11, 0)):
        # frozen weights are in the tensor products' construction order;
        # the artifact's w3j tables give each path's sign convention
        for L in spec.layers:
            for (l1, l2, l3), tab in w3j_consts.items():
                sd.setdefault(
                    f"{L.t}_convolution.convolution._compiled_main_left_right._w3j_{l1}_{l2}_{l3}",
                    tab)
        sd = sort_old_conv_weights(spec, sd)
    params = params_from_torch_state_dict(spec, sd)
    if return_state:
        return spec, params, cfg, sd
    return spec, params
