"""Load stock SevenNet torch checkpoints (``.pth``) into the port (the
PyTorch counterpart of ``sevennet_tpu/io/torch_checkpoint.py``).

The reference checkpoint layout (``sevenn/train/trainer.py:194-214``) is a
dict with ``model_state_dict`` / ``config`` / optimizer state. Layer names in
the state dict (``0_self_interaction_1.linear.weight`` ...) map 1:1 onto the
parameter tree's keys; flat e3nn weight vectors are unpacked into
per-instruction matrices (:func:`~sevennet_tpu_torch.ops.linear.linear_unpack`).
Checkpoints older than SevenNet 0.10 load as models with unnormalized
spherical harmonics (:func:`patch_old_config`), which the port serves and
trains through its emb/sh conv.

The JAX package's msgpack checkpoints are read by
:mod:`~sevennet_tpu_torch.io.native_checkpoint` and pretrained model names
resolved by :mod:`~sevennet_tpu_torch.io.registry`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from ..model.build import ModelSpec, build_model_spec
from ..ops.linear import LinearSpec, linear_pack, linear_unpack
from ..so3.wigner import real_wigner_3j
from .convert import params_from_numpy

__all__ = [
    "patch_old_state_dict",
    "patch_old_config",
    "sort_old_conv_weights",
    "spec_config_from_checkpoint",
    "params_from_torch_state_dict",
    "state_dict_from_params",
    "load_sevennet_checkpoint",
]


def _to_numpy_state_dict(sd) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def patch_old_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Legacy layer-name compatibility (reference
    ``scripts/backward_compatibility.py:43-77``): pre-2024 checkpoints used
    spaces in module names and 'denumerator' for the conv denominator."""
    ren = {
        "EdgeEmbedding": "edge_embedding",
        "reducing nn input to hidden": "reduce_input_to_hidden",
        "reducing nn hidden to energy": "reduce_hidden_to_energy",
        "rescale atomic energy": "rescale_atomic_energy",
    }
    for i in range(10):
        ren[f"{i} self connection intro"] = f"{i}_self_connection_intro"
        ren[f"{i} self interaction 1"] = f"{i}_self_interaction_1"
        ren[f"{i} convolution"] = f"{i}_convolution"
        ren[f"{i} self interaction 2"] = f"{i}_self_interaction_2"
        ren[f"{i} equivariant gate"] = f"{i}_equivariant_gate"
    out = {}
    for k, v in sd.items():
        head, _, tail = k.partition(".")
        tail = tail.replace("denumerator", "denominator")
        out[ren.get(head, head) + ("." + tail if tail else "")] = v
    return out


def patch_old_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Legacy config-key compatibility (reference
    ``scripts/backward_compatibility.py:18-41``): a config of version 0.9 or
    older gets ``_normalize_sph = False`` unless it says otherwise."""
    cfg = dict(config)
    version = str(cfg.get("version", "0.10.0"))
    try:
        major, minor = (int(x) for x in version.split(".")[:2])
    except ValueError:
        major, minor = 0, 10
    if major == 0 and minor <= 9:
        cf = cfg.get("cutoff_function")
        if isinstance(cf, dict) and cf.get("cutoff_function_name") == "XPLOR":
            cf = dict(cf)
            cf.pop("poly_cut_p_value", None)
            cfg["cutoff_function"] = cf
        if "train_denominator" not in cfg:
            cfg["train_denominator"] = cfg.pop("train_avg_num_neigh", False)
        if cfg.pop("optimize_by_reduce", None) is False:
            raise ValueError(
                "checkpoint with optimize_by_reduce=False is no longer "
                "supported (matches the reference's policy)"
            )
        cfg.setdefault("conv_denominator", 0.0)
        cfg.setdefault("_normalize_sph", False)
    return cfg


def sort_old_conv_weights(spec: ModelSpec, sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Permute pre-v0.11 convolution weights into sorted-instruction order.

    Reference checkpoints older than 0.11 store the radial-MLP output
    columns in TP *construction* order; newer code (and the port) uses
    instructions sorted by output block. The reference permutes (and
    sign-fixes w3j-flipped paths) at load time
    (``sevenn/scripts/backward_compatibility.py:79-160``); this is the same
    patch. Sign fixes compare any stored ``_w3j_{l1}_{l2}_{l3}`` buffers
    against the port's Wigner tables and flip the corresponding weight
    columns, so results are invariant to the checkpoint's CG sign convention.
    """
    sd = dict(sd)
    for layer in spec.layers:
        t = layer.t
        conv = layer.conv
        if tuple(i[:3] for i in conv.instructions) == tuple(conv.instructions_enum):
            continue  # orders coincide; nothing to do
        n_last = len(layer.radial_mlp.dims) - 2
        key = f"{t}_convolution.weight_nn.layer{n_last}.weight"
        ww = np.asarray(sd[key])
        blocks: Dict[Tuple[int, int, int], np.ndarray] = {}
        off = 0
        for (i, j, k) in conv.instructions_enum:
            mul = conv.irreps_x[i].mul * conv.irreps_filter[j].mul
            blk = ww[:, off : off + mul]
            l1 = conv.irreps_x[i].ir.l
            l2 = conv.irreps_filter[j].ir.l
            l3 = conv.irreps_mid[k].ir.l
            if l1 > 0 and l2 > 0 and l3 > 0:
                bkey = (
                    f"{t}_convolution.convolution._compiled_main_left_right."
                    f"_w3j_{l1}_{l2}_{l3}"
                )
                if bkey in sd:
                    mine = np.asarray(real_wigner_3j(l1, l2, l3))
                    stored = np.asarray(sd[bkey], dtype=np.float64)
                    if not np.allclose(stored, mine, atol=1e-6):
                        if not np.allclose(stored, -mine, atol=1e-6):
                            raise ValueError(f"stored w3j {bkey} matches neither sign")
                        blk = -blk
            blocks[(i, j, k)] = blk
            off += mul
        if off != ww.shape[1]:
            raise ValueError(f"{key}: {ww.shape[1]} columns, the instructions need {off}")
        sd[key] = np.concatenate(
            [blocks[ins[:3]] for ins in conv.instructions], axis=1
        )
    return sd


def spec_config_from_checkpoint(config: Dict[str, Any], sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Extract a numeric model config: string placeholders like
    'avg_num_neigh' shift/scale are replaced by the resolved values stored in
    the state dict (mirrors reference continue semantics,
    ``scripts/processing_continue.py:43-55``)."""
    cfg = dict(config)
    shift = sd["rescale_atomic_energy.shift"]
    scale = sd["rescale_atomic_energy.scale"]
    cfg["shift"] = shift.tolist() if shift.size > 1 else float(shift.reshape(-1)[0])
    cfg["scale"] = scale.tolist() if scale.size > 1 else float(scale.reshape(-1)[0])
    nconv = int(cfg["num_convolution_layer"])
    cfg["conv_denominator"] = [
        float(sd[f"{t}_convolution.denominator"].reshape(-1)[0]) for t in range(nconv)
    ]
    return cfg


def params_from_torch_state_dict(spec: ModelSpec, sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """A reference-layout state dict of numpy arrays -> the port's parameter
    tree of CPU fp32 tensors (every key and shape checked against ``spec``)."""

    def _lin(name: str, lspec: LinearSpec):
        bias = sd.get(f"{name}.linear.bias")
        if bias is not None and bias.size == 0:
            bias = None
        return linear_unpack(lspec, sd[f"{name}.linear.weight"], bias)

    def _mlp(prefix: str, n: int):
        ws = []
        while f"{prefix}{len(ws)}.weight" in sd:
            ws.append(np.asarray(sd[f"{prefix}{len(ws)}.weight"]))
        if len(ws) != n:
            raise ValueError(f"{prefix}*: {len(ws)} weights, expected {n}")
        return ws

    tree: Dict[str, Any] = {
        "edge_embedding": {"bessel_coeffs": np.asarray(sd["edge_embedding.basis_function.coeffs"])},
        "onehot_to_feature_x": _lin("onehot_to_feature_x", spec.embed_linear),
    }
    for layer in spec.layers:
        t = layer.t
        if layer.sc_type == "nequip":
            flat = sd[f"{t}_self_connection_intro.fc_tensor_product.weight"]
            ws, off = [], 0
            for shape in layer.sc_fctp.weight_shapes:
                n = int(np.prod(shape))
                ws.append(np.asarray(flat[off : off + n]).reshape(shape))
                off += n
            if off != flat.size:
                raise ValueError(f"FCTP weight numel mismatch at layer {t}")
            tree[f"{t}_self_connection_intro"] = {"w": ws}
        elif layer.sc_type == "linear":
            tree[f"{t}_self_connection_intro"] = _lin(f"{t}_self_connection_intro", layer.sc_linear)
        tree[f"{t}_self_interaction_1"] = _lin(f"{t}_self_interaction_1", layer.si1)
        tree[f"{t}_convolution"] = {
            "weight_nn": {"w": _mlp(f"{t}_convolution.weight_nn.layer",
                                    len(layer.radial_mlp.dims) - 1)},
            "denominator": np.asarray(sd[f"{t}_convolution.denominator"]).reshape(-1),
        }
        tree[f"{t}_self_interaction_2"] = _lin(f"{t}_self_interaction_2", layer.si2)

    if spec.readout_as_fcn:
        tree["readout_FCN"] = {"w": _mlp("readout_FCN.fcn.layer", len(spec.readout_fcn.dims) - 1)}
    else:
        tree["reduce_input_to_hidden"] = _lin("reduce_input_to_hidden", spec.readout1)
        tree["reduce_hidden_to_energy"] = _lin("reduce_hidden_to_energy", spec.readout2)
    tree["rescale_atomic_energy"] = {
        "shift": np.asarray(sd["rescale_atomic_energy.shift"]).reshape(-1),
        "scale": np.asarray(sd["rescale_atomic_energy.scale"]).reshape(-1),
    }
    return params_from_numpy(spec, tree)


def state_dict_from_params(spec: ModelSpec, params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_torch_state_dict`: the port's parameter
    tree as a reference-layout flat state dict of numpy arrays
    (``0_self_interaction_1.linear.weight`` keys, e3nn flat weight
    vectors)."""

    def arr(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)

    sd: Dict[str, np.ndarray] = {
        "edge_embedding.basis_function.coeffs": arr(params["edge_embedding"]["bessel_coeffs"]),
    }

    def _lin(name: str, lspec, p):
        sd[f"{name}.linear.weight"] = linear_pack(lspec, {"w": [arr(w) for w in p["w"]]})

    _lin("onehot_to_feature_x", spec.embed_linear, params["onehot_to_feature_x"])
    for layer in spec.layers:
        t = layer.t
        if layer.sc_type == "nequip":
            sd[f"{t}_self_connection_intro.fc_tensor_product.weight"] = np.concatenate(
                [arr(w).reshape(-1) for w in params[f"{t}_self_connection_intro"]["w"]])
        elif layer.sc_type == "linear":
            _lin(f"{t}_self_connection_intro", layer.sc_linear,
                 params[f"{t}_self_connection_intro"])
        _lin(f"{t}_self_interaction_1", layer.si1, params[f"{t}_self_interaction_1"])
        for i, w in enumerate(params[f"{t}_convolution"]["weight_nn"]["w"]):
            sd[f"{t}_convolution.weight_nn.layer{i}.weight"] = arr(w)
        sd[f"{t}_convolution.denominator"] = arr(
            params[f"{t}_convolution"]["denominator"]).reshape(())
        _lin(f"{t}_self_interaction_2", layer.si2, params[f"{t}_self_interaction_2"])
    if spec.readout_as_fcn:
        for i, w in enumerate(params["readout_FCN"]["w"]):
            sd[f"readout_FCN.fcn.layer{i}.weight"] = arr(w)
    else:
        _lin("reduce_input_to_hidden", spec.readout1, params["reduce_input_to_hidden"])
        _lin("reduce_hidden_to_energy", spec.readout2, params["reduce_hidden_to_energy"])
    sd["rescale_atomic_energy.shift"] = arr(params["rescale_atomic_energy"]["shift"])
    sd["rescale_atomic_energy.scale"] = arr(params["rescale_atomic_energy"]["scale"])
    return sd


def _version_lt(version: str, ref: Tuple[int, int, int]) -> bool:
    try:
        parts = tuple(int(x) for x in version.split(".")[:3])
    except ValueError:
        return True
    return parts < ref


def load_sevennet_checkpoint(path: str) -> Tuple[ModelSpec, Dict[str, Any]]:
    """Read a stock SevenNet ``.pth`` checkpoint -> ``(spec, params)``, the
    parameters as the port's tree of CPU fp32 tensors (hand them to
    :class:`~sevennet_tpu_torch.calculator.SevenNetCalculator`)."""
    import torch

    cp = torch.load(path, map_location="cpu", weights_only=False)
    sd = patch_old_state_dict(_to_numpy_state_dict(cp["model_state_dict"]))
    cfg = spec_config_from_checkpoint(patch_old_config(cp["config"]), sd)
    spec = build_model_spec(cfg)
    if _version_lt(str(cp["config"].get("version", "0.0.0")), (0, 11, 0)):
        sd = sort_old_conv_weights(spec, sd)
    return spec, params_from_torch_state_dict(spec, sd)
