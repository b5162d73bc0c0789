"""Modality surgery on a multi-fidelity model: append a modality, or pin one
for serving (the port's copy of ``sevennet_tpu/scripts/modal_tools.py``;
reference ``sevenn/scripts/convert_model_modality.py`` and
``checkpoint.append_modal``, ``sevenn/checkpoint.py:458-584``).

Modal weights are extra rows in the affected linears' weight matrices (the
modality 0e block, the last input block) and extra rows of the modal-wise
shift and scale. Appending a modality copies an existing modality's rows as
the new one's start. Both functions take the model's config dict and the
port's parameter tree (:func:`~sevennet_tpu_torch.io.convert.params_from_numpy`)
and return new ones; the inputs are left as they are.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import torch

from ..model.build import ModelSpec, build_model_spec

__all__ = ["append_modality", "select_modality"]


def _modal_block_indices(spec_linear, num_modalities: int):
    """Indices of the instructions that read the modal 0e block (the last
    input block by construction; it may feed several scalar output
    blocks)."""
    cands = [
        idx for idx, (i_in, _, _) in enumerate(spec_linear.instructions)
        if spec_linear.irreps_in[i_in].ir.l == 0
        and spec_linear.irreps_in[i_in].mul == num_modalities
        and i_in == len(spec_linear.irreps_in) - 1
    ]
    if not cands:
        raise ValueError("no instruction reads a modality block")
    return cands


def _find_linear(spec: ModelSpec, name: str):
    if name == "onehot_to_feature_x":
        return spec.embed_linear
    if name == "reduce_input_to_hidden":
        return spec.readout1
    for layer in spec.layers:
        if name == f"{layer.t}_self_interaction_1":
            return layer.si1
        if name == f"{layer.t}_self_interaction_2":
            return layer.si2
    raise KeyError(name)


def append_modality(model_config: Dict[str, Any], params: Dict[str, Any], new_modal: str,
                    copy_from: int = 0) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(config, params)`` with the modality ``new_modal`` appended, its
    weights and modal-wise shift and scale copied from modality
    ``copy_from``. Where a linear's fan-in grows, its weights are scaled so
    that each path's ``alpha * w`` stays as it was (the reference's
    ``convert_model_modality.py:59``)."""
    cfg = copy.deepcopy(model_config)
    if not cfg.get("use_modality"):
        raise ValueError("not a multi-fidelity model")
    old_m = int(cfg["num_modalities"])
    cfg["num_modalities"] = old_m + 1
    mm = dict(cfg.get("modal_map") or {})
    if new_modal in mm:
        raise ValueError(f"modality {new_modal} exists already")
    mm[new_modal] = old_m
    cfg["modal_map"] = mm

    old_spec = build_model_spec(model_config)
    # the config's modal-wise shift and scale rows, one more
    for key, flag in (("shift", old_spec.use_modal_wise_shift),
                      ("scale", old_spec.use_modal_wise_scale)):
        v = cfg.get(key)
        if flag and isinstance(v, (list, tuple)) and v and isinstance(v[0], (list, tuple)):
            v = [list(r) for r in v]
            v.append(list(v[copy_from]))
            cfg[key] = v
    new_spec = build_model_spec(cfg)

    new_params = copy.deepcopy(params)
    for name in old_spec.modal_linears:
        old_lin, new_lin = _find_linear(old_spec, name), _find_linear(new_spec, name)
        modal_ins = set(_modal_block_indices(old_lin, old_m))
        ws = []
        for idx, ((_, _, a_old), (_, _, a_new)) in enumerate(
                zip(old_lin.instructions, new_lin.instructions)):
            w = torch.as_tensor(params[name]["w"][idx])
            if idx in modal_ins:
                w = torch.cat([w, w[copy_from:copy_from + 1]], 0)
            ws.append(w * (a_old / a_new))
        new_params[name]["w"] = ws

    rs = new_params["rescale_atomic_energy"]
    for key, flag in (("shift", old_spec.use_modal_wise_shift),
                      ("scale", old_spec.use_modal_wise_scale)):
        arr = torch.as_tensor(rs[key])
        if flag and arr.dim() == 2 and arr.shape[0] == old_m:
            rs[key] = torch.cat([arr, arr[copy_from:copy_from + 1]], 0)
    return cfg, new_params


def select_modality(model_config: Dict[str, Any], params: Dict[str, Any],
                    modal: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(config, params)`` of the model serving modality ``modal``: the
    config pins its index (``_pinned_modal``), which the model then takes
    over any graph's own modality, and the parameters stay as they are (the
    JAX package's deploy-time pin; reference ``prepare_modal_deploy``)."""
    cfg = copy.deepcopy(model_config)
    mm = dict(cfg.get("modal_map") or {})
    if modal not in mm:
        raise ValueError(f"unknown modality {modal}; the model has {sorted(mm)}")
    cfg["_pinned_modal"] = mm[modal]
    return cfg, params
