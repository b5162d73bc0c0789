"""YAML input parsing: one ``input.yaml`` with model/train/data sections
(the port's copy of ``sevennet_tpu/config.py``).

Mirrors the reference's config system (``sevenn/parse_input.py``,
``sevenn/_const.py:95-322``): defaults + validation per key, the same YAML
key names, so reference input files work unchanged for the supported
feature set.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

from .model.build import DEFAULT_MODEL_CONFIG

__all__ = ["DEFAULT_TRAIN_CONFIG", "DEFAULT_DATA_CONFIG", "read_config_yaml", "config_from_dicts"]

DEFAULT_TRAIN_CONFIG: Dict[str, Any] = {
    "random_seed": 1,
    "epoch": 300,
    "loss": "mse",
    "loss_param": {},
    "optimizer": "adam",
    "optim_param": {},
    "scheduler": "constant",
    "scheduler_param": {},
    "force_loss_weight": 0.1,
    "stress_loss_weight": 1e-6,
    "is_train_stress": True,
    "train_shuffle": True,
    "per_epoch": 10,
    "best_metric": "TotalLoss",
    "error_record": [
        ["Energy", "RMSE"],
        ["Force", "RMSE"],
        ["Stress", "RMSE"],
        ["TotalLoss", "None"],
    ],
    "continue": {
        "checkpoint": False,
        "reset_optimizer": False,
        "reset_scheduler": False,
        "reset_epoch": False,
    },
}

DEFAULT_DATA_CONFIG: Dict[str, Any] = {
    "batch_size": 6,
    "shift": "per_atom_energy_mean",
    "scale": "force_rms",
    "data_format": "ase",
    "data_format_args": {},
    "load_trainset_path": [],
    "load_validset_path": [],
    "ratio": 0.0,
    "data_divide_ratio": 0.1,
}


def read_config_yaml(path: str) -> Tuple[Dict, Dict, Dict]:
    import yaml  # not every machine that runs the port has PyYAML

    with open(path) as f:
        raw = yaml.safe_load(f)
    return config_from_dicts(raw)


# keys accepted beyond the defaults (reference knobs handled elsewhere or
# deliberately tolerated for preset compatibility)
_EXTRA_MODEL_KEYS = {
    "lmax_edge", "lmax_node", "_normalize_sph", "conv_denominator",
    "train_denominator", "train_shift_scale", "shift", "scale",
    "use_modal_wise_shift", "use_modal_wise_scale", "use_modality",
    "chemical_species", "num_modalities", "modal_map",
    "use_modal_node_embedding", "use_modal_self_inter_intro",
    "use_modal_self_inter_outro", "use_modal_output_block",
    "_edge_chunk", "_remat", "_conv_dense",
}
_EXTRA_TRAIN_KEYS = {"device", "dtype", "num_workers", "use_weight"}
_EXTRA_DATA_KEYS = {
    "shift", "scale", "conv_denominator", "load_testset_path",
    "use_modality", "load_dataset_path", "save_dataset_path",
    "preprocess_num_cores", "compute_statistics", "dataset_cache",
}


def _check_unknown(section: str, raw: Dict, defaults: Dict, extra: set):
    unknown = set(raw) - set(defaults) - extra
    if unknown:
        raise ValueError(
            f"unknown {section} config key(s): {sorted(unknown)} — "
            f"valid keys: {sorted(set(defaults) | extra)}"
        )


def config_from_dicts(raw: Dict) -> Tuple[Dict, Dict, Dict]:
    model_raw = dict(raw.get("model", {}))
    train_raw = dict(raw.get("train", {}))
    data_raw = dict(raw.get("data", {}))

    _check_unknown("model", model_raw, DEFAULT_MODEL_CONFIG, _EXTRA_MODEL_KEYS)
    _check_unknown("train", train_raw, DEFAULT_TRAIN_CONFIG, _EXTRA_TRAIN_KEYS)
    _check_unknown("data", data_raw, DEFAULT_DATA_CONFIG, _EXTRA_DATA_KEYS)

    model = copy.deepcopy(DEFAULT_MODEL_CONFIG)
    model.update(model_raw)
    # reference uses 'avg_num_neigh'/'sqrt_avg_num_neigh' strings resolved
    # from dataset statistics later — keep strings here

    train = copy.deepcopy(DEFAULT_TRAIN_CONFIG)
    train.update(train_raw)

    data = copy.deepcopy(DEFAULT_DATA_CONFIG)
    data.update(data_raw)

    _validate(model, train, data)
    return model, train, data


def _validate(model: Dict, train: Dict, data: Dict):
    if not isinstance(model.get("cutoff"), (int, float)) or model["cutoff"] <= 0:
        raise ValueError("model.cutoff must be a positive number")
    nc = model.get("num_convolution_layer")
    if not isinstance(nc, int) or nc < 1:
        raise ValueError("model.num_convolution_layer must be int >= 1")
    if model.get("irreps_manual") not in (False, None):
        if len(model["irreps_manual"]) != nc + 1:
            raise ValueError("irreps_manual needs num_convolution_layer+1 entries")
    loss = str(train.get("loss", "mse")).lower()
    if loss not in ("mse", "huber"):
        raise ValueError(f"unsupported loss {loss}")
    if not isinstance(data.get("batch_size"), int) or data["batch_size"] < 1:
        raise ValueError("data.batch_size must be int >= 1")
