"""Training orchestration: config -> datasets -> model -> epoch loop (PyTorch
port of ``sevennet_tpu/scripts/train.py``, one modality, one device).

The flow of the reference ``sevenn/scripts/train.py:train_v2`` +
``processing_epoch.py``: build datasets (with statistics feeding
shift/scale/conv_denominator), build the model, run epochs with periodic
and best-metric checkpoints and an ``lc.csv`` learning curve.
Continue/restart follows ``processing_continue.py:16-92``: model weights,
optimizer and epoch come from the checkpoint; statistics (shift/scale/
denominator) are NOT recomputed.

The conv is always the fused one: the CUDA kernels on the card (B1 forward,
B2′ backward with parameter gradients), their plain versions on the CPU.
Not ported yet (ROADMAP.md, queue A): multi-modal datasets, data-parallel
training, readers other than extxyz.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..config import read_config_yaml
from ..data.dataset import GraphDataset
from ..io.convert import params_from_numpy, random_params
from ..io.native_checkpoint import load_native_checkpoint, save_checkpoint
from ..logger import LearningCurveCSV, Logger
from ..model.build import build_model_spec
from ..train.error_recorder import DEFAULT_ERROR_RECORD
from ..train.loss import LossConfig
from ..train.trainer import Trainer, TrainerConfig

__all__ = ["train_from_yaml", "train_run", "resolve_statistics", "dense_capacity"]

# best-checkpoint criterion (reference 'best_metric', TotalLoss default)
_METRIC_KEY = {
    "totalloss": "loss_total",
    "energy": "Energy_RMSE",
    "force": "Force_RMSE",
    "stress": "Stress_RMSE",
}


def resolve_statistics(model_cfg: Dict, data_cfg: Dict, trainset, log: Logger):
    """Replace string placeholders (shift/scale/conv_denominator) with
    dataset statistics, mirroring ``graph_dataset.from_config`` (:682-692)."""
    for key in ("shift", "scale"):
        v = data_cfg.get(key, model_cfg.get(key))
        if isinstance(v, str):
            v = getattr(trainset, v)
            log.format_k_v(f"{key} (from statistics)", v if np.isscalar(v) else "per-element list")
        model_cfg[key] = v
    cd = model_cfg.get("conv_denominator")
    if isinstance(cd, str):
        model_cfg["conv_denominator"] = getattr(trainset, cd)
        log.format_k_v("conv_denominator (from statistics)", model_cfg["conv_denominator"])


def dense_capacity(max_neighbors: int) -> int:
    """K of the dense ``(N, K)`` layout for a largest neighbour count: a
    10 % margin plus one, rounded up to a multiple of 8 (the JAX package's
    rule, ``sevennet_tpu/scripts/train.py:143-159``)."""
    return -(-int(np.ceil(max_neighbors * 1.1) + 1) // 8) * 8


def train_from_yaml(yaml_path: str, working_dir: str = ".", max_epochs: Optional[int] = None,
                    device: Optional[str] = None):
    model_cfg, train_cfg, data_cfg = read_config_yaml(yaml_path)
    return train_run(model_cfg, train_cfg, data_cfg, working_dir, max_epochs, device=device)


def train_run(
    model_cfg: Dict,
    train_cfg: Dict,
    data_cfg: Dict,
    working_dir: str = ".",
    max_epochs: Optional[int] = None,
    device: Optional[str] = None,
    pad_multiple: int = 64,
) -> Trainer:
    """Trains on ``device`` (``cuda`` unless ``"cpu"``). Batches pad their
    atom count to a multiple of ``pad_multiple``."""
    os.makedirs(working_dir, exist_ok=True)
    log = Logger(os.path.join(working_dir, "log.sevennet"))
    log.writeline("SevenNet training (PyTorch port)")
    log.timer_start("total")

    cutoff = float(model_cfg["cutoff"])
    train_paths = data_cfg["load_trainset_path"]
    if not train_paths:
        raise ValueError("data.load_trainset_path must be given")
    if isinstance(train_paths, list) and isinstance(train_paths[0], dict):
        raise NotImplementedError("multi-modal datasets are not ported yet (ROADMAP.md, queue A)")
    trainset = GraphDataset.from_files(train_paths, cutoff)
    validset = None
    ratio = float(data_cfg.get("ratio") or data_cfg.get("data_divide_ratio") or 0.0)
    if data_cfg.get("load_validset_path"):
        validset = GraphDataset.from_files(data_cfg["load_validset_path"], cutoff)
    elif ratio > 0:
        # reference key: data_divide_ratio (``_const.py``); 'ratio' kept as
        # a shorthand alias
        trainset, validset = trainset.split(ratio)
    log.format_k_v("# train structures", len(trainset))
    log.format_k_v("# valid structures", len(validset) if validset else 0)

    if model_cfg.get("chemical_species", "auto") == "auto":
        species = sorted(set(trainset.species) | set(validset.species if validset else []))
        model_cfg["chemical_species"] = species
        log.format_k_v("chemical_species (auto)", species)

    # continue: the spec (incl. frozen shift/scale/denominator statistics,
    # processing_continue.py:43-55) comes from the checkpoint
    cont = train_cfg.get("continue", {}) or {}
    start_epoch, cont_meta, cont_opt_state = 0, {}, None
    if cont.get("checkpoint"):
        model_cfg, params, opt_state, cont_meta = load_native_checkpoint(cont["checkpoint"])
        spec = build_model_spec(model_cfg)
        params = params_from_numpy(spec, params)
        if not cont.get("reset_epoch"):
            start_epoch = int(cont_meta.get("epoch", 0))
        if not cont.get("reset_optimizer"):
            cont_opt_state = opt_state
        log.format_k_v("continue from", cont["checkpoint"])
    else:
        resolve_statistics(model_cfg, data_cfg, trainset, log)
        spec = build_model_spec(model_cfg)
        params = params_from_numpy(spec, random_params(spec, int(train_cfg.get("random_seed", 1))))
    trainset.build(spec.z_to_type, processes=int(data_cfg.get("preprocess_num_cores", 1)))
    if validset:
        validset.build(spec.z_to_type, processes=int(data_cfg.get("preprocess_num_cores", 1)))

    k_max = trainset.max_neighbors()
    if validset:
        k_max = max(k_max, validset.max_neighbors())
    dense_k = dense_capacity(k_max)
    log.format_k_v("dense neighbor capacity", dense_k)

    # stress loss is computed in kbar inside compute_losses (as the
    # reference does at loss.py:185), so the weight passes through unchanged
    loss_cfg = LossConfig(
        criterion=str(train_cfg.get("loss", "mse")).lower(),
        huber_delta=float(train_cfg.get("loss_param", {}).get("delta", 0.01)),
        force_weight=float(train_cfg.get("force_loss_weight", 0.1)),
        stress_weight=float(train_cfg.get("stress_loss_weight", 1e-6)),
        train_stress=bool(train_cfg.get("is_train_stress", True)),
        use_weight=bool(train_cfg.get("use_weight", False)),
    )
    tcfg = TrainerConfig(
        loss=loss_cfg,
        optimizer=str(train_cfg.get("optimizer", "adam")),
        lr=float(train_cfg.get("optim_param", {}).get("lr", 0.01)),
        optim_param=dict(train_cfg.get("optim_param", {})),
        scheduler=str(train_cfg.get("scheduler", "constant")),
        scheduler_param=dict(train_cfg.get("scheduler_param", {})),
        error_record=tuple(tuple(e) for e in train_cfg.get("error_record", DEFAULT_ERROR_RECORD)),
    )
    trainer = Trainer(spec, params, tcfg, device=device)
    log.format_k_v("device", trainer.device)
    if cont_opt_state is not None:
        trainer.load_opt_state(cont_opt_state)
        log.writeline("continue: optimizer state restored")
    if cont.get("checkpoint"):
        aux = dict(cont_meta.get("extra", {}).get("trainer", {}))
        if cont.get("reset_scheduler"):
            for k in ("plateau_best", "plateau_bad", "plateau_scale"):
                aux.pop(k, None)
            aux["sched_epoch0"] = start_epoch
        trainer.load_aux_state(aux)

    best_metric_key = _METRIC_KEY.get(str(train_cfg.get("best_metric", "TotalLoss")).lower(),
                                      "loss_total")
    lc = LearningCurveCSV(os.path.join(working_dir, "lc.csv"))
    n_epochs = int(max_epochs or train_cfg.get("epoch", 10))
    batch_size = int(data_cfg.get("batch_size", 6))
    per_epoch = int(train_cfg.get("per_epoch", 10))
    best = (float(cont_meta.get("extra", {}).get("best", np.inf))
            if not cont.get("reset_epoch") else np.inf)

    def _save(tag, epoch):
        save_checkpoint(
            os.path.join(working_dir, tag), model_cfg, trainer.params, trainer.opt_state(),
            epoch, extra={"trainer": trainer.aux_state(), "best": best},
        )

    for epoch in range(start_epoch + 1, start_epoch + n_epochs + 1):
        log.timer_start("epoch")
        trainer.set_epoch(epoch - 1)  # lr for this epoch
        tr = trainer.run_epoch(
            trainset.batches(batch_size, shuffle=bool(train_cfg.get("train_shuffle", True)),
                             seed=epoch, dense_k=dense_k, pad_multiple=pad_multiple),
            train=True,
        )
        rows = {"train": tr}
        if validset:
            rows["valid"] = trainer.run_epoch(
                validset.batches(batch_size, dense_k=dense_k, pad_multiple=pad_multiple),
                train=False,
            )
        lc.append(epoch, rows)
        key_metrics = rows.get("valid", rows["train"])
        log.writeline(
            f"epoch {epoch}: lr={trainer.current_lr(epoch - 1):.3e} "
            + " ".join(f"{k}={v:.4g}" for k, v in key_metrics.items()
                       if "loss" in k.lower() or "rmse" in k.lower())
        )
        log.timer_end("epoch", f"epoch {epoch} time")

        crit = key_metrics.get(best_metric_key, np.inf)
        trainer.plateau_step(crit)
        if crit < best:
            best = crit
            _save("checkpoint_best", epoch)
        if epoch % per_epoch == 0:
            _save(f"checkpoint_{epoch}", epoch)

    _save("checkpoint_last", start_epoch + n_epochs)
    log.timer_end("total", "total training time")
    log.close()
    return trainer
