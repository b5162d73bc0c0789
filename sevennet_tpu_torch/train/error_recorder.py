"""Config-driven streaming error recorder (PyTorch port of
``sevennet_tpu/train/error_recorder.py``; the reference's ``ErrorRecorder``,
``sevenn/error_recorder.py:24-453``).

Same surface a SevenNet user expects:

- error types ``TotalEnergy``/``Energy``/``Force``/``Stress``/``Stress_GPa``
  with the reference units and coefficients (``error_recorder.py:23-66``);
- metric kinds ``RMSE`` (vector RMSE over vdim), ``ComponentRMSE``, ``MAE``,
  ``Loss`` (per-term criterion mean) and the ``TotalLoss`` combination
  (``error_recorder.py:168-307``);
- the metric list comes from config ``error_record`` entries
  (``_const.py:276-281`` default: Energy/Force/Stress RMSE + TotalLoss),
  stress rows dropped when stress is not trained
  (``error_recorder.py:420-427``).

The recorder is a static :class:`RecorderSpec` and pure accumulate/finalize
functions over a flat dict of ``(sum, count)`` tensors, which stay on the
device until an epoch is finalized.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import GraphBatch
from .loss import TO_KBAR, LossConfig, _criterion

__all__ = [
    "RecorderSpec", "ErrorRecorder", "recorder_empty", "recorder_update",
    "recorder_finalize", "recorder_add", "DEFAULT_ERROR_RECORD",
]

TO_GPA = 160.21766208

# reference error-type registry (error_recorder.py:23-66)
_ERROR_TYPES = {
    "TotalEnergy": dict(name="TotalEnergy", unit="eV", field="energy", vdim=1,
                        per_atom=False, coeff=1.0),
    "Energy": dict(name="Energy", unit="eV/atom", field="energy", vdim=1,
                   per_atom=True, coeff=1.0),
    "Force": dict(name="Force", unit="eV/Å", field="force", vdim=3,
                  per_atom=False, coeff=1.0),
    "Stress": dict(name="Stress", unit="kbar", field="stress", vdim=6,
                   per_atom=False, coeff=TO_KBAR),
    "Stress_GPa": dict(name="Stress", unit="GPa", field="stress", vdim=6,
                       per_atom=False, coeff=TO_GPA),
    "TotalLoss": dict(name="TotalLoss", unit=None, field=None, vdim=1,
                      per_atom=False, coeff=1.0),
}

_METRICS = ("RMSE", "ComponentRMSE", "MAE", "Loss", "None")

# _const.py:276-281
DEFAULT_ERROR_RECORD: Tuple[Tuple[str, str], ...] = (
    ("Energy", "RMSE"),
    ("Force", "RMSE"),
    ("Stress", "RMSE"),
    ("TotalLoss", "None"),
)


@dataclass(frozen=True)
class RecorderSpec:
    """Static description of the metric list."""

    entries: Tuple[Tuple[str, str], ...] = DEFAULT_ERROR_RECORD
    loss: LossConfig = LossConfig()

    @staticmethod
    def from_config(
        error_record: Optional[Sequence[Sequence[str]]] = None,
        loss: Optional[LossConfig] = None,
        train_stress: Optional[bool] = None,
    ) -> "RecorderSpec":
        loss = loss or LossConfig()
        entries = [tuple(e) for e in (error_record or DEFAULT_ERROR_RECORD)]
        stress_on = loss.train_stress if train_stress is None else train_stress
        if not stress_on:
            entries = [e for e in entries if "Stress" not in e[0]]
        for et, mn in entries:
            if et not in _ERROR_TYPES:
                raise ValueError(f"unknown error type {et!r}")
            if mn not in _METRICS:
                raise ValueError(f"unknown metric {mn!r}")
        return RecorderSpec(entries=tuple(entries), loss=loss)

    def names(self) -> List[str]:
        out = []
        for et, mn in self.entries:
            base = _ERROR_TYPES[et]["name"]
            out.append(base if et == "TotalLoss" else f"{base}_{mn}")
        return out

    def key_str(self, name: str, with_unit: bool = True) -> str:
        for (et, mn), n in zip(self.entries, self.names()):
            if n == name:
                unit = _ERROR_TYPES[et]["unit"]
                return f"{n} ({unit})" if (unit and with_unit) else n
        return name


def _loss_keys(spec: RecorderSpec) -> List[str]:
    """Accumulator keys of the loss terms (shared by Loss metrics and
    TotalLoss)."""
    keys = ["_loss_energy", "_loss_force"]
    if spec.loss.train_stress:
        keys.append("_loss_stress")
    return keys


def recorder_empty(spec: RecorderSpec, device=None) -> Dict[str, torch.Tensor]:
    acc = {}
    for (et, mn), name in zip(spec.entries, spec.names()):
        if mn in ("RMSE", "ComponentRMSE", "MAE"):
            acc[name] = torch.zeros(2, dtype=torch.float32, device=device)
    for k in _loss_keys(spec):
        acc[k] = torch.zeros(2, dtype=torch.float32, device=device)
    return acc


def recorder_add(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    return {k: a[k] + b[k] for k in a}


def _zero_where_not(mask, v):
    return torch.where(mask > 0, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _field_err(et_def, out, graph: GraphBatch):
    """Masked (error, mask) for an error type; error is scaled by the type's
    unit coefficient; NaN labels excluded (loss.py:49-60)."""
    dtype = out["energy"].dtype
    f = et_def["field"]
    if f == "energy":
        ref = graph.energy
        mask = (graph.graph_mask & ~torch.isnan(ref)).to(dtype)
        err = (out["energy"] - _zero_where_not(mask, ref)) * mask
        if et_def["per_atom"]:
            err = err / torch.clamp(graph.num_atoms.to(dtype), min=1.0)
        return err[:, None], mask[:, None]
    if f == "force":
        ref = graph.forces
        mask = (graph.atom_mask[:, None] & ~torch.isnan(ref)).to(dtype)
        err = (out["forces"] - _zero_where_not(mask, ref)) * mask
        return err, mask
    if f == "stress":
        ref = graph.stress
        mask = (graph.graph_mask[:, None] & ~torch.isnan(ref)).to(dtype)
        err = (out["stress"] - _zero_where_not(mask, ref)) * mask * et_def["coeff"]
        return err, mask
    raise ValueError(f)


@torch.no_grad()
def recorder_update(
    spec: RecorderSpec,
    acc: Dict[str, torch.Tensor],
    out: Dict[str, torch.Tensor],
    graph: GraphBatch,
) -> Dict[str, torch.Tensor]:
    acc = dict(acc)
    for (et, mn), name in zip(spec.entries, spec.names()):
        if mn not in ("RMSE", "ComponentRMSE", "MAE"):
            continue
        et_def = _ERROR_TYPES[et]
        if et_def["field"] == "stress" and "stress" not in out:
            continue
        err, mask = _field_err(et_def, out, graph)
        if mn == "RMSE":
            # vector RMSE: mean over entities of |err_vec|^2
            # (RMSError vdim, error_recorder.py:168-190)
            s = (err * err).sum()
            c = mask.max(dim=-1).values.sum()
        elif mn == "ComponentRMSE":
            s = (err * err).sum()
            c = mask.sum()
        else:  # MAE
            s = err.abs().sum()
            c = mask.sum()
        acc[name] = acc[name] + torch.stack([s, c])

    # loss terms (criterion sums; shared by Loss metrics and TotalLoss)
    cfg = spec.loss
    dtype = out["energy"].dtype
    n_at = torch.clamp(graph.num_atoms.to(dtype), min=1.0)
    e_mask = (graph.graph_mask & ~torch.isnan(graph.energy)).to(dtype)
    e_ref = _zero_where_not(e_mask, graph.energy)
    e_c = _criterion(cfg, out["energy"] * e_mask / n_at, e_ref / n_at) * e_mask
    acc["_loss_energy"] = acc["_loss_energy"] + torch.stack([e_c.sum(), e_mask.sum()])
    f_mask = (graph.atom_mask[:, None] & ~torch.isnan(graph.forces)).to(dtype)
    f_ref = _zero_where_not(f_mask, graph.forces)
    f_c = _criterion(cfg, out["forces"] * f_mask, f_ref) * f_mask
    acc["_loss_force"] = acc["_loss_force"] + torch.stack([f_c.sum(), f_mask.sum()])
    if cfg.train_stress and "stress" in out and graph.stress is not None:
        s_mask = (graph.graph_mask[:, None] & ~torch.isnan(graph.stress)).to(dtype)
        s_ref = _zero_where_not(s_mask, graph.stress) * TO_KBAR
        s_c = _criterion(cfg, out["stress"] * s_mask * TO_KBAR, s_ref) * s_mask
        acc["_loss_stress"] = acc["_loss_stress"] + torch.stack([s_c.sum(), s_mask.sum()])
    return acc


def _mean(v) -> float:
    s, c = (float(x) for x in v)
    return s / c if c > 0 else float("nan")


def recorder_finalize(spec: RecorderSpec, acc: Dict[str, torch.Tensor]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    loss_means = {k[len("_loss_"):]: _mean(acc[k]) for k in _loss_keys(spec) if k in acc}
    cfg = spec.loss
    total = cfg.energy_weight * loss_means.get("energy", 0.0)
    total += cfg.force_weight * loss_means.get("force", 0.0)
    if "stress" in loss_means and not np.isnan(loss_means["stress"]):
        total += cfg.stress_weight * loss_means["stress"]
    for (et, mn), name in zip(spec.entries, spec.names()):
        if mn in ("RMSE", "ComponentRMSE"):
            m = _mean(acc[name])
            out[name] = float(np.sqrt(m)) if m == m else float("nan")
        elif mn == "MAE":
            out[name] = _mean(acc[name])
        elif mn == "Loss":
            key = _ERROR_TYPES[et]["field"]
            out[name] = loss_means.get(key, float("nan"))
        elif et == "TotalLoss":
            out[name] = total
    return out


class ErrorRecorder:
    """Host-side stateful wrapper with the reference display surface
    (``get_metric_dict`` / ``get_dct`` / ``epoch_forward``,
    ``error_recorder.py:310-370``)."""

    def __init__(self, spec: RecorderSpec = None):
        self.spec = spec or RecorderSpec()
        self.acc = recorder_empty(self.spec)
        self.history: List[Dict[str, float]] = []

    @staticmethod
    def from_config(config: dict, loss: Optional[LossConfig] = None) -> "ErrorRecorder":
        return ErrorRecorder(RecorderSpec.from_config(
            config.get("error_record"), loss, train_stress=config.get("is_train_stress"),
        ))

    def update(self, out, graph):
        dev = out["energy"].device
        self.acc = recorder_update(self.spec, {k: v.to(dev) for k, v in self.acc.items()},
                                   out, graph)

    def absorb(self, acc):
        """Merge an accumulator computed elsewhere (e.g. by a train step)."""
        self.acc = recorder_add(self.acc, {k: v.to(self.acc[k].device) for k, v in acc.items()})

    def get_current(self) -> Dict[str, float]:
        return recorder_finalize(self.spec, self.acc)

    def get_metric_dict(self, with_unit: bool = True) -> Dict[str, float]:
        return {self.spec.key_str(k, with_unit): v for k, v in self.get_current().items()}

    def get_dct(self, prefix: str = "") -> Dict[str, str]:
        if prefix and not prefix.endswith("_"):
            prefix = prefix + "_"
        return {f"{prefix}{k}": f"{v:6f}" for k, v in self.get_current().items()}

    def epoch_forward(self) -> Dict[str, float]:
        self.history.append(self.get_current())
        pretty = self.get_metric_dict(with_unit=True)
        self.reset()
        return pretty

    def reset(self):
        self.acc = recorder_empty(self.spec)
