"""Losses: per-atom energy, force, stress, with NaN-label masking (PyTorch
port of ``sevennet_tpu/train/loss.py``).

Mirrors the reference semantics (``sevenn/train/loss.py``):
- energy loss on E/N_atoms (``PerAtomEnergyLoss``);
- force loss per component;
- stress loss in kbar (x 1602.1766208 from eV/A^3, ``loss.py:185``);
- labels that are NaN are excluded from both numerator and denominator
  (``_ignore_unlabeled``, ``loss.py:49-60``), through masks;
- criterion: MSE or Huber (``train/optim.py:23``);
- optional per-structure data weights (``loss.py:115-120``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..data.graph import GraphBatch

__all__ = ["LossConfig", "compute_losses", "TO_KBAR"]

TO_KBAR = 1602.1766208  # eV/A^3 -> kbar


@dataclass(frozen=True)
class LossConfig:
    criterion: str = "mse"  # 'mse' | 'huber'
    huber_delta: float = 0.01
    energy_weight: float = 1.0
    force_weight: float = 0.1
    stress_weight: float = 1e-6
    train_stress: bool = True
    use_weight: bool = False  # per-structure data weights (GraphBatch.data_weight)


def _criterion(cfg: LossConfig, pred, ref):
    err = pred - ref
    if cfg.criterion == "mse":
        return err * err
    if cfg.criterion == "huber":
        a = torch.abs(err)
        d = cfg.huber_delta
        return torch.where(a < d, 0.5 * err * err, d * (a - 0.5 * d))
    raise ValueError(cfg.criterion)


def _masked_mean(x, mask, weight=None):
    """Mean over masked entries; optional per-entry weights multiply the
    numerator only (reference semantics: ``mean(criterion * w)``,
    loss.py:79-80)."""
    denom = torch.clamp(mask.sum(), min=1.0)
    num = x * mask if weight is None else x * mask * weight
    return num.sum() / denom


def _masked(mask, v):
    return torch.where(mask > 0, v, torch.zeros((), dtype=v.dtype, device=v.device))


def compute_losses(
    out: Dict[str, torch.Tensor], graph: GraphBatch, cfg: LossConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total_loss, per-term dict). NaN labels contribute zero."""
    losses: Dict[str, torch.Tensor] = {}
    dtype = out["energy"].dtype

    if cfg.use_weight and graph.data_weight is not None:
        w_e = graph.data_weight[:, 0]
        w_f = graph.data_weight[:, 1][graph.batch]
        w_s = graph.data_weight[:, 2]
    else:
        w_e = w_f = w_s = None

    # energy, per atom
    e_ref = graph.energy
    n_at = torch.clamp(graph.num_atoms.to(dtype), min=1.0)
    e_mask = (graph.graph_mask & ~torch.isnan(e_ref)).to(dtype)
    e_loss = _masked_mean(
        _criterion(cfg, out["energy"] / n_at, _masked(e_mask, e_ref) / n_at), e_mask, w_e
    )
    losses["energy"] = e_loss

    # forces, per component
    f_ref = graph.forces
    f_mask = (graph.atom_mask[:, None] & ~torch.isnan(f_ref)).to(dtype)
    f_loss = _masked_mean(
        _criterion(cfg, _masked(f_mask, out["forces"]), _masked(f_mask, f_ref)), f_mask,
        None if w_f is None else w_f[:, None],
    )
    losses["force"] = f_loss

    total = cfg.energy_weight * e_loss + cfg.force_weight * f_loss

    if cfg.train_stress and "stress" in out:
        s_ref = graph.stress
        s_mask = (graph.graph_mask[:, None] & ~torch.isnan(s_ref)).to(dtype)
        s_loss = _masked_mean(
            _criterion(cfg, _masked(s_mask, out["stress"]) * TO_KBAR,
                       _masked(s_mask, s_ref) * TO_KBAR),
            s_mask, None if w_s is None else w_s[:, None],
        )
        losses["stress"] = s_loss
        total = total + cfg.stress_weight * s_loss

    losses["total"] = total
    return total, losses
