"""Streaming error metrics (PyTorch port of ``sevennet_tpu/train/metrics.py``;
the reference's ``ErrorRecorder``, ``sevenn/error_recorder.py``): RMSE
(vector-norm and per-component), MAE, accumulated as ``(sum, count)`` pairs
so they stream over batches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from ..data.graph import GraphBatch
from .loss import TO_KBAR

__all__ = ["MetricsAccumulator", "metrics_update", "metrics_finalize", "empty_accumulator"]

_NAMES = ("energy_rmse", "energy_mae", "force_rmse", "force_rmse_comp", "force_mae",
          "stress_rmse", "stress_mae")


def empty_accumulator(device=None) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(2, dtype=torch.float32, device=device) for n in _NAMES}


def _acc(acc, name, sq_or_abs_sum, count):
    acc[name] = acc[name].to(sq_or_abs_sum.device) + torch.stack([sq_or_abs_sum, count])
    return acc


def _zero_where_not(mask, v):
    return torch.where(mask > 0, v, torch.zeros((), dtype=v.dtype, device=v.device))


@torch.no_grad()
def metrics_update(acc: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor],
                   graph: GraphBatch):
    dtype = out["energy"].dtype
    # energy per atom
    n_at = torch.clamp(graph.num_atoms.to(dtype), min=1.0)
    e_mask = (graph.graph_mask & ~torch.isnan(graph.energy)).to(dtype)
    e_err = (out["energy"] - _zero_where_not(e_mask, graph.energy)) / n_at * e_mask
    acc = _acc(acc, "energy_rmse", (e_err**2).sum(), e_mask.sum())
    acc = _acc(acc, "energy_mae", e_err.abs().sum(), e_mask.sum())

    # force: the reference's default Force RMSE is the vector RMSE,
    # sqrt(mean over atoms of |dF|^2) (RMSError vdim=3,
    # error_recorder.py:167-180); component RMSE kept as force_rmse_comp
    f_mask = (graph.atom_mask[:, None] & ~torch.isnan(graph.forces)).to(dtype)
    f_err = (out["forces"] - _zero_where_not(f_mask, graph.forces)) * f_mask
    f_atoms = f_mask.max(dim=1).values.sum()
    acc = _acc(acc, "force_rmse", (f_err**2).sum(), f_atoms)
    acc = _acc(acc, "force_rmse_comp", (f_err**2).sum(), f_mask.sum())
    acc = _acc(acc, "force_mae", f_err.abs().sum(), f_mask.sum())

    if "stress" in out and graph.stress is not None:
        # vector RMSE over the 6 voigt components per structure (vdim=6)
        s_mask = (graph.graph_mask[:, None] & ~torch.isnan(graph.stress)).to(dtype)
        s_err = (out["stress"] - _zero_where_not(s_mask, graph.stress)) * s_mask * TO_KBAR
        s_structs = s_mask.max(dim=1).values.sum()
        acc = _acc(acc, "stress_rmse", (s_err**2).sum(), s_structs)
        acc = _acc(acc, "stress_mae", s_err.abs().sum(), s_mask.sum())
    return acc


def metrics_finalize(acc: Dict[str, torch.Tensor]) -> Dict[str, float]:
    out = {}
    for name, v in acc.items():
        s, c = (float(x) for x in v)
        if c <= 0:
            out[name] = float("nan")
        elif name.endswith("rmse"):
            out[name] = float(np.sqrt(s / c))
        else:
            out[name] = s / c
    return out


@dataclass
class MetricsAccumulator:
    """Host-side convenience wrapper."""

    acc: Dict = field(default_factory=empty_accumulator)

    def update(self, out, graph):
        self.acc = metrics_update(self.acc, out, graph)

    def compute(self) -> Dict[str, float]:
        return metrics_finalize(self.acc)

    def reset(self):
        self.acc = empty_accumulator()
