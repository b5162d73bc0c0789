"""Scalar MLP (e3nn ``FullyConnectedNet`` equivalent) for radial weights.

Per layer ``x = act(x @ w / sqrt(h_in))`` with the ``normalize2mom``-scaled
activation; the last layer has no activation. No biases. Weights are
``(h_in, h_out)`` matrices, as in ``sevennet_tpu/ops/mlp.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

from .activations import NORMALIZED_ACTIVATION

__all__ = ["ScalarMLPSpec", "scalar_mlp_apply"]


@dataclass(frozen=True)
class ScalarMLPSpec:
    dims: Tuple[int, ...]  # (in, hidden..., out)
    act: str = "silu"


def scalar_mlp_apply(spec: ScalarMLPSpec, params, x):
    act = NORMALIZED_ACTIVATION[spec.act]
    ws = params["w"]
    for i, w in enumerate(ws):
        x = x @ (w / math.sqrt(w.shape[0]))
        if i < len(ws) - 1:
            x = act(x)
    return x
