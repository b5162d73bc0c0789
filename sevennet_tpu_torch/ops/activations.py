"""Scalar activations with e3nn ``normalize2mom`` second-moment constants.

e3nn wraps every scalar activation so that ``E[act(z)^2] = 1`` for
``z ~ N(0,1)``; the constants are the ones the reference's checkpoints were
trained with (PyTorch port of ``sevennet_tpu/ops/activations.py``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATION", "ACT_PARITY", "NORMALIZE2MOM_CST", "NORMALIZED_ACTIVATION", "normalized_act"]


def shifted_softplus(x):
    return F.softplus(x) - math.log(2.0)


ACTIVATION = {
    "relu": torch.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
    "abs": torch.abs,
    "ssp": shifted_softplus,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
}

# E[act(z)^2]^(-1/2), z~N(0,1); e3nn normalize2mom constants (seed-0 torch MC,
# 1e6 samples, float64; constants within 1e-4 of 1 are snapped to 1 by e3nn).
NORMALIZE2MOM_CST = {
    "silu": 1.6791767923989418,
    "tanh": 1.5937334472592695,
    "abs": 1.001110600838467,
    "relu": 1.4163393446331365,
    "sigmoid": 1.8467055342154766,
    "elu": 1.2467863885570512,
    "ssp": 1.8782046685415523,
}

# Function parity under x -> -x: 1 even, -1 odd, 0 neither.
ACT_PARITY = {
    "relu": 0,
    "silu": 0,
    "tanh": -1,
    "abs": 1,
    "ssp": 0,
    "sigmoid": 0,
    "elu": 0,
}


def normalized_act(name: str) -> Callable:
    f = ACTIVATION[name]
    c = NORMALIZE2MOM_CST[name]

    def act(x):
        return f(x) * c

    return act


NORMALIZED_ACTIVATION = {name: normalized_act(name) for name in ACTIVATION}
