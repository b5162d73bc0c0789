"""Equivariant linear layer (e3nn ``o3.Linear`` equivalent).

Mixes multiplicities within each irrep block, never across irreps. Weight
layout, instruction order and normalization mirror e3nn (and
``sevennet_tpu/ops/linear.py``):

- instructions ``(i_in, i_out)`` for every pair of equal irreps, ``i_in``
  the outer loop;
- forward scale ``1/sqrt(fan_in)``, ``fan_in = sum(mul_in)`` over the
  instructions into ``i_out``;
- one ``(mul_in, mul_out)`` weight matrix per instruction;
- biases only on scalar (0e) outputs, unscaled.

Features are stored **ir_mul**: ``(2l+1, mul)`` within the flat axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..irreps import Irreps

__all__ = ["LinearSpec", "linear_apply", "linear_pack", "linear_unpack"]


@dataclass(frozen=True)
class LinearSpec:
    irreps_in: Irreps
    irreps_out: Irreps
    biases: bool = False
    # derived
    instructions: Tuple[Tuple[int, int, float], ...] = field(default=())

    def __post_init__(self):
        if self.instructions:
            return
        ins = [
            (i_in, i_out)
            for i_in, mi_in in enumerate(self.irreps_in)
            for i_out, mi_out in enumerate(self.irreps_out)
            if mi_in.ir == mi_out.ir
        ]
        fan = {}
        for i_in, i_out in ins:
            fan[i_out] = fan.get(i_out, 0) + self.irreps_in[i_in].mul
        full = tuple(
            (i_in, i_out, float(1.0 / np.sqrt(fan[i_out]))) for i_in, i_out in ins
        )
        object.__setattr__(self, "instructions", full)

    @property
    def weight_shapes(self) -> List[Tuple[int, int]]:
        return [
            (self.irreps_in[i].mul, self.irreps_out[j].mul)
            for i, j, _ in self.instructions
        ]

    @property
    def bias_numel(self) -> int:
        if not self.biases:
            return 0
        return sum(mi.mul for mi in self.irreps_out if mi.ir.l == 0 and mi.ir.p == 1)


def linear_apply(spec: LinearSpec, params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., dim_in) -> (..., dim_out)."""
    in_slices = spec.irreps_in.slices()
    out_blocks: List[Optional[torch.Tensor]] = [None] * len(spec.irreps_out)
    lead = x.shape[:-1]
    for (i_in, i_out, alpha), w in zip(spec.instructions, params["w"]):
        mi_in = spec.irreps_in[i_in]
        xb = x[..., in_slices[i_in]].reshape(*lead, mi_in.ir.dim, mi_in.mul)
        yb = (xb @ w) * alpha
        out_blocks[i_out] = yb if out_blocks[i_out] is None else out_blocks[i_out] + yb

    if spec.biases and "b" in params:
        b = params["b"]
        off = 0
        for j, mi in enumerate(spec.irreps_out):
            if mi.ir.l == 0 and mi.ir.p == 1:
                bj = b[off : off + mi.mul].reshape((1,) * len(lead) + (1, mi.mul))
                if out_blocks[j] is None:
                    out_blocks[j] = bj.expand(*lead, 1, mi.mul).to(x.dtype)
                else:
                    out_blocks[j] = out_blocks[j] + bj
                off += mi.mul

    pieces = []
    for j, mi in enumerate(spec.irreps_out):
        blk = out_blocks[j]
        if blk is None:
            blk = x.new_zeros((*lead, mi.ir.dim, mi.mul))
        pieces.append(blk.reshape(*lead, mi.dim))
    return torch.cat(pieces, dim=-1)


def linear_pack(spec: LinearSpec, params) -> np.ndarray:
    """Flatten instruction weights to the e3nn checkpoint layout."""
    return np.concatenate([np.asarray(w).reshape(-1) for w in params["w"]] or [np.zeros(0)])


def linear_unpack(spec: LinearSpec, flat: np.ndarray, bias: Optional[np.ndarray] = None):
    """The e3nn flat weight vector (and bias) -> ``{"w": [...], "b": ...}``
    of numpy arrays, one ``(mul_in, mul_out)`` matrix per instruction."""
    ws, off = [], 0
    for shape in spec.weight_shapes:
        n = shape[0] * shape[1]
        ws.append(np.asarray(flat[off : off + n]).reshape(shape))
        off += n
    if off != len(flat):
        raise ValueError(f"weight numel mismatch: {off} != {len(flat)}")
    params = {"w": ws}
    if spec.biases:
        if bias is None or len(bias) != spec.bias_numel:
            raise ValueError(f"expected a bias of {spec.bias_numel} values")
        params["b"] = np.asarray(bias)
    return params
