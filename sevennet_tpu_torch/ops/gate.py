"""Equivariant gate nonlinearity (e3nn ``nn.Gate`` equivalent), the PyTorch
port of ``sevennet_tpu/ops/gate.py``.

Input layout: e3nn's ``_Sortcut`` convention — the scalar part is
``(irreps_scalars + irreps_gates)`` stably sorted by irrep and simplified,
followed by the gated irreps. Output: ``act(scalars) + act(gates) * gated``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from ..irreps import Irrep, Irreps, MulIrrep
from .activations import ACT_PARITY, NORMALIZED_ACTIVATION

__all__ = ["GateSpec", "gate_apply"]


@dataclass(frozen=True)
class GateSpec:
    """Built from the *output* irreps of a layer (blocks classified by l)."""

    irreps_out: Irreps
    act_scalar: Tuple[Tuple[str, str], ...]  # (('e','silu'), ('o','tanh'))
    act_gate: Tuple[Tuple[str, str], ...]
    # derived
    irreps_scalars: Irreps = field(default=Irreps())
    irreps_gates: Irreps = field(default=Irreps())
    irreps_gated: Irreps = field(default=Irreps())
    # e3nn _Sortcut layout of the scalar part: (('s'|'g', entry_index), ...)
    sc_entries: Tuple[Tuple[str, int], ...] = field(default=())

    def __post_init__(self):
        if len(self.irreps_scalars) or len(self.irreps_gates) or len(self.irreps_gated):
            return
        scalars = [mi for mi in self.irreps_out if mi.ir.l == 0]
        gated = [mi for mi in self.irreps_out if mi.ir.l > 0]
        gate_p = 1 if any(mi.ir.p == 1 for mi in scalars) else -1
        gates = [MulIrrep(mi.mul, Irrep(0, gate_p)) for mi in gated]
        entries = [("s", i) for i in range(len(scalars))] + [
            ("g", i) for i in range(len(gates))
        ]
        pool = {"s": scalars, "g": gates}
        entries.sort(key=lambda e: pool[e[0]][e[1]].ir._sort_key())  # stable
        object.__setattr__(self, "irreps_scalars", Irreps(scalars))
        object.__setattr__(self, "irreps_gates", Irreps(gates))
        object.__setattr__(self, "irreps_gated", Irreps(gated))
        object.__setattr__(self, "sc_entries", tuple(entries))

    @property
    def irreps_in(self) -> Irreps:
        pool = {"s": self.irreps_scalars, "g": self.irreps_gates}
        head = Irreps([pool[kind][i] for kind, i in self.sc_entries])
        return head.simplify() + self.irreps_gated

    def _act(self, table, p: int):
        name = dict(table)["e" if p == 1 else "o"]
        if p == -1:
            assert ACT_PARITY.get(name, 0) == -1, (
                f"activation {name} for odd scalars must be an odd function"
            )
        return NORMALIZED_ACTIVATION[name]


def gate_apply(spec: GateSpec, x: torch.Tensor) -> torch.Tensor:
    """x: (..., irreps_in.dim) -> (..., irreps_out.dim)."""
    pool = {"s": spec.irreps_scalars, "g": spec.irreps_gates}
    s_blocks = [None] * len(spec.irreps_scalars)
    g_blocks = [None] * len(spec.irreps_gates)
    off = 0
    for kind, i in spec.sc_entries:
        mi = pool[kind][i]
        blk = x[..., off : off + mi.dim]
        (s_blocks if kind == "s" else g_blocks)[i] = blk
        off += mi.dim
    assert off == spec.irreps_scalars.dim + spec.irreps_gates.dim
    gated = x[..., off:]

    pieces = []
    for mi, blk in zip(spec.irreps_scalars, s_blocks):
        pieces.append(spec._act(spec.act_scalar, mi.ir.p)(blk))
    g_act = [
        spec._act(spec.act_gate, mi.ir.p)(blk)
        for mi, blk in zip(spec.irreps_gates, g_blocks)
    ]
    # gated blocks are ir_mul (2l+1, mul); the gate broadcasts over 2l+1
    off = 0
    for mi, g in zip(spec.irreps_gated, g_act):
        blk = gated[..., off : off + mi.dim]
        lead = blk.shape[:-1]
        blk = blk.reshape(*lead, mi.ir.dim, mi.mul) * g[..., None, :]
        pieces.append(blk.reshape(*lead, mi.dim))
        off += mi.dim
    return torch.cat(pieces, dim=-1)
