"""Equivariant tensor products (PyTorch port of
``sevennet_tpu/ops/tensor_product.py``).

- :class:`ConvTPSpec` — the per-edge ``uvu`` product between node features
  and spherical-harmonic filters with per-edge weights from the radial MLP
  (reference ``IrrepsConvolution``, ``sevenn/nn/convolution.py:61-91``).
- :class:`FCTPSpec` — the fully-connected (``uvw``) product of the 'nequip'
  self-connection (``sevenn/nn/self_connection.py:11-67``).

Normalization follows e3nn (``component`` / ``element``): path weight
``sqrt((2*l3+1) / fan)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from ..irreps import Irreps, MulIrrep
from ..so3.wigner import real_wigner_3j

__all__ = ["ConvTPSpec", "FCTPSpec", "conv_tp_apply", "fctp_apply"]


@dataclass(frozen=True)
class ConvTPSpec:
    """uvu tensor product x (x) filter with external per-edge weights."""

    irreps_x: Irreps
    irreps_filter: Irreps
    irreps_out_target: Irreps  # which output irreps are kept (l-drop filter)
    # derived
    irreps_mid: Irreps = field(default=Irreps())
    # (i_in1, i_in2, i_out_sorted, path_weight), sorted by i_out
    instructions: Tuple[Tuple[int, int, int, float], ...] = field(default=())
    # the same triples in construction order (pre-v0.11 checkpoint layout)
    instructions_enum: Tuple[Tuple[int, int, int], ...] = field(default=())

    def __post_init__(self):
        if self.instructions:
            return
        ins = []
        mid: List[MulIrrep] = []
        for i, mi_x in enumerate(self.irreps_x):
            for j, mi_f in enumerate(self.irreps_filter):
                for ir_out in mi_x.ir * mi_f.ir:
                    if ir_out in self.irreps_out_target:
                        k = len(mid)
                        mid.append(MulIrrep(mi_x.mul, ir_out))
                        ins.append((i, j, k))
        irreps_mid_sorted, p, _ = Irreps(mid).sort()
        ins = [(i, j, p[k]) for (i, j, k) in ins]
        ins_enum = tuple(ins)
        ins.sort(key=lambda t: t[2])
        fan = {}
        for i, j, k in ins:
            fan[k] = fan.get(k, 0) + self.irreps_filter[j].mul
        full = tuple(
            (i, j, k, float(np.sqrt(irreps_mid_sorted[k].ir.dim / fan[k])))
            for (i, j, k) in ins
        )
        object.__setattr__(self, "irreps_mid", irreps_mid_sorted)
        object.__setattr__(self, "instructions", full)
        object.__setattr__(self, "instructions_enum", ins_enum)

    @property
    def weight_numel(self) -> int:
        return sum(self.irreps_x[i].mul * self.irreps_filter[j].mul
                   for i, j, _, _ in self.instructions)


def _join_same_irrep_blocks(irreps_mid: Irreps, out, lead, like: torch.Tensor):
    """Under the ir_mul layout, adjacent blocks with the same irrep are
    joined along the mul axis before flattening, so the downstream Linear
    (built on ``irreps_mid.simplify()``) reads one (2l+1, total_mul) block."""
    pieces = []
    k = 0
    n_blocks = len(irreps_mid)
    while k < n_blocks:
        ir = irreps_mid[k].ir
        group = []
        while k < n_blocks and irreps_mid[k].ir == ir:
            mi = irreps_mid[k]
            blk = out[k]
            if blk is None:
                blk = like.new_zeros((*lead, mi.ir.dim, mi.mul))
            group.append(blk)
            k += 1
        joined = group[0] if len(group) == 1 else torch.cat(group, dim=-1)
        pieces.append(joined.reshape(*lead, -1))
    return torch.cat(pieces, dim=-1)


def conv_tp_apply(spec: ConvTPSpec, x, filt, weight):
    """Per-edge message: x (E, dim_x), filt (E, dim_f), weight (E, numel)
    -> (E, dim_mid)."""
    xs = spec.irreps_x.slices()
    fs = spec.irreps_filter.slices()
    E = x.shape[0]
    out = [None] * len(spec.irreps_mid)
    w_off = 0
    for i, j, k, pw in spec.instructions:
        mi_x = spec.irreps_x[i]
        mi_f = spec.irreps_filter[j]
        mi_o = spec.irreps_mid[k]
        assert mi_f.mul == 1, "filter irreps must have multiplicity 1"
        w3j = torch.tensor(
            real_wigner_3j(mi_x.ir.l, mi_f.ir.l, mi_o.ir.l),
            dtype=x.dtype, device=x.device,
        )
        xb = x[:, xs[i]].reshape(E, mi_x.ir.dim, mi_x.mul)
        fb = filt[:, fs[j]]
        wb = weight[:, w_off : w_off + mi_x.mul]
        w_off += mi_x.mul * mi_f.mul
        tmp = torch.einsum("mnp,en->emp", w3j, fb)
        xw = xb * (pw * wb)[:, None, :]
        msg = torch.einsum("emp,emu->epu", tmp, xw)
        out[k] = msg if out[k] is None else out[k] + msg
    return _join_same_irrep_blocks(spec.irreps_mid, out, (E,), x)


@dataclass(frozen=True)
class FCTPSpec:
    """Fully-connected (uvw) tensor product with internal weights."""

    irreps_in1: Irreps
    irreps_in2: Irreps
    irreps_out: Irreps
    # derived: (i1, i2, i_out, path_weight)
    instructions: Tuple[Tuple[int, int, int, float], ...] = field(default=())

    def __post_init__(self):
        if self.instructions:
            return
        ins = []
        for i1, mi1 in enumerate(self.irreps_in1):
            for i2, mi2 in enumerate(self.irreps_in2):
                for i_out, mi_o in enumerate(self.irreps_out):
                    if mi_o.ir in mi1.ir * mi2.ir:
                        ins.append((i1, i2, i_out))
        fan = {}
        for i1, i2, i_out in ins:
            fan[i_out] = fan.get(i_out, 0) + (
                self.irreps_in1[i1].mul * self.irreps_in2[i2].mul
            )
        full = tuple(
            (i1, i2, i_out, float(np.sqrt(self.irreps_out[i_out].ir.dim / fan[i_out])))
            for (i1, i2, i_out) in ins
        )
        object.__setattr__(self, "instructions", full)

    @property
    def weight_shapes(self) -> List[Tuple[int, int, int]]:
        return [
            (self.irreps_in1[i1].mul, self.irreps_in2[i2].mul, self.irreps_out[io].mul)
            for i1, i2, io, _ in self.instructions
        ]

    @property
    def weight_numel(self) -> int:
        return sum(a * b * c for a, b, c in self.weight_shapes)


def fctp_apply(spec: FCTPSpec, params, x1, x2):
    """x1: (N, dim1), x2: (N, dim2) -> (N, dim_out)."""
    s1 = spec.irreps_in1.slices()
    s2 = spec.irreps_in2.slices()
    N = x1.shape[0]
    out = [None] * len(spec.irreps_out)
    for (i1, i2, io, pw), w in zip(spec.instructions, params["w"]):
        mi1, mi2, mio = spec.irreps_in1[i1], spec.irreps_in2[i2], spec.irreps_out[io]
        w3j = torch.tensor(
            real_wigner_3j(mi1.ir.l, mi2.ir.l, mio.ir.l),
            dtype=x1.dtype, device=x1.device,
        )
        xb = x1[:, s1[i1]].reshape(N, mi1.ir.dim, mi1.mul)
        yb = x2[:, s2[i2]].reshape(N, mi2.ir.dim, mi2.mul)
        blk = pw * torch.einsum("nmu,nkv,mkp,uvw->npw", xb, yb, w3j, w)
        out[io] = blk if out[io] is None else out[io] + blk
    pieces = []
    for io, mi in enumerate(spec.irreps_out):
        blk = out[io]
        if blk is None:
            blk = x1.new_zeros((N, mi.ir.dim, mi.mul))
        pieces.append(blk.reshape(N, mi.dim))
    return torch.cat(pieces, dim=-1)
