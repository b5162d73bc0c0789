"""Flat-output layout bookkeeping of the dense convolution (the part of
``sevennet_tpu/ops/dense_conv.py`` the fused conv needs)."""

from __future__ import annotations

from typing import Dict

from .tensor_product import ConvTPSpec

__all__ = ["mid_layout"]


def mid_layout(conv: ConvTPSpec):
    """Per mid block k: ``(group_start, p_dim, u_offset_in_group,
    u_total_of_group)`` in flat-feature coordinates, and ``dim_mid``.

    Same-irrep mid blocks are joined along the mul axis (sorted order), so
    block k's column for ``(p, u)`` is ``group_start + p*u_total + u_off + u``.
    """
    n_blocks = len(conv.irreps_mid)
    group_of = [0] * n_blocks
    groups = []  # (start_flat, p, u_total)
    kk = 0
    start = 0
    while kk < n_blocks:
        ir = conv.irreps_mid[kk].ir
        u_tot = 0
        while kk < n_blocks and conv.irreps_mid[kk].ir == ir:
            group_of[kk] = len(groups)
            u_tot += conv.irreps_mid[kk].mul
            kk += 1
        groups.append((start, ir.dim, u_tot))
        start += ir.dim * u_tot
    u_off = [0] * n_blocks
    seen: Dict[int, int] = {}
    for k in range(n_blocks):
        g = group_of[k]
        u_off[k] = seen.get(g, 0)
        seen[g] = u_off[k] + conv.irreps_mid[k].mul
    out = []
    for k in range(n_blocks):
        g = group_of[k]
        out.append((groups[g][0], groups[g][1], u_off[k], groups[g][2]))
    return tuple(out), start
