"""Radial basis and cutoff envelopes (PyTorch port of
``sevennet_tpu/ops/radial.py``; reference ``sevenn/nn/edge_embedding.py``).

- :func:`bessel_basis`: 2/rc * sin(c_n r)/r, coefficients c_n = n*pi/rc;
- :func:`poly_cutoff`: polynomial envelope, p=6 default;
- :func:`xplor_cutoff`: XPLOR smoothing between ``cutoff_on`` and the cutoff.

Both envelopes are clamped to exactly zero beyond the cutoff: padded edge
slots carry a sentinel vector past the cutoff and must contribute nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["bessel_coeffs_init", "bessel_basis", "poly_cutoff", "xplor_cutoff"]


def bessel_coeffs_init(cutoff: float, num_basis: int = 8) -> np.ndarray:
    return np.array(
        [n * math.pi / cutoff for n in range(1, num_basis + 1)], dtype=np.float32
    )


def bessel_basis(r: torch.Tensor, coeffs: torch.Tensor, cutoff: float, eps: float = 1e-12):
    """(...,) -> (..., num_basis)."""
    safe = torch.clamp(r[..., None], min=eps)
    return (2.0 / cutoff) * torch.sin(coeffs * safe) / safe


def int_pow(x: torch.Tensor, p: int) -> torch.Tensor:
    """``x**p`` by binary exponentiation, the order of multiplies XLA uses
    for an integer power: the polynomial envelope cancels to ~1e-3 near the
    cutoff, so the rounding of ``x**p`` shows in its last digits."""
    acc = None
    while p > 0:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def poly_cutoff(r: torch.Tensor, cutoff: float, p: int = 6):
    """Smooth polynomial envelope, 1 at r=0, 0 at and beyond r=cutoff."""
    x = r / cutoff
    c0 = (p + 1.0) * (p + 2.0) / 2.0
    c1 = p * (p + 2.0)
    c2 = p * (p + 1.0) / 2.0
    xp = int_pow(x, int(p))
    val = 1.0 - c0 * xp + c1 * xp * x - c2 * xp * x * x
    return torch.where(x < 1.0, val, torch.zeros_like(val))


def xplor_cutoff(r: torch.Tensor, cutoff: float, cutoff_on: float):
    """XPLOR smoothing: 1 below r_on, smooth to 0 at r_cut, 0 beyond."""
    r_sq = r * r
    on_sq = cutoff_on * cutoff_on
    cut_sq = cutoff * cutoff
    smooth = (
        (cut_sq - r_sq) ** 2
        * (cut_sq + 2.0 * r_sq - 3.0 * on_sq)
        / (cut_sq - on_sq) ** 3
    )
    return torch.where(
        r < cutoff_on,
        torch.ones_like(r),
        torch.where(r < cutoff, smooth, torch.zeros_like(r)),
    )
