"""Real spherical harmonics, e3nn-compatible 'component' normalization.

Basis convention: l=1 components are ordered ``(x, y, z)`` (e3nn order, i.e.
the polar axis is y); higher l are generated by the Clebsch-Gordan recursion

    Y_{l+1} = c_{l+1} * w3j(l+1, 1, l) . (Y_1 (x) Y_l),   c_{l+1} > 0,

using the real Wigner 3j of :mod:`sevennet_tpu_torch.so3.wigner`. Component
normalization: ``sum_m Y_lm(r_hat)^2 = 2l+1`` pointwise on the unit sphere.

The polynomials are dense coefficient tables over monomials ``x^a y^b z^c``
(a+b+c=l), generated once in float64 on the host; :func:`spherical_harmonics`
evaluates them on tensors. The PyTorch port of ``sevennet_tpu/so3/spherical.py``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .wigner import real_wigner_3j

__all__ = [
    "monomials",
    "sh_coefficients",
    "sh_deriv_tables",
    "spherical_harmonics",
]


@lru_cache(maxsize=None)
def monomials(l: int) -> Tuple[Tuple[int, int, int], ...]:
    """Exponent triples (a,b,c) with a+b+c=l, lexicographic."""
    out = []
    for a in range(l, -1, -1):
        for b in range(l - a, -1, -1):
            out.append((a, b, l - a - b))
    return tuple(out)


@lru_cache(maxsize=None)
def sh_coefficients(l: int) -> np.ndarray:
    """Coefficient table C of shape (2l+1, n_monomials(l)):
    Y_{l,m}(r) = sum_k C[m, k] * x^a_k y^b_k z^c_k  (component normalization).
    """
    if l == 0:
        return np.ones((1, 1))
    if l == 1:
        return np.sqrt(3.0) * np.eye(3)

    prev = sh_coefficients(l - 1)
    mon_prev = monomials(l - 1)
    mon_cur = monomials(l)
    mon_idx = {m: k for k, m in enumerate(mon_cur)}

    w = real_wigner_3j(l, 1, l - 1)  # (2l+1, 3, 2l-1)
    C = np.zeros((2 * l + 1, len(mon_cur)))
    for i in range(3):  # Y_1 component = sqrt(3) * coord_i
        e1 = [0, 0, 0]
        e1[i] = 1
        for kp, (pa, pb, pc) in enumerate(mon_prev):
            k = mon_idx[(pa + e1[0], pb + e1[1], pc + e1[2])]
            for b in range(2 * l - 1):
                C[:, k] += w[:, i, b] * np.sqrt(3.0) * prev[b, kp]

    # normalize: sum_m Y^2 = 2l+1 pointwise on the sphere; evaluate at a
    # generic unit vector (the invariant is constant on the sphere)
    v = np.array([0.2672612419124244, -0.5345224838248488, 0.8017837257372732])
    vals = C @ np.array([v[0] ** a * v[1] ** b * v[2] ** c for a, b, c in mon_cur])
    norm = np.sqrt((vals**2).sum())
    C *= np.sqrt(2 * l + 1) / norm
    C.setflags(write=False)
    return C


@lru_cache(maxsize=None)
def sh_deriv_tables(l: int) -> np.ndarray:
    """Derivative tables G of shape (3, 2l+1, n_monomials(l-1)):

        dY_{l,m}/du_c = sum_k G[c, m, k] * mon_{l-1,k}(u),

    i.e. ``G[c] = C_l @ D_c`` where ``D_c`` differentiates the degree-l
    monomial basis with respect to coordinate ``c``. The fused conv kernels
    use them to chain the spherical-harmonic cotangent to the edge vectors."""
    assert l >= 1
    C = sh_coefficients(l)
    mon_cur = monomials(l)
    if l == 1:
        G = np.zeros((3, 3, 1))
        for c in range(3):
            G[c, :, 0] = C[:, c]
        G.setflags(write=False)
        return G
    mon_prev = monomials(l - 1)
    prev_idx = {m: k for k, m in enumerate(mon_prev)}
    G = np.zeros((3, 2 * l + 1, len(mon_prev)))
    for k, (a, b, cc) in enumerate(mon_cur):
        for c in range(3):
            e = [a, b, cc]
            if e[c] == 0:
                continue
            coeff = e[c]
            e[c] -= 1
            kp = prev_idx[tuple(e)]
            G[c, :, kp] += coeff * C[:, k]
    G.setflags(write=False)
    return G


def spherical_harmonics(
    lmax: int, vectors: torch.Tensor, normalize: bool = True, eps: float = 1e-30
) -> torch.Tensor:
    """Evaluate Y_0..Y_lmax concatenated: (..., 3) -> (..., (lmax+1)^2).

    ``normalize=True`` matches the reference's SphericalEncoding default.
    """
    if normalize:
        n = torch.linalg.vector_norm(vectors, dim=-1, keepdim=True)
        vectors = vectors / torch.clamp(n, min=eps)
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]

    outs = [torch.ones_like(x)[..., None]]
    if lmax >= 1:
        outs.append(float(np.sqrt(3.0)) * vectors)
    pows_x = [torch.ones_like(x)]
    pows_y = [torch.ones_like(y)]
    pows_z = [torch.ones_like(z)]
    for _ in range(lmax):
        pows_x.append(pows_x[-1] * x)
        pows_y.append(pows_y[-1] * y)
        pows_z.append(pows_z[-1] * z)
    for l in range(2, lmax + 1):
        C = torch.tensor(
            sh_coefficients(l), dtype=vectors.dtype, device=vectors.device
        )
        mons = torch.stack(
            [pows_x[a] * pows_y[b] * pows_z[c] for a, b, c in monomials(l)],
            dim=-1,
        )
        outs.append(mons @ C.T)
    return torch.cat(outs, dim=-1)
