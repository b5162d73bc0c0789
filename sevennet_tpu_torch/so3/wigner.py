"""Real Wigner 3j tables in the e3nn real-spherical-harmonic basis.

Derivation: complex Wigner 3j symbols (from sympy Clebsch-Gordan) are
transformed into the real SH basis with the standard real/complex change of
basis ``U`` and the phase ``(-i)^(l1+l2+l3)`` that makes the result real:

    R[a,b,c] = Re[ (-i)^(l1+l2+l3) * sum_{m1 m2 m3}
                   U_l1[a,m1] U_l2[b,m2] U_l3[c,m3] W3j[m1,m2,m3] ]

This exactly reproduces the tables e3nn >= 0.5.0 registers as buffers in
TorchScript-compiled tensor products (verified against the eight
``_w3j_{l1}_{l2}_{l3}`` buffers stored in the reference test checkpoint
``tests/data/checkpoints/cp_0.pth``; see reference ``sevenn/__init__.py:11-15``
for the e3nn>=0.5.0 CG convention requirement).

Properties:
- Frobenius norm 1;
- equivariant coupling for the real SH produced by
  :mod:`sevennet_tpu_torch.so3.spherical` (same ``U``).

The PyTorch port's own copy of ``sevennet_tpu/so3/wigner.py``.

Tables are small (lmax <= 4 in practice) and cached in-process.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["real_wigner_3j", "su2_clebsch_gordan"]


@lru_cache(maxsize=None)
def _complex_w3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Complex Wigner 3j symbol table, indices m+l. float64."""
    from sympy import sqrt as _sqrt
    from sympy.physics.quantum.cg import CG

    W = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = -(m1 + m2)
            if abs(m3) > l3:
                continue
            cg = CG(l1, m1, l2, m2, l3, -m3).doit()
            val = (-1) ** (l1 - l2 - m3) / _sqrt(2 * l3 + 1) * cg
            W[m1 + l1, m2 + l2, m3 + l3] = float(val.evalf(35))
    return W


@lru_cache(maxsize=None)
def real_to_complex_transform(l: int) -> np.ndarray:
    """U[a, m]: real SH index a=m_r+l expressed over complex SH index m+l.

    Y_{l,m>0} = ((-1)^m Y_l^m + Y_l^{-m}) / sqrt(2)
    Y_{l,m<0} = ((-1)^m Y_l^{|m|} - Y_l^{-|m|}) / (i sqrt(2))
    """
    U = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    s2 = np.sqrt(2.0)
    for mr in range(-l, l + 1):
        a = mr + l
        if mr == 0:
            U[a, l] = 1.0
        elif mr > 0:
            U[a, mr + l] = (-1) ** mr / s2
            U[a, -mr + l] = 1 / s2
        else:
            m = -mr
            U[a, m + l] = (-1) ** m / (1j * s2)
            U[a, -m + l] = -1 / (1j * s2)
    return U


@lru_cache(maxsize=None)
def real_wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real Wigner 3j tensor, shape (2l1+1, 2l2+1, 2l3+1), float64.

    Zero tensor if the triangle inequality fails. Frobenius norm 1 otherwise.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    W = _complex_w3j(l1, l2, l3).astype(complex)
    U1 = real_to_complex_transform(l1)
    U2 = real_to_complex_transform(l2)
    U3 = real_to_complex_transform(l3)
    R = np.einsum("am,bn,cp,mnp->abc", U1, U2, U3, W)
    R = R * (-1j) ** (l1 + l2 + l3)
    assert np.abs(R.imag).max() < 1e-12, (l1, l2, l3)
    out = np.ascontiguousarray(R.real)
    out.setflags(write=False)
    return out


def su2_clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Complex CG coefficients <l1 m1 l2 m2 | l3 m3>, table [m1+l1,m2+l2,m3+l3]."""
    from sympy.physics.quantum.cg import CG

    C = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            C[m1 + l1, m2 + l2, m3 + l3] = float(
                CG(l1, m1, l2, m2, l3, m3).doit().evalf(35)
            )
    return C
