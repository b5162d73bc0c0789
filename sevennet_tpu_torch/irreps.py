"""Irreducible-representation metadata for O(3)-equivariant features.

Pure-Python static metadata (no arrays). Features live in flat ``(..., dim)``
arrays; an :class:`Irreps` describes how that last axis decomposes into
``mul`` copies of ``(2l+1)``-dimensional irreps with parity ``p``.

Conventions mirror the e3nn irreps algebra that the reference implementation
(SevenNet) relies on (see reference ``sevenn/util.py:199-221`` and
``sevenn/nn/convolution.py:61-91``) so that stock SevenNet checkpoints map
onto this framework:

- an irrep is ``(l, p)`` with ``p`` in ``{+1, -1}`` printed as ``e``/``o``;
- sort order is ``(l, -p * (-1)**l)`` (i.e. ``0e < 0o < 1o < 1e < 2e < 2o``),
  sorting is *stable* in the multiplicities;
- ``simplify`` merges adjacent equal irreps after sorting.

Everything here is hashable, so specs built from it can key caches.
This is the PyTorch port's own copy of ``sevennet_tpu/irreps.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable, List, Tuple, Union

__all__ = ["Irrep", "MulIrrep", "Irreps"]


@dataclass(frozen=True, order=False)
class Irrep:
    l: int
    p: int

    def __post_init__(self):
        if self.l < 0 or self.p not in (1, -1):
            raise ValueError(f"invalid irrep l={self.l} p={self.p}")

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def _sort_key(self) -> Tuple[int, int]:
        # e3nn irrep ordering: by l, odd parity first (0o < 0e < 1o < 1e
        # < 2o < 2e ...), as the reference's frozen TorchScript deployments
        # lay out sorted conv-mid blocks (see tests/test_deployed_golden.py).
        return (self.l, self.p)

    def __lt__(self, other: "Irrep") -> bool:
        return self._sort_key() < other._sort_key()

    def __mul__(self, other: "Irrep") -> List["Irrep"]:
        """Selection rule: l in |l1-l2| .. l1+l2, p = p1*p2."""
        p = self.p * other.p
        return [
            Irrep(l, p)
            for l in range(abs(self.l - other.l), self.l + other.l + 1)
        ]

    def __repr__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    @staticmethod
    def parse(s: Union[str, "Irrep", Tuple[int, int]]) -> "Irrep":
        if isinstance(s, Irrep):
            return s
        if isinstance(s, tuple):
            return Irrep(*s)
        m = re.fullmatch(r"(\d+)([eo])", s.strip())
        if not m:
            raise ValueError(f"cannot parse irrep {s!r}")
        return Irrep(int(m.group(1)), 1 if m.group(2) == "e" else -1)


@dataclass(frozen=True)
class MulIrrep:
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __repr__(self) -> str:
        return f"{self.mul}x{self.ir}"


class Irreps(tuple):
    """A tuple of :class:`MulIrrep`, e.g. ``Irreps('128x0e+64x1o')``."""

    def __new__(cls, arg: Union[str, Iterable, "Irreps", None] = None):
        items: List[MulIrrep] = []
        if arg is None:
            pass
        elif isinstance(arg, Irreps):
            return tuple.__new__(cls, arg)
        elif isinstance(arg, str):
            if arg.strip():
                for term in arg.split("+"):
                    term = term.strip()
                    if "x" in term:
                        mul_s, ir_s = term.split("x")
                        items.append(MulIrrep(int(mul_s), Irrep.parse(ir_s)))
                    else:
                        items.append(MulIrrep(1, Irrep.parse(term)))
        else:
            for el in arg:
                if isinstance(el, MulIrrep):
                    items.append(el)
                else:
                    mul, ir = el
                    items.append(MulIrrep(int(mul), Irrep.parse(ir)))
        return tuple.__new__(cls, items)

    # -- basic properties ---------------------------------------------------
    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        return sum(mi.mul for mi in self)

    @property
    def lmax(self) -> int:
        if not self:
            raise ValueError("empty irreps has no lmax")
        return max(mi.ir.l for mi in self)

    @property
    def ls(self) -> List[int]:
        return [mi.ir.l for mi in self for _ in range(mi.mul)]

    def count(self, ir) -> int:  # type: ignore[override]
        ir = Irrep.parse(ir)
        return sum(mi.mul for mi in self if mi.ir == ir)

    def __contains__(self, ir) -> bool:
        try:
            ir = Irrep.parse(ir)
        except (ValueError, TypeError):
            return tuple.__contains__(self, ir)
        return any(mi.ir == ir for mi in self)

    # -- algebra -------------------------------------------------------------
    def __add__(self, other) -> "Irreps":
        return Irreps(tuple.__add__(self, Irreps(other)))

    def sort(self) -> Tuple["Irreps", Tuple[int, ...], Tuple[int, ...]]:
        """Stable sort by irrep. Returns ``(sorted, p, inv)``.

        ``p[old_index] = new_index`` and ``inv[new_index] = old_index``
        (mirrors ``e3nn.o3.Irreps.sort`` used at reference
        ``convolution.py:74-78``).
        """
        inv = sorted(range(len(self)), key=lambda i: self[i].ir._sort_key())
        p = [0] * len(self)
        for new, old in enumerate(inv):
            p[old] = new
        sorted_irreps = Irreps([self[i] for i in inv])
        return sorted_irreps, tuple(p), tuple(inv)

    def simplify(self) -> "Irreps":
        """Merge adjacent equal irreps (does NOT sort first)."""
        out: List[MulIrrep] = []
        for mi in self:
            if mi.mul == 0:
                continue
            if out and out[-1].ir == mi.ir:
                out[-1] = MulIrrep(out[-1].mul + mi.mul, mi.ir)
            else:
                out.append(mi)
        return Irreps(out)

    def slices(self) -> List[slice]:
        out = []
        i = 0
        for mi in self:
            out.append(slice(i, i + mi.dim))
            i += mi.dim
        return out

    def filter_lmax(self, lmax: int) -> "Irreps":
        return Irreps([mi for mi in self if mi.ir.l <= lmax])

    def __repr__(self) -> str:
        return "+".join(repr(mi) for mi in self) if self else "(empty)"

    @staticmethod
    def spherical_harmonics(lmax: int, p: int = -1) -> "Irreps":
        """``1x0e+1x1o+1x2e+...`` (p=-1) or all-even (p=1), as in the
        reference ``SphericalEncoding`` (``edge_embedding.py:163-185``)."""
        return Irreps([(1, (l, p**l)) for l in range(lmax + 1)])


def full_tensor_product_irreps(ir1: Irreps, ir2: Irreps) -> Irreps:
    """Irreps of the full TP, sorted and simplified (mirrors
    ``e3nn.o3.FullTensorProduct(...).irreps_out.simplify()`` used by the
    reference ``util.infer_irreps_out`` at ``util.py:199-221``)."""
    out = []
    for mi1 in ir1:
        for mi2 in ir2:
            for ir in mi1.ir * mi2.ir:
                out.append(MulIrrep(mi1.mul * mi2.mul, ir))
    srt, _, _ = Irreps(out).sort()
    return srt.simplify()


def infer_irreps_out(
    irreps_x: Irreps,
    irreps_operand: Irreps,
    drop_l: Union[bool, int] = False,
    parity_mode: str = "full",
    fix_multiplicity: Union[bool, int] = False,
) -> Irreps:
    """Output irreps schedule of a SevenNet interaction layer.

    Mirrors reference ``sevenn/util.py:199-221`` exactly: full TP, simplify,
    drop ``l > drop_l``, parity filter, optional fixed multiplicity.
    """
    assert parity_mode in ("full", "even", "sph")
    out = []
    for mi in full_tensor_product_irreps(irreps_x, irreps_operand):
        l, p = mi.ir.l, mi.ir.p
        if drop_l is not False and l > drop_l:
            continue
        if parity_mode == "even" and p == -1:
            continue
        if parity_mode == "sph" and p != (-1) ** l:
            continue
        mul = fix_multiplicity if fix_multiplicity else mi.mul
        out.append(MulIrrep(int(mul), mi.ir))
    return Irreps(out)
