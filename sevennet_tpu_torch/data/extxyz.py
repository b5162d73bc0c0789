"""Self-contained extended-XYZ reader/writer, no ASE dependency (PyTorch
port's copy of ``sevennet_tpu/data/extxyz.py``).

Covers the subset the reference consumes through ``ase.io.read``
(``sevenn/train/dataload.py:351-420``): Lattice, Properties with species /
pos / forces columns, per-frame info keys (energy, free_energy, stress,
pbc), and label conventions — internally stress labels are stored as
``-stress`` in the order (xx,yy,zz,xy,yz,zx), eV/A^3, matching the model's
virial output (reference ``dataload.py:162-175,290-294``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..atoms import AtomsLite
from ..model.build import ATOMIC_NUMBERS

__all__ = ["read_extxyz", "write_extxyz", "iter_extxyz"]

_TOKEN = re.compile(r'(\S+)=(?:"([^"]*)"|(\S+))')


def _parse_info_line(line: str) -> Dict[str, str]:
    out = {}
    for m in _TOKEN.finditer(line):
        out[m.group(1)] = m.group(2) if m.group(2) is not None else m.group(3)
    return out


def _floats(text: str) -> np.ndarray:
    return np.asarray(text.split(), dtype=np.float64)


def _parse_properties(props: str):
    """'species:S:1:pos:R:3:forces:R:3' -> list of (name, kind, ncols)."""
    parts = props.split(":")
    return [(parts[i], parts[i + 1], int(parts[i + 2])) for i in range(0, len(parts), 3)]


def _voigt_or_tensor_to_label(stress_vals: np.ndarray) -> np.ndarray:
    """ASE-convention stress (eV/A^3) -> internal label: -stress in order
    (xx,yy,zz,xy,yz,zx)."""
    s = np.asarray(stress_vals, dtype=np.float64).reshape(-1)
    if s.size == 9:
        t = s.reshape(3, 3)
        return -np.array([t[0, 0], t[1, 1], t[2, 2], t[0, 1], t[1, 2], t[2, 0]])
    if s.size == 6:  # ase voigt (xx,yy,zz,yz,xz,xy)
        return -s[[0, 1, 2, 5, 3, 4]]
    raise ValueError(f"bad stress shape {s.shape}")


def iter_extxyz(path: str) -> Iterator[AtomsLite]:
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                return
            line = line.strip()
            if not line:
                continue
            n = int(line)
            info = _parse_info_line(f.readline().strip())
            props = _parse_properties(info.get("Properties", "species:S:1:pos:R:3"))

            symbols: List[str] = []
            numbers = np.zeros(n, np.int64)
            cols: Dict[str, np.ndarray] = {}
            col_slices = []
            c = 0
            for name, kind, width in props:
                col_slices.append((name, kind, c, c + width))
                c += width

            rows = [f.readline().split() for _ in range(n)]
            for name, kind, c0, c1 in col_slices:
                if kind == "S":
                    vals = [r[c0] for r in rows]
                    if name == "species":
                        numbers = np.array(
                            [ATOMIC_NUMBERS[s] for s in vals], np.int64
                        )
                    continue
                arr = np.array(
                    [[float(x) for x in r[c0:c1]] for r in rows], np.float64
                )
                cols[name] = arr

            cell = None
            pbc = np.zeros(3, bool)
            if "Lattice" in info:
                cell = _floats(info["Lattice"]).reshape(3, 3)
                pbc = np.ones(3, bool)
            if "pbc" in info:
                pbc = np.array(
                    [t in ("T", "True", "1") for t in info["pbc"].split()], bool
                )
                if not pbc.any():
                    cell = cell if cell is not None and np.abs(cell).max() > 0 else None

            energy = None
            for key in ("free_energy", "energy"):
                if key in info:
                    energy = float(info[key])
                    break
            stress = None
            for key in ("stress", "virial"):
                if key in info:
                    vals = _floats(info[key])
                    stress = _voigt_or_tensor_to_label(vals)
                    if key == "virial":
                        vol = abs(np.linalg.det(cell)) if cell is not None else 1.0
                        stress = stress / vol * -1.0  # virial = stress*V, opposite sign
                    break

            forces = None
            for key in ("forces", "force"):
                if key in cols:
                    forces = cols[key]
                    break

            yield AtomsLite(
                positions=cols["pos"],
                numbers=numbers,
                cell=cell,
                pbc=pbc,
                energy=energy,
                forces=forces,
                stress=stress,
                info={k: v for k, v in info.items()
                      if k not in ("Lattice", "Properties", "pbc")},
            )


def read_extxyz(path: str, index: Optional[slice] = None) -> List[AtomsLite]:
    frames = list(iter_extxyz(path))
    if index is not None:
        frames = frames[index]
    return frames


def write_extxyz(path: str, frames, append: bool = False):
    mode = "a" if append else "w"
    with open(path, mode) as f:
        for at in frames:
            n = len(at)
            keys = []
            if at.cell is not None:
                keys.append(
                    'Lattice="' + " ".join(f"{x:.10f}" for x in at.cell.reshape(-1)) + '"'
                )
            props = "species:S:1:pos:R:3"
            if at.forces is not None:
                props += ":forces:R:3"
            keys.append(f"Properties={props}")
            if at.energy is not None:
                keys.append(f"energy={at.energy:.10f}")
            if at.stress is not None:
                # stored internal label -> ASE voigt
                s = -np.asarray(at.stress)
                ase_voigt = s[[0, 1, 2, 4, 5, 3]]
                keys.append(
                    'stress="' + " ".join(f"{x:.10e}" for x in ase_voigt) + '"'
                )
            keys.append('pbc="' + " ".join("T" if p else "F" for p in at.pbc) + '"')
            f.write(f"{n}\n{' '.join(keys)}\n")
            for i in range(n):
                row = f"{at.symbols[i]} " + " ".join(
                    f"{x:.10f}" for x in at.positions[i]
                )
                if at.forces is not None:
                    row += " " + " ".join(f"{x:.10f}" for x in at.forces[i])
                f.write(row + "\n")
