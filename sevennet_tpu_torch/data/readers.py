"""Universal structure readers: format dispatch + optional ASE fallback (the
port's own copy of ``sevennet_tpu/data/readers.py``).

The reference ingests anything ASE reads (``sevenn/train/dataload.py:
351-519``: extxyz via ase.io.read, OUTCAR/structure_list natively, and a
generic ``ase.io.read`` fallback for every other format). This framework is
self-contained for the common formats (extxyz, OUTCAR, POSCAR,
structure_list) and routes unknown extensions through ``ase.io.read`` when
ASE is importable — with a clear error otherwise.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..atoms import AtomsLite

__all__ = ["read_structures"]


def _from_ase(at) -> AtomsLite:
    cell = np.asarray(at.get_cell())
    if not np.abs(cell).max() > 0:
        cell = None
    energy = forces = stress = None
    calc = getattr(at, "calc", None)
    if calc is not None and getattr(calc, "results", None):
        r = calc.results
        energy = r.get("energy", r.get("free_energy"))
        forces = r.get("forces")
        stress = r.get("stress")
    info = dict(getattr(at, "info", {}) or {})
    if energy is None:
        energy = info.get("energy", info.get("free_energy"))
    if forces is None and hasattr(at, "arrays"):
        forces = at.arrays.get("forces")
    return AtomsLite(
        positions=np.asarray(at.get_positions()),
        numbers=np.asarray(at.get_atomic_numbers()),
        cell=cell,
        pbc=np.asarray(at.get_pbc()),
        energy=None if energy is None else float(energy),
        forces=None if forces is None else np.asarray(forces, np.float64),
        stress=None if stress is None else np.asarray(stress, np.float64),
        info=info,
    )


def read_structures(path: str) -> List[AtomsLite]:
    """Read every frame of ``path``, dispatching on the file name
    (``dataload.py:351-519`` semantics):

    - ``*.xyz`` / ``*.extxyz``: native extxyz reader;
    - ``OUTCAR*``: native VASP OUTCAR trajectory reader;
    - ``POSCAR*`` / ``CONTCAR*`` / ``*.vasp``: native POSCAR reader;
    - ``structure_list*``: every labeled OUTCAR slice it references;
    - anything else: ``ase.io.read(path, index=':')`` when ASE is
      installed (``.cif``, ``.traj``, ``.json``, LAMMPS dumps, ...).
    """
    base = os.path.basename(path)
    low = base.lower()
    if low.endswith((".xyz", ".extxyz")):
        from .extxyz import read_extxyz

        return read_extxyz(path)
    if base.startswith("OUTCAR") or low.endswith("outcar"):
        from .vasp import read_outcar

        return read_outcar(path)
    if (
        base.startswith(("POSCAR", "CONTCAR"))
        or low.endswith((".vasp", "poscar", "contcar"))
    ):
        from .vasp import read_poscar

        return [read_poscar(path)]
    if base.startswith("structure_list"):
        from .vasp import read_structure_list

        frames: List[AtomsLite] = []
        for flist in read_structure_list(path).values():
            frames.extend(flist)
        return frames
    try:
        import ase.io  # noqa: F401  (optional dependency)
    except ImportError as e:
        raise ValueError(
            f"unrecognized structure format: {path!r} — native readers "
            "cover .xyz/.extxyz, OUTCAR, POSCAR/CONTCAR/.vasp and "
            "structure_list; install ASE to read anything ase.io.read "
            "supports (reference behavior, sevenn/train/dataload.py:351)"
        ) from e
    frames = ase.io.read(path, index=":")
    if not isinstance(frames, list):
        frames = [frames]
    return [_from_ase(a) for a in frames]
