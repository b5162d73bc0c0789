"""VASP OUTCAR and POSCAR readers and SevenNet structure_list files (the
port's own copy of ``sevennet_tpu/data/vasp.py``, numpy only).

Covers the reference's OUTCAR ingestion (``sevenn/train/dataload.py:370-519``
via ASE's outcar chunk parsers) without an ASE dependency: lattice,
positions+forces, free energy, stress (kB -> internal label convention),
species from 'ions per type' + POTCAR titles.

structure_list format (reference docs): sections ``[label]`` followed by
``path [index]`` lines where index is an int or a python slice ``a:b:c``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np

from ..atoms import AtomsLite
from ..model.build import ATOMIC_NUMBERS

__all__ = ["read_outcar", "read_poscar", "read_structure_list"]

_FLOAT_RE = re.compile(r"[-+]?\d+\.\d+(?:[eE][-+]?\d+)?")


def _parse_species(lines: List[str]) -> List[int]:
    """Atomic numbers per atom from POTCAR titles + ions per type."""
    symbols: List[str] = []
    counts: List[int] = []
    for ln in lines:
        if "POTCAR:" in ln:
            m = re.search(r"POTCAR:\s+\S+\s+([A-Za-z]+)", ln)
            if m:
                sym = m.group(1).split("_")[0]
                if sym in ATOMIC_NUMBERS:
                    symbols.append(sym)
        if "ions per type" in ln:
            counts = [int(x) for x in ln.split("=")[1].split()]
            break
    # POTCAR titles appear twice in OUTCAR; dedupe the doubled prefix
    if counts and len(symbols) == 2 * len(counts):
        symbols = symbols[: len(counts)]
    assert counts and len(symbols) >= len(counts), "cannot parse OUTCAR species"
    numbers: List[int] = []
    for sym, cnt in zip(symbols, counts):
        numbers.extend([ATOMIC_NUMBERS[sym]] * cnt)
    return numbers


def read_outcar(path: str, index=slice(None)) -> List[AtomsLite]:
    with open(path) as f:
        lines = f.readlines()

    numbers = np.asarray(_parse_species(lines[:2000]), np.int64)
    n = len(numbers)

    frames: List[AtomsLite] = []
    cell: Optional[np.ndarray] = None
    i = 0
    kbar_to_evA3 = 1.0 / 1602.1766208  # kB -> eV/A^3
    pending_stress = None
    while i < len(lines):
        ln = lines[i]
        if "direct lattice vectors" in ln:
            # fixed-width columns can run together; regex-extract floats
            cell = np.array(
                [
                    [float(x) for x in _FLOAT_RE.findall(lines[i + 1 + k])[:3]]
                    for k in range(3)
                ]
            )
            i += 4
            continue
        if "in kB" in ln and "Total" not in ln:
            vals = [float(x) for x in ln.split()[2:8]]
            # VASP order XX YY ZZ XY YZ ZX, positive = compressive? VASP 'in kB'
            # reports the stress tensor; internal label = -stress in order
            # (xx,yy,zz,xy,yz,zx) eV/A^3; VASP sign: positive values mean
            # tension... VASP prints +P for compression, i.e. -sigma. So
            # sigma = -vals -> label = -sigma = +vals.
            pending_stress = np.array(vals) * kbar_to_evA3
            i += 1
            continue
        if "POSITION" in ln and "TOTAL-FORCE" in ln:
            pos = np.zeros((n, 3))
            frc = np.zeros((n, 3))
            for k in range(n):
                parts = _FLOAT_RE.findall(lines[i + 2 + k])
                pos[k] = [float(x) for x in parts[:3]]
                frc[k] = [float(x) for x in parts[3:6]]
            # find the energy after this block
            energy = None
            j = i + n
            while j < min(i + n + 60, len(lines)):
                if "free  energy   TOTEN" in lines[j]:
                    energy = float(lines[j].split()[-2])
                    break
                j += 1
            frames.append(
                AtomsLite(
                    positions=pos,
                    numbers=numbers,
                    cell=cell.copy() if cell is not None else None,
                    pbc=cell is not None,
                    energy=energy,
                    forces=frc,
                    stress=pending_stress,
                )
            )
            pending_stress = None
            i = j
            continue
        i += 1
    if isinstance(index, int):
        return [frames[index]]
    return frames[index]


def _parse_index(tok: Optional[str]):
    if tok is None or tok == ":":
        return slice(None)
    if ":" in tok:
        parts = [int(p) if p else None for p in tok.split(":")]
        return slice(*parts)
    return int(tok)


def read_structure_list(path: str, base_dir: Optional[str] = None) -> Dict[str, List[AtomsLite]]:
    """Parse a structure_list file -> {label: [AtomsLite...]}."""
    base = base_dir or os.path.dirname(os.path.abspath(path))
    out: Dict[str, List[AtomsLite]] = {}
    label = "data"
    with open(path) as f:
        for raw in f:
            ln = raw.strip()
            if not ln or ln.startswith("#"):
                continue
            m = re.fullmatch(r"\[(.+)\]", ln)
            if m:
                label = m.group(1).strip()
                continue
            toks = ln.split()
            fpath = toks[0]
            if not os.path.isabs(fpath):
                fpath = os.path.join(base, fpath)
            idx = _parse_index(toks[1] if len(toks) > 1 else None)
            if fpath.endswith((".xyz", ".extxyz")):
                from .extxyz import read_extxyz

                frames = read_extxyz(fpath)
                frames = [frames[idx]] if isinstance(idx, int) else frames[idx]
            else:
                frames = read_outcar(fpath, idx)
            out.setdefault(label, []).extend(frames)
    return out


def read_poscar(path: str) -> AtomsLite:
    """VASP POSCAR/CONTCAR (vasp5: symbol line before counts)."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    scale = float(lines[1].split()[0])
    cell = np.array(
        [[float(x) for x in lines[2 + i].split()[:3]] for i in range(3)]
    )
    if scale < 0:  # negative scale = target volume
        vol = abs(np.linalg.det(cell))
        scale = (-scale / vol) ** (1.0 / 3.0)
    cell = cell * scale
    toks = lines[5].split()
    if toks and toks[0].isdigit():  # vasp4: counts directly, symbols unknown
        raise ValueError(
            "vasp4 POSCAR without a symbol line is not supported - add the "
            "element symbols line (vasp5 format)"
        )
    symbols = toks
    counts = [int(x) for x in lines[6].split()[: len(symbols)]]
    i = 7
    if lines[i].strip() and lines[i].strip()[0] in "Ss":  # Selective dynamics
        i += 1
    cartesian = lines[i].strip() and lines[i].strip()[0] in "CcKk"
    i += 1
    n = sum(counts)
    coords = np.array(
        [[float(x) for x in lines[i + j].split()[:3]] for j in range(n)]
    )
    pos = coords * scale if cartesian else coords @ cell
    numbers = np.concatenate(
        [np.full(c, ATOMIC_NUMBERS[sym], np.int64)
         for sym, c in zip(symbols, counts)]
    )
    return AtomsLite(
        positions=pos, numbers=numbers, cell=cell, pbc=True
    )
