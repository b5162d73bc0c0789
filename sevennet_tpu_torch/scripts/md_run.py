"""``sevennet-tpu-torch md``: molecular dynamics from a YAML input (the port
of ``sevennet_tpu/scripts/md_run.py``; the role LAMMPS input scripts play
for the reference's deployed pair styles, ``sevenn/pair_e3gnn``).

Input schema (every ``md:`` key optional except ``structure``), the JAX
package's keys and defaults:

```yaml
md:
  checkpoint: 7net-0            # pretrained name / .pth / checkpoint dir
  structure: ./start.extxyz     # extxyz (last frame) or VASP POSCAR
  ensemble: nvt                 # nve | nvt/nose_hoover | langevin |
                                # npt/npt_mtk/npt_nose_hoover | npt_berendsen
  steps: 10000
  dt: 1.0                       # fs
  temperature: 300.0            # K (initial velocities + thermostat)
  pressure: 0.0                 # eV/A^3 (npt only)
  tau_t: 100.0                  # fs (npt only; optional)
  tau_p: 1000.0                 # fs (npt only; optional)
  skin: 0.6
  seed: 0
  chunk: 20                     # steps per chunk (thermo rows, traj rounding)
  trajectory: traj.extxyz       # extxyz dump (optional)
  traj_every: 100
  log: md_thermo.csv            # per-chunk thermo CSV
  d3:                           # optional dispersion (pair_d3 analogue)
    functional: pbe
    damping: damp_bj
```

The JAX package's ``precision`` and ``fused`` keys are accepted and
ignored (the port runs fp32 and its kernels on the card), so that its
input files run unchanged. The engine runs on ``device`` (``cuda`` unless
``"cpu"``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

__all__ = ["run_md_from_config"]


def _load_structure(path: str):
    if path.endswith((".xyz", ".extxyz")):
        from ..data.extxyz import read_extxyz

        frames = read_extxyz(path)
        if not frames:
            raise ValueError(f"no frames in {path}")
        return frames[-1]
    # VASP POSCAR/CONTCAR
    from ..data.vasp import read_poscar

    return read_poscar(path)


def run_md_from_config(cfg: Dict, log=print, device: Optional[str] = None) -> Dict:
    """Runs the ``md:`` block of ``cfg`` (or ``cfg`` itself); returns
    ``{"state", "thermo", "engine"}``: the final state, the thermo rows
    (one per chunk: step, pe, ke, temperature, pressure on the last row,
    walltime) and the engine."""
    md = dict(cfg.get("md", cfg))
    if "structure" not in md:
        raise ValueError("md.structure is required")

    from ..io.registry import load_model
    from ..md import MDEngine
    from ..md.state import KB_EV

    ignored = [k for k in ("precision", "fused") if k in md]
    if ignored:
        log(f"md: {', '.join(ignored)} ignored (the port runs fp32, its kernels on the card)")
    spec, params = load_model(md.get("checkpoint", "7net-0"))
    at = _load_structure(md["structure"])
    if at.cell is None or not np.asarray(at.pbc).any():
        raise ValueError("MD requires a periodic cell")

    engine = MDEngine(spec, params, at.cell, skin=float(md.get("skin", 0.6)), d3=md.get("d3"),
                      device=device)
    state = engine.make_state(
        at.positions, at.numbers,
        temperature=float(md["temperature"]) if md.get("temperature") else None,
        seed=int(md.get("seed", 0)),
    )

    ensemble = str(md.get("ensemble", "nve")).lower()
    kw = {}
    if ensemble in ("nvt", "nose_hoover", "langevin"):
        kw["temperature"] = float(md.get("temperature", 300.0))
    if ensemble in ("npt", "npt_mtk", "npt_nose_hoover", "npt_berendsen"):
        kw["temperature"] = float(md.get("temperature", 300.0))
        kw["pressure"] = float(md.get("pressure", 0.0))
        if md.get("tau_t"):
            kw["tau_t"] = float(md["tau_t"])
        if md.get("tau_p"):
            kw["tau_p"] = float(md["tau_p"])

    steps = int(md.get("steps", 1000))
    dt = float(md.get("dt", 1.0))
    chunk = int(md.get("chunk", 20))
    log_path = md.get("log")
    t0 = time.time()
    # one run() call: it loops the chunks itself and owns the trajectory
    # file (re-entering would restart the dump)
    state, (pe, ke) = engine.run(
        state, steps, dt=dt, integrator=ensemble, chunk=chunk,
        traj_path=md.get("trajectory"), traj_every=int(md.get("traj_every", 0)), **kw,
    )
    pe = pe.cpu().numpy()
    ke = ke.cpu().numpy()
    wall = time.time() - t0

    ndof = 3 * max(int(state.atom_mask.sum()), 1)
    rows = []
    for s in range(chunk - 1, steps, chunk):
        rows.append(
            dict(step=s + 1, pe=float(pe[s]), ke=float(ke[s]),
                 temperature=float(2.0 * ke[s] / (ndof * KB_EV)),
                 pressure=float(state.pressure()) if s == steps - 1 else "",
                 walltime=wall * (s + 1) / steps)
        )
    if rows:
        log(
            f"{steps} steps in {wall:.1f}s ({1e3 * wall / steps:.1f} "
            f"ms/step): PE {rows[-1]['pe']:+.4f} eV, "
            f"T {rows[-1]['temperature']:.1f} K"
        )
    if log_path and rows:
        import csv

        with open(log_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        log(f"thermo log written to {log_path}")
    return {"state": state, "thermo": rows, "engine": engine}
