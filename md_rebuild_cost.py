#!/usr/bin/env python3
"""What the MD engine's skin test costs on one card: K, the nearest cut
distance less the cutoff, device rebuilds per 100 steps and ms per step of
SevenNet-0 NVE on water, for one tree or several in turns in one call.

    python3 md_rebuild_cost.py [--tree DIR]              # one tree (default: this checkout)
    python3 md_rebuild_cost.py --compare DIR,DIR,... [--names a,b,...]
    python3 md_rebuild_cost.py --npt [--compare ...]     # the NPT runs instead

Runs, at ``chip_smoke.py``'s MD settings (SevenNet-0 with random weights
from ``--seed``, 0.5 fs steps in chunks of 10), ``--warmup`` steps, then
``--steps`` timed steps (host clock around synchronized steps): 3,000
atoms at 300 K, 9,999 at 300 K and 3,000 at 600 K. The water box starts as
a lattice whose neighbour counts rise as it melts, so K (sized at
``make_state``) usually grows once within the first 50 fs; the default
warm-up of 100 steps keeps that growth, and the chunk it retries, out of
the timed steps (the warm-up's growths and K at ``make_state`` are
printed). The force evaluations per 100 timed steps count retried steps.
The nearest cut distance
is read from a host list at the positions of a build (``make_state``'s and
the last rebuild's), so that it reads the same on a tree whose engine does
not record it. After the timed steps the pairs within the cutoff at the
final positions that hold no slot are counted (a host list), and one
device rebuild at those positions is timed alone (host clock around a
synchronized rebuild, median of 5). Prints one JSON line per tree.

``--npt`` runs instead what the NPT skin test costs, at ``chip_smoke.py``'s
ensemble settings: from one 3,000-atom state at 300 K (after 5 NVE steps
as warm-up), ``ENS_STEPS`` steps of ``npt`` and of ``npt_berendsen``
(``ENSEMBLES``), each three times from that state (device rebuilds and
force evaluations of a run, the least ms/step of the three), and the same
with D3 for ``npt`` (``D3_NPT_STEPS`` steps, once).

``--compare`` runs each tree in a process of its own, in the order given
(the same tree may come twice), with the kernels built once in the first
tree and copied to the others (the libraries are keyed by their sources);
each run's output goes to ``chiprun_out/md_rebuild_cost_<i>_<name>.log``;
it prints a table and, last, one JSON object with every run.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
# (water molecules, temperature in K) of each run
RUNS = ((1000, 300.0), (3333, 300.0), (1000, 600.0))
RUN_TIMEOUT_S = 600


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its water box, spec,
    card line and host-list helpers), whatever tree the port comes from."""
    path = os.path.join(HERE, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_tree(tree: str, seed: int, steps: int, warmup: int, device: str = "cuda") -> dict:
    """The three runs with the port of ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    cs = _chip_smoke()
    import numpy as np
    import torch

    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.md import MDEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = cs.sevennet0_spec()
    params = params_from_numpy(spec, random_params(spec, seed))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = dict(tree=tree, card=cs.gpu_line() if device == "cuda" else device, runs=[])
    for molecules, temp in RUNS:
        pos, Z, cell = cs.water_box(molecules)
        eng = MDEngine(spec, params, cell, device=device)
        st = eng.make_state(pos, Z, temperature=temp, seed=seed)
        k_first, first = eng.k_model, cs.cut_margin(eng, st)
        st, _ = eng.run(st, warmup, dt=cs.MD_DT, chunk=cs.MD_CHUNK)
        r0, g0 = eng.n_rebuilds, eng.n_growths
        evals = cs.record_evaluations(eng)
        sync()
        t0 = time.perf_counter()
        st, (pe, ke) = eng.run(st, steps, dt=cs.MD_DT, chunk=cs.MD_CHUNK)
        sync()
        ms = (time.perf_counter() - t0) / steps * 1e3
        etot = (pe + ke).cpu().numpy()
        rebuilds, growths = eng.n_rebuilds - r0, eng.n_growths - g0
        missing = cs.missing_pairs(eng, st)
        times = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            eng._rebuild(st)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out["runs"].append(dict(
            atoms=len(pos), T=temp, K_first=k_first, growths_warmup=g0, K=eng.k_model,
            capacity=eng.cl_spec.neighbor_capacity, cut_margin_first=first,
            cut_margin_last=cs.cut_margin(eng, st),
            rebuilds_per_100=100.0 * rebuilds / steps, growths=growths,
            evals_per_100=100.0 * len(evals) / steps,
            ms_per_step=ms, rebuild_ms=float(np.median(times)),
            e_drift=float(np.abs(etot - etot[0]).max()), missing=missing))
        del eng, st
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def npt_tree(tree: str, seed: int, device: str = "cuda") -> dict:
    """The NPT runs (``--npt``) with the port of ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    cs = _chip_smoke()
    import torch

    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.md import MDEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = cs.sevennet0_spec()
    params = params_from_numpy(spec, random_params(spec, seed))
    pos, Z, cell = cs.water_box(1000)
    out = dict(tree=tree, card=cs.gpu_line() if device == "cuda" else device, runs={})
    for d3 in (None, cs.D3):
        eng = MDEngine(spec, params, cell, device=device, d3=d3)
        start = eng.make_state(pos, Z, temperature=cs.MD_T, seed=seed)
        eng.run(start, 5, dt=cs.MD_DT, chunk=5)  # warm-up
        names = ("npt", "npt_berendsen") if d3 is None else ("npt",)
        steps = cs.ENS_STEPS if d3 is None else cs.D3_NPT_STEPS
        for name in names:
            best = None
            for _ in range(3 if d3 is None else 1):
                evals = cs.record_evaluations(eng)
                r0 = eng.n_rebuilds
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = eng.run(start, steps, dt=cs.MD_DT, chunk=steps, integrator=name,
                                **cs.ENSEMBLES[name])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / steps * 1e3
                del eng._forces
                run = dict(steps=steps, rebuilds=eng.n_rebuilds - r0, evals=len(evals),
                           ms_per_step=ms, volume_rel=float(st.volume() / start.volume()) - 1.0)
                if best is None or ms < best["ms_per_step"]:
                    best = run
            out["runs"][name + ("_d3" if d3 else "")] = best
        del eng, start
        torch.cuda.empty_cache()
    return out


def _npt_table(results, names):
    for run in results[0]["runs"]:
        print(f"{run}:")
        for k in ("steps", "rebuilds", "evals", "ms_per_step", "volume_rel"):
            vals = ", ".join(f"{names[j]} {r['runs'][run][k]:.6g}" for j, r in enumerate(results))
            print(f"  {k}: {vals}")


def _table(results, names):
    keys = ("K_first", "growths_warmup", "K", "cut_margin_first", "cut_margin_last",
            "rebuilds_per_100", "evals_per_100", "ms_per_step", "rebuild_ms", "growths",
            "missing")
    for i, (molecules, temp) in enumerate(RUNS):
        print(f"{3 * molecules} atoms, {temp:g} K:")
        for k in keys:
            vals = ", ".join(f"{names[j]} {r['runs'][i][k]:.4g}" for j, r in enumerate(results))
            print(f"  {k}: {vals}")


def compare(trees, names, seed: int, steps: int, warmup: int, npt: bool = False) -> int:
    os.makedirs(OUT_DIR, exist_ok=True)
    results = []
    for i, (tree, name) in enumerate(zip(trees, names)):
        if i:  # the kernels of the first tree, for the others
            src = os.path.join(trees[0], "build", "kernels")
            dst = os.path.join(tree, "build", "kernels")
            os.makedirs(dst, exist_ok=True)
            for lib in glob.glob(os.path.join(src, "*.so")):
                if not os.path.exists(os.path.join(dst, os.path.basename(lib))):
                    shutil.copy2(lib, dst)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree,
                               "--seed", str(seed), "--steps", str(steps),
                               "--warmup", str(warmup)] + ["--npt"] * npt,
                              capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
        log = f"md_rebuild_cost_{'npt_' if npt else ''}{i}_{name}.log"
        with open(os.path.join(OUT_DIR, log), "w") as f:
            f.write(proc.stdout + proc.stderr)
        print(f"run {i} ({name}, {tree}): exit {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:])
            return 1
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(results[0]["card"])
    (_npt_table if npt else _table)(results, names)
    print(json.dumps(dict(names=names, results=results)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--compare", help="comma-separated trees, run in this order")
    ap.add_argument("--names", help="comma-separated names of the compared trees")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--npt", action="store_true", help="the NPT runs instead")
    args = ap.parse_args()
    if args.compare:
        trees = args.compare.split(",")
        names = args.names.split(",") if args.names else [str(i) for i in range(len(trees))]
        return compare(trees, names, args.seed, args.steps, args.warmup, args.npt)
    import torch

    if not torch.cuda.is_available():
        print("md_rebuild_cost: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(npt_tree(args.tree, args.seed) if args.npt
                     else one_tree(args.tree, args.seed, args.steps, args.warmup)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
