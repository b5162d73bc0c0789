#!/usr/bin/env python3
"""Parent against change on one card: ``chip_smoke.py`` of two trees run in
turns in one call.

    python3 ab_compare.py prepare [--parent REV]   # in the git checkout
    python3 ab_compare.py run [--order parent,change,change,parent] [--breakdown]

``prepare`` unpacks two ``git archive``s under ``build/ab`` (git-ignored):
``parent`` from ``REV`` (default ``HEAD``) and ``change`` from the tree of
the index (``git write-tree``: stage the change with ``git add -A`` first).
``run``, on the card from the root of the checkout, runs ``python3
chip_smoke.py`` in each tree in the given order, one after the other, each
building its own kernels, and writes each run's output to
``chiprun_out/ab_<i>_<tree>.log``. With ``--breakdown`` it then runs the
``change`` tree's ``conv_breakdown.py`` on the ``change`` tree and on the
``parent`` tree (``--tree``; ``chiprun_out/ab_breakdown_<tree>.log``).

It prints, per metric, each run's number and the change's mean against the
parent's: each kernel's ms from the ``kernels`` line (per 3,000-atom pass;
``fused_conv_bwd_slot`` per 99,999-atom ring force evaluation), model and
request ms at 3,000 atoms, the train steps, MD ms/step at 9,999 atoms and on
the 99,999-atom ring, and SevenNet-MF-ompa's B1, B2 and B2′ per layer at
3,000 atoms, its model ms at 3,000 atoms (each modality) and its train
step. The last line is one JSON object with every number, also written to
``chiprun_out/ab_compare.json``. Exits non-zero if a run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
AB_DIR = os.path.join(ROOT, "build", "ab")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
RUN_TIMEOUT_S = 900

# metric -> pattern of chip_smoke.py's log whose first group is the number
PATTERNS = {
    "model ms, 3,000 atoms vec": r"^\s*vec 3000 atoms: .* model median ([\d.]+) ms",
    "model ms, 3,000 atoms legacy": r"^\s*legacy 3000 atoms: .* model median ([\d.]+) ms",
    "request ms, 3,000 atoms vec": r"^\s*vec 3000 atoms: .* request median ([\d.]+) ms",
    "train step ms vec": r"^\s*train step: median ([\d.]+) ms",
    "train step ms legacy": r"^\s*legacy train step: median ([\d.]+) ms",
    "MD ms/step, 9,999 atoms": r"timed NVE steps: ([\d.]+) ms/step",
    "MD ms/step, 99,999 atoms (ring)": r"timed ring steps: ([\d.]+) ms/step",
    "mf-ompa model ms, 3,000 atoms mpa": r"^\s*mf-ompa mpa 3000 atoms: .* model median ([\d.]+) ms",
    "mf-ompa model ms, 3,000 atoms omat24":
        r"^\s*mf-ompa omat24 3000 atoms: .* model median ([\d.]+) ms",
    "mf-ompa train step ms": r"^\s*mf-ompa train step .*: median ([\d.]+) ms",
}
# SevenNet-MF-ompa's kernels per layer at 3,000 atoms (the mf-ompa phase)
MF_PATTERN = r"^\s*mf-ompa layer (\d) \(3000 atoms\) (fwd|bwd|bwd_pg): kernel ([\d.]+) ms"
MF_NAMES = {"fwd": "B1", "bwd": "B2", "bwd_pg": "B2'"}


def prepare(parent: str) -> int:
    change = subprocess.run(["git", "write-tree"], cwd=ROOT, check=True, text=True,
                            capture_output=True).stdout.strip()
    for name, rev in (("parent", parent), ("change", change)):
        dest = os.path.join(AB_DIR, name)
        shutil.rmtree(dest, ignore_errors=True)
        os.makedirs(dest)
        archive = subprocess.run(["git", "archive", rev], cwd=ROOT, check=True,
                                 capture_output=True).stdout
        subprocess.run(["tar", "-x", "-C", dest], input=archive, check=True)
        print(f"{name}: {rev} -> {os.path.relpath(dest, ROOT)}")
    return 0


def parse(log: str) -> dict:
    """The metrics of one ``chip_smoke.py`` output."""
    out = {}
    for metric, pat in PATTERNS.items():
        m = re.search(pat, log, re.M)
        out[metric] = float(m.group(1)) if m else None
    for t, kind, ms in re.findall(MF_PATTERN, log, re.M):
        out[f"mf-ompa layer {t} {MF_NAMES[kind]} ms, 3,000 atoms"] = float(ms)
    for line in log.splitlines():
        if line.startswith('{"kernels"'):
            for k in json.loads(line)["kernels"]:
                out.setdefault(f"{k['name']} ms", k["ms"])
    return out


def run(order, breakdown: bool) -> int:
    os.makedirs(OUT_DIR, exist_ok=True)
    runs, card = [], None
    for i, name in enumerate(order, 1):
        tree = os.path.join(AB_DIR, name)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              timeout=RUN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        with open(os.path.join(OUT_DIR, f"ab_{i}_{name}.log"), "w") as f:
            f.write(proc.stdout)
        lines = proc.stdout.strip().splitlines()
        card = card or (lines[-2] if len(lines) > 1 else None)
        runs.append(dict(tree=name, rc=proc.returncode, s=round(wall, 1),
                         metrics=parse(proc.stdout)))
        print(f"run {i} {name}: exit {proc.returncode}, {wall:.1f} s", flush=True)
    rcs = [r["rc"] for r in runs]
    if breakdown:
        script = os.path.join(AB_DIR, "change", "conv_breakdown.py")
        for name in ("change", "parent"):
            tree = os.path.join(AB_DIR, name)
            proc = subprocess.run([sys.executable, script, "--tree", tree], cwd=tree, text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  timeout=RUN_TIMEOUT_S)
            with open(os.path.join(OUT_DIR, f"ab_breakdown_{name}.log"), "w") as f:
                f.write(proc.stdout)
            print(f"conv_breakdown.py on {name}: exit {proc.returncode}", flush=True)
            rcs.append(proc.returncode)

    table = {}
    print(f"{'metric':44s}" + "".join(f"{r['tree']:>12s}" for r in runs)
          + "  change vs parent (means)")
    for metric in runs[0]["metrics"]:
        vals = [r["metrics"].get(metric) for r in runs]
        by = {t: [v for r, v in zip(runs, vals) if r["tree"] == t and v is not None]
              for t in ("parent", "change")}
        rel = (statistics.mean(by["change"]) / statistics.mean(by["parent"]) - 1
               if by["parent"] and by["change"] else None)
        table[metric] = dict(runs=vals, change_vs_parent=rel)
        print(f"{metric:44s}" + "".join(f"{'-' if v is None else f'{v:.3f}':>12s}"
                                         for v in vals)
              + (f"  {100 * rel:+.1f} %" if rel is not None else ""))
    print(card, flush=True)
    result = dict(card=card, order=list(order),
                  runs=[{k: r[k] for k in ("tree", "rc", "s")} for r in runs],
                  metrics=table)
    with open(os.path.join(OUT_DIR, "ab_compare.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0 if not any(rcs) else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prepare")
    p.add_argument("--parent", default="HEAD")
    r = sub.add_parser("run")
    r.add_argument("--order", default="parent,change,change,parent")
    r.add_argument("--breakdown", action="store_true")
    args = ap.parse_args()
    if args.cmd == "prepare":
        return prepare(args.parent)
    return run(args.order.split(","), args.breakdown)


if __name__ == "__main__":
    sys.exit(main())
