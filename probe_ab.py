#!/usr/bin/env python3
"""The batched-dot probe and the roll folds of one or more trees timed on one
card, in turns in one call.

Each tree's ``probes/batched_dot.py`` at ``GROUPS`` and N ``N_ATOMS`` (rep 1
and 4, timed by ``batched_dot_time``: best of 3 CUDA graphs of 10 calls;
the product's time on staged tiles is (rep 4 - rep 1) / 3) beside
``torch.bmm`` per group, and its ``probes/fold.py`` ``roll`` and ``bigroll``
at ``r3_fold_probe.py``'s shape (``diff_ms(fn, *FOLD_TIME)``) beside two
library forms: ``torch.sum`` over K alone (the fold without its column
map), and the whole function as two calls, ``torch.sum`` over K then
``torch.index_select`` by the column map. Each output is checked against
its plain version first (the batched dot within 1e-5 of max |plain|, the
folds within ``fold.TOL``); bounds are the bytes over HBM's rate.

    python3 probe_ab.py [--tree DIR]                    # one tree (default: this checkout)
    python3 probe_ab.py --compare DIR,DIR,... [--names a,b,...]

``--compare`` runs each tree in a process of its own, in the order given
(the same tree may come twice; each builds its own libraries), each run's
output in ``chiprun_out/probe_ab_<i>_<name>.log``; it prints a table and,
last, one JSON object with every run.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (chip_smoke.py HBM_BYTES_S)
RUN_TIMEOUT_S = 600
KERNELS = ("batched_dot_kernel", "probe_fold_roll_kernel")


def ptxas(so) -> dict:
    """Registers, stack bytes and spill bytes of each instance of KERNELS in
    library ``so``, from the ptxas report beside it."""
    rows, name = {}, None
    for ln in open(str(so) + ".log"):
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in KERNELS) else None
        elif name and "Used" in ln:
            rows.setdefault(name, {})["registers"] = int(re.search(r"Used (\d+) registers", ln)[1])
        elif name and "stack frame" in ln:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", ln)]
            rows.setdefault(name, {}).update(stack=nums[0], spill_stores=nums[1],
                                             spill_loads=nums[2])
    return rows


def one_tree(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from sevennet_tpu_torch.ops import kernels
    from sevennet_tpu_torch.probes import batched_dot as bd
    from sevennet_tpu_torch.probes import fold as fo
    from sevennet_tpu_torch.probes._lib import FOLD_TIME, diff_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    libs = kernels.build(["probe_batched_dot", "probe_fold"])
    dev = torch.device("cuda")
    res = dict(tree=tree, card=card.strip().splitlines()[0], ms={}, library_ms={}, bound_ms={},
               ptxas={k: v for so in libs.values() for k, v in ptxas(so).items()})

    gen = torch.Generator(device="cpu").manual_seed(8)
    Ss = [(torch.randn(bd.N_ATOMS, d3, kk, generator=gen) * 0.1).to(dev) for d3, kk, _ in bd.GROUPS]
    XWs = [(torch.randn(bd.N_ATOMS, kk, mul, generator=gen) * 0.1).to(dev)
           for _, kk, mul in bd.GROUPS]
    want = bd.batched_dot(Ss, XWs, plain=True)
    for rep in (1, 4):
        for i, (y, w) in enumerate(zip(bd.batched_dot(Ss, XWs, rep=rep), want)):
            if float((y - w).abs().max()) > 1e-5 * float(w.abs().max()):
                raise SystemExit(f"batched_dot rep {rep} group {i} differs from torch.bmm")
    del want
    for rep in (1, 4):
        res["ms"][f"batched_dot rep {rep}"] = bd.batched_dot_time(
            lambda: bd.batched_dot(Ss, XWs, rep=rep))
    res["ms"]["batched_dot staged product"] = (res["ms"]["batched_dot rep 4"]
                                               - res["ms"]["batched_dot rep 1"]) / 3
    res["library_ms"]["batched_dot"] = bd.batched_dot_time(lambda: bd.batched_dot_plain(Ss, XWs))
    res["bound_ms"]["batched_dot"] = bd.batched_dot_work(Ss, XWs)[1] / HBM_BYTES_S * 1e3
    del Ss, XWs
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cpu").manual_seed(10)
    nb = fo.N // fo.A
    fx = (torch.randn(nb * fo.A * fo.K, fo.DM // 8, generator=gen) * 0.5).to(dev)
    fm = fo.fold_matrix(fo.K, fo.A, dev)
    out = torch.empty(fo.N, fo.DM, device=dev)
    res["bound_ms"]["fold"] = fo.fold_work(nb)[1] / HBM_BYTES_S * 1e3
    res["library_ms"]["fold sum over K"] = diff_ms(lambda: fx.view(nb, fo.K, fo.A, -1).sum(1),
                                                   *FOLD_TIME)
    for v in ("roll", "bigroll"):
        want = fo.fold(fx, fm, variant=v, plain=True)
        err = float((fo.fold(fx, fm, variant=v, out=out) - want).abs().max())
        if err > fo.TOL * float(want.abs().max()):
            raise SystemExit(f"fold {v} differs from its plain version by {err}")
        del want
        res["ms"][f"fold {v}"] = diff_ms(lambda: fo.fold(fx, fm, variant=v, out=out), *FOLD_TIME)
        cmap = torch.as_tensor(fo.column_map(v), dtype=torch.long, device=dev)
        res["library_ms"][f"fold {v} sum + index_select"] = diff_ms(
            lambda: torch.index_select(fx.view(nb, fo.K, fo.A, -1).sum(1), 2, cmap), *FOLD_TIME)
    return res


def compare(trees, names) -> int:
    os.makedirs(OUT_DIR, exist_ok=True)
    results = []
    for i, (tree, name) in enumerate(zip(trees, names)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree],
                              capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
        with open(os.path.join(OUT_DIR, f"probe_ab_{i}_{name}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        print(f"run {i} ({name}, {tree}): exit {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:])
            return 1
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(results[0]["card"])
    for what in ("ms", "library_ms", "bound_ms"):
        for key in results[0][what]:
            vals = ", ".join(f"{names[j]} {r[what].get(key, float('nan')):.5f}"
                             for j, r in enumerate(results))
            print(f"  {what} {key}: {vals}")
    for j, r in enumerate(results):
        print(f"  ptxas {names[j]}: {r['ptxas']}")
    print(json.dumps(dict(names=names, results=results)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--compare", help="comma-separated trees, run in this order")
    ap.add_argument("--names", help="comma-separated names of the compared trees")
    args = ap.parse_args()
    if args.compare:
        trees = args.compare.split(",")
        names = args.names.split(",") if args.names else [str(i) for i in range(len(trees))]
        return compare(trees, names)
    import torch

    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(one_tree(args.tree)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
