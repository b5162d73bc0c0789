#!/usr/bin/env python3
"""The transpose probes of one or more trees timed on one card, in turns in
one call: each variant of ``probes/xpose.py`` as ``chip_smoke.py`` times it
(``xpose`` and the round trip ``xpose2`` at ``STREAM_SHAPE`` by
``stream_time``, 8 calls in one CUDA graph over 8; the carried transpose at
``CARRY_SHAPES[0]`` by ``diff_ms(fn, *R2_TIME)``), beside the library calls
(``x.t().contiguous()``, ``x.clone()``, 16 ``a.t().contiguous()``) and the
byte bound, each output checked against its plain version (bitwise; the
carried form within ``CARRY_TOL`` of max |plain|).

    python3 xpose_ab.py [--tree DIR]                    # one tree (default: this checkout)
    python3 xpose_ab.py --compare DIR,DIR,... [--names a,b,...]

``--compare`` runs each tree in a process of its own, in the order given
(the same tree may come twice; each builds its own ``probe_xpose``), each
run's output in ``chiprun_out/xpose_ab_<i>_<name>.log``; it prints a table
and, last, one JSON object with every run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (chip_smoke.py HBM_BYTES_S)
RUN_TIMEOUT_S = 300


def one_tree(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from sevennet_tpu_torch.probes import xpose as xp
    from sevennet_tpu_torch.probes._lib import R2_TIME, diff_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(10)
    xs = (torch.randn(*xp.STREAM_SHAPE, generator=gen) * 0.3).to(dev)
    a = torch.randn(*xp.CARRY_SHAPES[0], generator=gen).to(dev)
    s = torch.zeros((1, 1), device=dev)
    s_chk = torch.full((1, 1), 1e-3, device=dev)
    out_t = torch.empty(xs.shape[1], xs.shape[0], device=dev)
    out_s = torch.empty_like(xs)
    res = dict(tree=tree, card=card.strip().splitlines()[0], ms={}, library_ms={},
               bound_ms=8 * xs.numel() / HBM_BYTES_S * 1e3)
    for v in xp.VARIANTS:
        for key, fn, o in (("xpose", xp.xpose, out_t), ("xpose2", xp.xpose2, out_s)):
            o.fill_(float("nan"))
            if not torch.equal(fn(xs, v, out=o), fn(xs, v, plain=True)):
                raise SystemExit(f"{key} {v} differs from its plain version")
            res["ms"][f"{key} {v}"] = xp.stream_time(lambda: fn(xs, v, out=o))
        got, want = xp.transpose_carry(a, s_chk, v), xp.transpose_carry(a, s_chk, v, plain=True)
        if float((got - want).abs().max()) > xp.CARRY_TOL * float(want.abs().max()):
            raise SystemExit(f"transpose {v} differs from its plain version")
        res["ms"][f"transpose {v}"] = diff_ms(lambda: xp.transpose_carry(a, s, v), *R2_TIME)
    res["library_ms"]["xpose"] = xp.stream_time(lambda: xs.t().contiguous())
    res["library_ms"]["xpose2"] = xp.stream_time(lambda: xs.clone())
    res["library_ms"]["transpose"] = diff_ms(
        lambda: [a.t().contiguous() for _ in range(xp.REP)], *R2_TIME)
    return res


def compare(trees, names) -> int:
    os.makedirs(OUT_DIR, exist_ok=True)
    results = []
    for i, (tree, name) in enumerate(zip(trees, names)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree],
                              capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
        with open(os.path.join(OUT_DIR, f"xpose_ab_{i}_{name}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        print(f"run {i} ({name}, {tree}): exit {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:])
            return 1
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(results[0]["card"], f"| bound (bytes) {results[0]['bound_ms']:.5f} ms")
    for key in results[0]["ms"]:
        lib = key.split()[0]
        vals = ", ".join(f"{names[j]} {r['ms'][key]:.5f}" for j, r in enumerate(results))
        libs = ", ".join(f"{r['library_ms'][lib]:.5f}" for r in results)
        print(f"  {key} ms: {vals} (library {libs})")
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
        print("xpose_ab: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(one_tree(args.tree)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
