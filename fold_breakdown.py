#!/usr/bin/env python3
"""Where the fold probe's mxu kernels spend their time, on one NVIDIA GPU.

    python3 fold_breakdown.py [--roll]

Builds ``sevennet_tpu_torch/csrc/probe_fold.cu`` as it is and, as builds of
their own, with phases of the mxu kernel knocked out
(``-DFOLD_MMA_KO=k``: 1 the products, 2 the loads of x from shared memory,
3 the TMA loads and the waits for them, 4 the split into bf16 pieces; 5
all but the products, 6 the products and the TMA loads, 7 the TMA loads
and one engine in each consumer warpgroup), and with clocks
(``-DFOLD_MMA_PROF``: each consumer warpgroup's cycles in its stage loop,
waiting for stages and releasing them, rank 0 apart from the other ranks,
printed as shares), then times ``mxu2`` and ``mxu3`` in each build at ``r3_fold_probe.py``'s shape (N
10,016, K 72, A 32, DM 3,136) by the script's differential
(``probes/_lib.py:diff_ms`` at ``FOLD_TIME``, CUDA graphs), the builds in
turns (normal, each knock-out, normal). The normal build is first held
against the plain version (``fold.TOL``). Prints each time, its saving
against the normal build's mean, and each build's ptxas report; writes the
normal build's SASS to ``chiprun_out/fold_sass.txt``. The last line is one
JSON object with every number, also written to
``chiprun_out/fold_breakdown.json``. A knock-out's output is not the
function's; only its time is read.

``--roll`` does the same for the roll kernel instead (``roll_breakdown``):
its folds or its TMA copies knocked out (``-DFOLD_ROLL_KO=1``, ``2``) and
12 consumer warps (``-DFR_CW=12``), at slices of 28, 56 and 112 columns,
written to ``chiprun_out/roll_breakdown.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import threading

KNOCKOUTS = {1: "no products", 2: "no loads", 3: "no TMA, no waits", 4: "no split",
             5: "products alone", 6: "loads and split alone",
             7: "products in one warpgroup, loads and split in the other"}
PROF = "clocks"  # FOLD_MMA_PROF: each consumer warpgroup's stage loop, waits, releases


ROLL_BUILDS = {"normal": (), "no folds": ("FOLD_ROLL_KO=1",), "no TMA": ("FOLD_ROLL_KO=2",),
               "12 consumer warps": ("FR_CW=12",)}
ROLL_SWS = (28, 56, 112)  # input columns a slice (ROLL_SW is 56)


def roll_breakdown(card: str) -> dict:
    """``--roll``: the roll kernel's builds (ROLL_BUILDS: as it is, its folds
    knocked out, its TMA copies knocked out, 12 consumer warps instead of 8)
    at each slice width of ROLL_SWS, roll and bigroll at r3_fold_probe.py's
    shape, timed by diff_ms at FOLD_TIME in turns (normal first and last);
    the normal build first held against plain (fold.TOL)."""
    import torch

    from sevennet_tpu_torch.ops import kernels
    from sevennet_tpu_torch.probes import fold as fo
    from sevennet_tpu_torch.probes._lib import FOLD_TIME, diff_ms, stream

    threads = [threading.Thread(target=kernels.build, args=(["probe_fold"], False, d))
               for d in ROLL_BUILDS.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    fns = {}
    for name, defines in ROLL_BUILDS.items():
        so = kernels.build(["probe_fold"], False, defines)["probe_fold"]
        entry = ""
        for ln in open(str(so) + ".log"):
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = m.group(1)
            elif "probe_fold_roll_kernelILi72ELb1" in entry and "Used" in ln:
                print(f"ptxas {name} roll<K 72, 16-byte runs>: {ln.strip()}", flush=True)
        fn = kernels.library("probe_fold", defines=defines).probe_fold_roll_launch
        fn.argtypes = [ctypes.c_int, fo._RollArgs, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(10)
    nb, dx = fo.N // fo.A, fo.DM // 8
    x = (torch.randn(nb * fo.A * fo.K, dx, generator=gen) * 0.5).to(dev)
    out = torch.empty(fo.N, fo.DM, device=dev)
    keep = []

    def args(v, sw):
        rp = fo.roll_plan(fo.column_map(v), dx, fo.K, sw)
        units = torch.as_tensor(rp.units, device=dev).contiguous()
        uoff = torch.as_tensor(rp.uoff, device=dev)
        keep.append((units, uoff))
        return fo._RollArgs(x.data_ptr(), out.data_ptr(), units.data_ptr(), uoff.data_ptr(), nb,
                            fo.A, dx, fo.DM, rp.sw, rp.nsl, rp.ns, int(rp.vec))

    def call(name, a):
        rc = fns[name](fo.K, a, stream(dev))
        if rc:
            raise RuntimeError(f"probe_fold_roll_launch failed with error {rc}")

    res = {}
    for v in ("roll", "bigroll"):
        for sw in ROLL_SWS:
            a = args(v, sw)
            call("normal", a)
            want = fo.fold(x, fo.fold_matrix(fo.K, fo.A, dev), variant=v, plain=True)
            rel = float((out - want).abs().max()) / float(want.abs().max())
            del want
            if not rel <= fo.TOL:
                raise SystemExit(f"roll {v} at slices of {sw} disagrees with plain: {rel:.3e}")
            for name in [*ROLL_BUILDS, "normal (again)"]:
                ms = diff_ms(lambda: call(name.split(" (")[0], a), *FOLD_TIME)
                res[f"{v} sw {sw} {name}"] = ms
                print(f"roll {v}, slices of {sw} columns, {name}: {ms:.4f} ms per call | {card}",
                      flush=True)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fold_breakdown: no CUDA device", file=sys.stderr)
        return 2
    if "--roll" in sys.argv[1:]:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        res = roll_breakdown(card)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "roll_breakdown.json"), "w") as f:
            json.dump({"card": card, "ms": res}, f, indent=1)
        print(json.dumps({"card": card, "ms": res}), flush=True)
        return 0
    from sevennet_tpu_torch.ops import kernels
    from sevennet_tpu_torch.probes import fold as fo
    from sevennet_tpu_torch.probes._lib import FOLD_TIME, diff_ms, stream

    out_dir = os.path.abspath("chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    builds = {"normal": ()}
    builds.update({KNOCKOUTS[k]: (f"FOLD_MMA_KO={k}",) for k in KNOCKOUTS})
    builds[PROF] = ("FOLD_MMA_PROF=1",)
    threads = [threading.Thread(target=kernels.build, args=(["probe_fold"], False, d))
               for d in builds.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    libs = {}
    for name, defines in builds.items():
        so = kernels.build(["probe_fold"], False, defines)["probe_fold"]
        for ln in open(str(so) + ".log"):
            if re.search(r"Used \d+ registers|spill|serialized", ln):
                print(f"ptxas {name}: {ln.strip()}", flush=True)
        lib = kernels.library("probe_fold", defines=defines)
        fn = lib.probe_fold_launch
        fn.argtypes = [ctypes.c_int, fo._FoldArgs, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(kernels.build(["probe_fold"])["probe_fold"])],
                          capture_output=True, text=True).stdout
    with open(os.path.join(out_dir, "fold_sass.txt"), "w") as f:
        f.write(sass)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(10)
    nb = fo.N // fo.A
    x = (torch.randn(nb * fo.A * fo.K, fo.DM // 8, generator=gen) * 0.5).to(dev)
    fm = fo.fold_matrix(fo.K, fo.A, dev)
    out = torch.empty(fo.N, fo.DM, device=dev)
    plan = fo.mma_plan(fo.DM // 8, fo.DM, fo.A)
    cmap_np = fo.column_map("mxu2")
    cmap = torch.as_tensor(cmap_np, device=dev)
    bq = torch.empty(fo.K * fo.A // fo.MMA_R * fo.MMA_BBYTES, dtype=torch.uint8, device=dev)

    def fold_args(ns):
        return fo._FoldArgs(x.data_ptr(), fm.data_ptr(), cmap.data_ptr(), out.data_ptr(),
                            bq.data_ptr(), nb, fo.K, fo.A, fo.DM // 8, fo.DM, plan.tiles, plan.cl,
                            plan.ctas, plan.nbox, plan.W, ns, int(fo.mma_pairs(cmap_np)))

    args = {name: fold_args(plan.ns) for name in builds}

    def call(name, pieces):
        rc = libs[name](pieces, args[name], stream(dev))
        if rc:
            raise RuntimeError(f"probe_fold_launch failed with error {rc}")

    for v in ("mxu2", "mxu3"):
        call("normal", fo.PIECES[v])
        want = fo.fold(x, fm, variant=v, plain=True)
        rel = float((out - want).abs().max()) / float(want.abs().max())
        print(f"normal build {v} against plain: rel {rel:.3e} (tol {fo.TOL:g})", flush=True)
        if not rel <= fo.TOL:
            raise SystemExit(f"{v} disagrees with its plain version")
        del want
    prof = {}
    for v in ("mxu2", "mxu3"):
        got = (ctypes.c_ulonglong * 8)()
        lib = kernels.library("probe_fold", defines=builds[PROF])
        lib.probe_fold_prof(got)  # clears
        for _ in range(3):
            call(PROF, fo.PIECES[v])
        torch.cuda.synchronize()
        lib.probe_fold_prof(got)
        for r, who in enumerate(("rank 0", "other ranks")):
            loop, wait, release, stages = got[4 * r: 4 * r + 4]
            prof[f"{v} {who}"] = dict(loop=loop, wait=wait, release=release, stages=stages)
            print(f"{v} clocks, {who}: {loop / max(stages, 1):.0f} cycles a stage, of which "
                  f"waiting for the stage {wait / max(loop, 1):.1%}, releasing it (arrive, "
                  f"arm) {release / max(loop, 1):.1%} | {card}", flush=True)
    order = ["normal", *(KNOCKOUTS[k] for k in KNOCKOUTS), "normal"]
    res = {}
    for v in ("mxu2", "mxu3"):
        runs = {}
        for name in order:
            ms = diff_ms(lambda: call(name, fo.PIECES[v]), *FOLD_TIME)
            runs.setdefault(name, []).append(ms)
        base = sum(runs["normal"]) / len(runs["normal"])
        for name, ms in runs.items():
            mean = sum(ms) / len(ms)
            print(f"{v} {name}: {', '.join(f'{t:.4f}' for t in ms)} ms per call; saves "
                  f"{base - mean:.4f} ms ({(base - mean) / base:.1%}) | {card}", flush=True)
        res[v] = runs
    result = {"card": card, "plan": plan.__dict__, "ms": res, "clocks": prof}
    with open(os.path.join(out_dir, "fold_breakdown.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
