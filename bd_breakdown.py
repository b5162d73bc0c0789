#!/usr/bin/env python3
"""Where the batched-dot probe's kernel spends its time, on one NVIDIA GPU.

    python3 bd_breakdown.py

Builds ``sevennet_tpu_torch/csrc/probe_batched_dot.cu`` as it is and, as
builds of their own, with a phase knocked out (``-DBD_KO=k``: 1 the
products, 2 the copies, 3 two of 3xTF32's three products) and with clocks
(``-DBD_PROF``: each warpgroup's thread 0 cycles waiting for a stage, in
B's split, in A and the products, in the refill and in Y, printed as
shares of one call), then times each
build at ``r4_batched_dot_probe.py``'s shape (``batched_dot.GROUPS``, N
10,016) at rep 1, 2 and 4 by ``batched_dot_time`` (best of 3 CUDA graphs
of 10 calls), the builds in turns (normal, each knock-out, normal). The
normal build is first held against ``torch.bmm`` (1e-5 of max |plain|).
Prints each time with its per-repetition slope ((rep 4 - rep 1) / 3) and
each build's ptxas report; the last line is one JSON object with every
number, also written to ``chiprun_out/bd_breakdown.json``. A knock-out's
output is not the function's; only its time is read.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading

KNOCKOUTS = {1: "no products", 2: "no copies", 3: "hi hi product alone"}
REPS = (1, 2, 4)
PROF = "clocks"  # BD_PROF: each warpgroup's thread 0 cycles by section
SECTIONS = ("waiting for a stage", "B's split", "A and the products", "refill", "Y")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bd_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from sevennet_tpu_torch.ops import kernels
    from sevennet_tpu_torch.probes import batched_dot as bd
    from sevennet_tpu_torch.probes._lib import stream

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.abspath("chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    builds = {"normal": ()}
    builds.update({KNOCKOUTS[k]: (f"BD_KO={k}",) for k in KNOCKOUTS})
    builds[PROF] = ("BD_PROF=1",)
    threads = [threading.Thread(target=kernels.build, args=(["probe_batched_dot"], False, d))
               for d in builds.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    ptxas = {}
    for name, defines in builds.items():
        so = kernels.build(["probe_batched_dot"], False, defines)["probe_batched_dot"]
        m = re.search(r"Used (\d+) registers", open(str(so) + ".log").read())
        ptxas[name] = int(m.group(1)) if m else None
    dev = torch.device("cuda")
    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    gen = torch.Generator(device="cpu").manual_seed(8)
    Ss = [(torch.randn(bd.N_ATOMS, d3, kk, generator=gen) * 0.1).to(dev) for d3, kk, _ in bd.GROUPS]
    XWs = [(torch.randn(bd.N_ATOMS, kk, mul, generator=gen) * 0.1).to(dev)
           for _, kk, mul in bd.GROUPS]
    Ys = [torch.empty(bd.N_ATOMS, d3, mul, device=dev) for d3, _, mul in bd.GROUPS]
    shapes = tuple(bd.GROUPS)
    plan = bd.bd_plan(shapes)
    groups = (bd._BdGroup * 3)(*[bd._BdGroup(S.data_ptr(), XW.data_ptr(), Y.data_ptr(), *g)
                                 for S, XW, Y, g in zip(Ss, XWs, Ys, shapes)])

    def launch(lib, rep):
        rc = lib.batched_dot_launch(bd._BdArgs(groups, bd.N_ATOMS, rep, plan.ch, plan.ns,
                                               plan.stage, plan.bbuf), stream(dev))
        if rc:
            raise RuntimeError(f"batched_dot_launch failed with error {rc}")

    libs = {name: kernels.library("probe_batched_dot", defines=d) for name, d in builds.items()}
    for name in builds:  # each build's first launch alone, so that a fault names its build
        launch(libs[name], 1)
        torch.cuda.synchronize()
        print(f"{name}: first launch done", flush=True)
    launch(libs["normal"], 1)
    want = bd.batched_dot_plain(Ss, XWs)
    for y, w in zip(Ys, want):
        err = float((y - w).abs().max()) / float(w.abs().max())
        if err > 1e-5:
            raise SystemExit(f"the normal build is {err:.2e} of max |plain| off torch.bmm")
    del want
    order = ["normal"] + list(KNOCKOUTS.values()) + ["normal"]  # the clock build is not timed
    times = {}
    for i, name in enumerate(order):
        key = name if i < len(order) - 1 else "normal (again)"
        times[key] = {rep: bd.batched_dot_time(lambda: launch(libs[name], rep)) for rep in REPS}
        t = times[key]
        print(f"{key}: " + ", ".join(f"rep {r} {t[r]:.4f} ms" for r in REPS)
              + f"; per repetition {(t[4] - t[1]) / 3:.4f} ms | registers {ptxas[name]} | {card}",
              flush=True)
    # the clock build: one call at rep 1, each warpgroup's cycles by section
    import ctypes

    prof = (ctypes.c_ulonglong * (bd.BD_CWG * len(SECTIONS)))()
    libs[PROF].batched_dot_prof(prof)  # clear
    launch(libs[PROF], 1)
    torch.cuda.synchronize()
    if libs[PROF].batched_dot_prof(prof):
        raise RuntimeError("batched_dot_prof failed")
    clocks = {}
    for wg in range(bd.BD_CWG):
        cyc = list(prof[wg * len(SECTIONS):(wg + 1) * len(SECTIONS)])
        clocks[wg] = dict(zip(SECTIONS, cyc))
        print(f"warpgroup {wg} (CTA totals summed over CTAs, thread 0): " + ", ".join(
            f"{k} {v / max(sum(cyc), 1):.1%}" for k, v in zip(SECTIONS, cyc))
            + f"; {sum(cyc) / 1e6:.1f} M cycles", flush=True)
    res = dict(card=card, plan=plan.__dict__, ptxas=ptxas, times=times, clocks=clocks,
               bound_ms=bd.batched_dot_work(Ss, XWs)[1] / 3.35e12 * 1e3)
    with open(os.path.join(out_dir, "bd_breakdown.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
