#!/usr/bin/env python3
"""The batched-dot probe, the roll folds, the matmul-rate probe, the column
gather and the conv fold of one or more trees timed on one card, in turns in
one call.

Each tree's ``probes/batched_dot.py`` at ``GROUPS`` and N ``N_ATOMS`` (rep 1
and 4, timed by ``batched_dot_time``: best of 3 CUDA graphs of 10 calls;
the product's time on staged tiles is (rep 4 - rep 1) / 3) beside
``torch.bmm`` per group, and its ``probes/fold.py`` ``roll`` and ``bigroll``
at ``r3_fold_probe.py``'s shape (``diff_ms(fn, *FOLD_TIME)``) beside two
library forms: ``torch.sum`` over K alone (the fold without its column
map), and the whole function as two calls, ``torch.sum`` over K then
``torch.index_select`` by the column map; its ``probes/mm_rate.py`` every
variant at every shape of its contract's TPU script, both contracts
(``mm_time``), beside the same
16 products as ``torch.matmul`` calls in one graph (TF32 on for the tf32
variants; bf16 for bf16); its ``probes/gather.py`` column gather (p1,
``r2_pallas_caps.py``'s shape) as one call alone (``graph_ms(fn, 1,
replays=20)``, three rounds in turns with ``index_select``) and back to
back (``gather_time`` at ``TABLE_TIMING``), each beside ``index_select``
into the same output, the one call both with the host's launch latency in
the time and queued behind a spin on the device (``one_call_ms``), with
each one's device kernels from ``torch.profiler``, and where the tree has
it the launch floor (an empty kernel timed as the one call); its
``probes/fold_conv.py`` (group ``foldconv``) sliceadd, group4 and group8 at
``r4_fold_probe.py``'s shape (N 10,016, K 72, SevenNet-0's layer, the inputs
of ``chip_smoke.py``), two rounds in turns (``diff_ms(fn, *FOLD_TIME)``),
beside that tree's B4 fwd on the same x[src] timed the same way, and where
the tree has it the kernel's shared memory, CTAs an SM and registers
(``fold_conv.occupancy``); its breakdown and knock-out probes (group
``edge``, ``probes/breakdown.py`` and ``probes/knockout.py``): every variant
that runs the per-edge uvu product (``csrc/probe_breakdown.cuh:uvu_edges``;
tp, tpred, tpredk, storek, fullk, tpredmm, tpredmm_amaj, fullmm, feat_full,
featroll_full, knock-out nofold) and the variants they are read against
(tmp, full, full_hi, featroll_mlp, knock-out full and notp), at the
scripts' shapes with ``chip_smoke.py``'s inputs (seed 12), two rounds in
turns (``diff_ms(fn, *KNOCK_TIME)``), with each one's bound
(``chip_smoke.py:bd_bound``). Each output is checked against its plain
version first (the batched dot within 1e-5 of max |plain|, the folds within
``fold.TOL``, the conv fold within ``fold_conv.TOL``, the breakdowns within
``breakdown.tol`` and ``knockout.TOL``, the matmuls within
``mm_rate.PROBE_TOL``, the gather bitwise); bounds are the bytes over HBM's
rate or the operations over their type's peak (the conv fold's products at
the 3xTF32 rate, as ``chip_smoke.py`` bounds it).

    python3 probe_ab.py [--tree DIR] [--only bd,fold,mm,gather,foldconv,edge]
    python3 probe_ab.py --compare DIR,DIR,... [--names a,b,...] [--only ...]

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
# H100 SXM dense peaks, NVIDIA data sheet (chip_smoke.py PEAK_OF)
PEAK_OF = {"ffma": 67e12, "tf32": 495e12, "wgmma_tf32": 495e12, "3xtf32": 495e12 / 3,
           "3xtf32_presplit": 495e12 / 3, "bf16": 989e12}
RUN_TIMEOUT_S = 600
KERNELS = ("batched_dot_kernel", "probe_fold_roll_kernel", "probe_mm", "probe_gather_cols_kernel",
           "probe_fold_conv_kernel", "probe_breakdown_kernel")
GROUPS = ("bd", "fold", "mm", "gather", "foldconv", "edge")
LIBS = {"bd": ("probe_batched_dot",), "fold": ("probe_fold",), "mm": ("probe_mm",),
        "gather": ("probe_gather",), "foldconv": ("probe_fold_conv",),
        "edge": ("probe_breakdown", "probe_breakdown_k", "probe_breakdown_feat", "probe_knockout")}
# group edge: breakdown variants with the per-edge product, then those they
# are read against; knock-out likewise
EDGE_BD = ("tp", "tpred", "tpredk", "storek", "fullk", "tpredmm", "tpredmm_amaj", "fullmm",
           "feat_full", "featroll_full", "tmp", "full", "full_hi", "featroll_mlp")
EDGE_KO = ("nofold", "full", "notp")


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


def device_us(fn, tries: int = 3) -> dict:
    """Device us of one call of ``fn`` by kernel name, from torch.profiler,
    after one call as warm-up. A trace that saw no device activity is not a
    zero: it is taken again, up to ``tries`` traces (one has come back
    empty on the first trace of a process), and RuntimeError is raised when
    every one is empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        res = {e.key: e.self_device_time_total / e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        if res:
            return res
    raise RuntimeError(f"torch.profiler recorded no device kernel of one call in {tries} traces")


def one_call_ms(fn, queued: bool, replays: int = 20) -> float:
    """ms of one call of ``fn`` alone: the call captured in a CUDA graph,
    its replay timed by CUDA events, the least of ``replays``; ``queued``
    puts each replay behind a spin on the device, so that the host's
    latency to launch it falls outside the events (else it is timed, as the
    parent's ``graph_ms(fn, 1, replays=20)`` did). The same code for every
    tree."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    best = float("inf")
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(1_000_000)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def one_tree(tree: str, only=GROUPS) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from sevennet_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    libs = kernels.build([name for g in only for name in LIBS[g]])
    dev = torch.device("cuda")
    res = dict(tree=tree, card=card.strip().splitlines()[0], ms={}, library_ms={}, bound_ms={},
               device_us={},
               ptxas={k: v for so in libs.values() for k, v in ptxas(so).items()})
    if "bd" in only:
        batched_dot_ab(res, dev)
    if "fold" in only:
        fold_ab(res, dev)
    if "mm" in only:
        mm_ab(res, dev)
    if "gather" in only:
        gather_ab(res, dev)
    if "foldconv" in only:
        foldconv_ab(res, dev)
    if "edge" in only:
        edge_ab(res, dev)
    return res


def batched_dot_ab(res: dict, dev) -> None:
    import torch

    from sevennet_tpu_torch.probes import batched_dot as bd

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


def fold_ab(res: dict, dev) -> None:
    import torch

    from sevennet_tpu_torch.probes import fold as fo
    from sevennet_tpu_torch.probes._lib import FOLD_TIME, diff_ms

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
    del fx, out
    torch.cuda.empty_cache()


def mm_ab(res: dict, dev) -> None:
    """Every matmul-rate variant at every shape of its contract's TPU
    script (``mm_rate.shapes``), both contracts (the inputs of
    chip_smoke.py's probe_inputs, s zero as the TPU scripts'), beside the 16
    products as torch.matmul calls."""
    import torch

    from sevennet_tpu_torch.probes import mm_rate as mr

    s = torch.zeros((1, 1), device=dev)
    s_check = torch.full((1, 1), 1e-3, device=dev)
    for chain in (False, True):
        for v in mr.VARIANTS:
            for m, k, n in mr.shapes(v, chain):
                gen = torch.Generator(device="cpu").manual_seed(m + k + n)
                dtype = torch.bfloat16 if v == "bf16" else torch.float32
                a = torch.randn(m, k, generator=gen).to(dev, dtype)
                b = torch.randn(k, n, generator=gen).to(dev, dtype)
                fn = mr.mm_chain if chain else mr.mm_rate
                key = f"{'mm_chain' if chain else 'mm_rate'} {v} {m}x{k}x{n}"
                chk = () if chain else (s_check if v != "bf16" else s,)
                want = fn(a, b, *chk, variant=v, plain=True)
                err = float((fn(a, b, *chk, variant=v) - want).abs().max())
                if err > mr.PROBE_TOL[v] * float(want.abs().max()):
                    raise SystemExit(f"{key} differs from its plain version by {err}")
                extra = () if chain else (s,)
                res["ms"][key] = mr.mm_time(lambda: fn(a, b, *extra, variant=v))
                torch.backends.cuda.matmul.allow_tf32 = v in ("tf32", "wgmma_tf32")
                res["library_ms"][key] = mr.mm_time(lambda: [torch.matmul(a, b)
                                                             for _ in range(mr.REP)])
                torch.backends.cuda.matmul.allow_tf32 = False
                res["bound_ms"][key] = 2 * m * k * n * mr.REP / PEAK_OF[v] * 1e3


def gather_ab(res: dict, dev) -> None:
    """The column gather at p1's shape: one call alone and back to back,
    beside index_select into the same output; device durations; the launch
    floor where the tree has its empty kernel."""
    import torch

    from sevennet_tpu_torch.probes import gather as ga

    dx, w, t = ga.TABLE_SHAPE
    gen = torch.Generator(device="cpu").manual_seed(9)
    tbl = torch.randn(dx, w, generator=gen).to(dev)
    idx = torch.randint(0, w, (1, t), generator=gen, dtype=torch.int32).to(dev)
    out = torch.empty(dx, t, device=dev)
    if not torch.equal(ga.gather_cols(tbl, idx, out=out), ga.gather_cols_plain(tbl, idx)):
        raise SystemExit("gather_cols differs from index_select")
    kern = lambda: ga.gather_cols(tbl, idx, out=out)  # noqa: E731
    lib = lambda: torch.index_select(tbl, 1, idx[0], out=out)  # noqa: E731
    calls = {"G2": kern, "index_select": lib}
    if hasattr(ga, "empty_launch"):
        calls["empty kernel"] = lambda: ga.empty_launch(dev)
    for queued, tag in ((False, "host latency in"), (True, "queued")):
        rounds = [{k: one_call_ms(f, queued) for k, f in calls.items()} for _ in range(3)]
        res[f"rounds one call, {tag}"] = rounds
        for k in calls:
            res["ms" if k == "G2" else "library_ms"][f"one call, {tag}: {k}"] = min(
                r[k] for r in rounds)
    res["ms"]["G2' back to back"] = ga.gather_time(kern, ga.TABLE_TIMING)
    res["library_ms"]["G2' back to back"] = ga.gather_time(lib, ga.TABLE_TIMING)
    for k, f in calls.items():
        for name, us in device_us(f).items():
            res["device_us"][f"{k}: {name}"] = us
    res["bound_ms"]["G2"] = ga.gather_bytes(tbl, idx, 1) / HBM_BYTES_S * 1e3


def foldconv_ab(res: dict, dev) -> None:
    """The conv fold's variants at the script's shape, each first held
    against its plain version, then two rounds in turns, beside B4 fwd on
    the same x[src]; the inputs are chip_smoke.py's (seed 10)."""
    import torch

    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.probes import fold_conv as fcv
    from sevennet_tpu_torch.probes._lib import FOLD_TIME, diff_ms

    conv, mlp = fcv.sevennet0_conv()
    n, k = fcv.N, fcv.K
    gen = torch.Generator(device="cpu").manual_seed(10)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    x = rnd(n, conv.irreps_x.dim, scale=0.5)
    src = torch.randint(0, n, (n, k), generator=gen, dtype=torch.int32).to(dev)
    xg = x[src.reshape(-1).long()].contiguous()
    emb, sh = rnd(n * k, mlp.dims[0], scale=0.3), rnd(n * k, conv.irreps_filter.dim, scale=0.5)
    ws = [rnd(a, b) for a, b in zip(mlp.dims[:-1], mlp.dims[1:])]
    w3j = torch.as_tensor(fcv._tables(conv)[1], device=dev)
    op = fc.conv_op(conv, mlp, None)
    for v in fcv.VARIANTS:
        want = fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, v, plain=True)
        err = float((fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, v) - want).abs().max())
        if err > fcv.TOL * float(want.abs().max()):
            raise SystemExit(f"fold_conv {v} differs from its plain version by {err}")
        del want
    for r in range(2):
        for v in fcv.VARIANTS:
            res["ms"][f"fold_conv {v} round {r}"] = diff_ms(
                lambda: fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, v), *FOLD_TIME)
        res["ms"][f"B4 fwd on x[src] round {r}"] = diff_ms(
            lambda: fc.fused_conv_fwd_embsh(op, x, src, emb, sh, ws), *FOLD_TIME)
    fl, nbytes = fcv.fold_conv_work(conv, mlp.dims, n, k)
    res["bound_ms"]["fold_conv"] = max(fl / PEAK_OF["3xtf32"], nbytes / HBM_BYTES_S) * 1e3
    if hasattr(fcv, "occupancy"):
        res["occupancy"] = {v: fcv.occupancy(conv, mlp.dims, k, v, dev) for v in fcv.VARIANTS}
    del x, src, xg, emb, sh, ws
    torch.cuda.empty_cache()


def edge_ab(res: dict, dev) -> None:
    """The breakdown and knock-out variants of EDGE_BD and EDGE_KO at their
    scripts' shapes, on chip_smoke.py's inputs (seed 12: the MLP's weights,
    then per probe xg, emb, sh), each first held against its plain
    version, then two rounds in turns, beside each one's bound."""
    import torch

    from chip_smoke import bd_bound
    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.probes import breakdown as bd
    from sevennet_tpu_torch.probes import fold_conv as fcv
    from sevennet_tpu_torch.probes import knockout as ko
    from sevennet_tpu_torch.probes._lib import diff_ms

    gen = torch.Generator(device="cpu").manual_seed(12)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    conv, mlp = fcv.sevennet0_conv()
    op = fc.conv_op(conv, mlp)
    ws = [rnd(a, b) for a, b in zip(mlp.dims[:-1], mlp.dims[1:])]
    for key, fn, n, k, variants, work, tol in (
            ("breakdown", bd.breakdown, bd.N, bd.K, EDGE_BD, bd.breakdown_work, bd.tol),
            ("knockout", ko.knockout, ko.N, ko.K, EDGE_KO, ko.knockout_work, lambda v: ko.TOL)):
        xg = rnd(n * k, op.dim_x, scale=0.5)
        emb, sh = rnd(n * k, op.n_basis, scale=0.3), rnd(n * k, op.dim_f, scale=0.5)
        for v in variants:
            want = fn(op, xg, emb, sh, ws, k, v, plain=True)
            err = float((fn(op, xg, emb, sh, ws, k, v) - want).abs().max())
            if err > tol(v) * float(want.abs().max()):
                raise SystemExit(f"{key} {v} differs from its plain version by {err}")
            del want
            res["bound_ms"][f"{key} {v}"] = bd_bound(*work(op, v, n, k))[0]
        for r in range(2):
            for v in variants:
                res["ms"][f"{key} {v} round {r}"] = diff_ms(
                    lambda: fn(op, xg, emb, sh, ws, k, v), *bd.KNOCK_TIME)
        del xg, emb, sh
        torch.cuda.empty_cache()


def compare(trees, names, only) -> int:
    os.makedirs(OUT_DIR, exist_ok=True)
    results = []
    for i, (tree, name) in enumerate(zip(trees, names)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree,
                               "--only", ",".join(only)],
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
    for what in ("ms", "library_ms", "bound_ms", "device_us"):
        for key in sorted({k for r in results for k in r[what]}):
            vals = ", ".join(f"{names[j]} {r[what].get(key, float('nan')):.5f}"
                             for j, r in enumerate(results))
            print(f"  {what} {key}: {vals}")
    for j, r in enumerate(results):
        print(f"  ptxas {names[j]}: {r['ptxas']}")
        if "occupancy" in r:
            print(f"  occupancy {names[j]}: {r['occupancy']}")
    print(json.dumps(dict(names=names, results=results)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--compare", help="comma-separated trees, run in this order")
    ap.add_argument("--names", help="comma-separated names of the compared trees")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"comma-separated probe groups of {GROUPS} (default: all)")
    args = ap.parse_args()
    only = tuple(args.only.split(","))
    if not set(only) <= set(GROUPS):
        ap.error(f"--only: groups of {GROUPS}")
    if args.compare:
        trees = args.compare.split(",")
        names = args.names.split(",") if args.names else [str(i) for i in range(len(trees))]
        return compare(trees, names, only)
    import torch

    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(one_tree(args.tree, only)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
