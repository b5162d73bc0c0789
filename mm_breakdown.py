#!/usr/bin/env python3
"""Register A against shared-memory A, at N 32 and at N 64, for the
matmul-rate probe's 3xTF32 wgmma kernel, where the time of its ffma, tf32,
wgmma_tf32 and bf16 kernels goes, and wgmma_tf32's forms (wgmma N, one or
two accumulators), on one NVIDIA GPU.

    python3 mm_breakdown.py [--only 3x|ko|wgmma]

Builds ``sevennet_tpu_torch/csrc/probe_mm.cu`` as it is (A from registers,
wgmma N 64) and, as builds of their own, that file with ``mm_breakdown.patch``
applied (into ``build/mm_breakdown``) and ``-DMM_BN=32`` (a warpgroup's
tile 64 x 32: wgmma N 32) or ``-DMM_ASMEM=1`` (3xtf32_presplit's A split
once into K-major core matrices in shared memory, both wgmma operands from
shared memory), or both, or ``-DMM_PIPE=0`` (3xtf32 splits each product's
A before its products, not while they run). Each build's
``3xtf32_presplit`` and ``3xtf32`` (the rate contract,
``r2_pallas_mm.py:mm``) at 1024 x 64 x 960 is first
held against the plain loop (``mm_rate.PROBE_TOL``), then timed by
``mm_time`` (250 against 50 calls in CUDA graphs, best of 3), the builds in
turns (normal, each other build, normal), each at both of the plan's
arrangements where it has them (``mw`` 2: two 64-row tiles a CTA; ``ks``
2: one tile, the k-steps halved between the warpgroups); the normal build
also at ``SHAPE_K512`` (480 x 512 x 1024, where ``mm_plan`` takes ``ks``
2: 128 CTAs against ``mw`` 2's 64). Prints each time
with its raw TF32 rate (three products a fp32 one) and each build's ptxas
report; the last line is one JSON object with every number, also written
to ``chiprun_out/mm_breakdown.json``. (``MM_ASMEM`` changes only
3xtf32_presplit; its 3xtf32 is the normal build's.)

The knock-outs (``--only ko``): builds of the patched file with
``-DMM_KO=1`` .. ``5`` (probe_mm_ffma_kernel's and probe_mm_tc_kernel's
rate contract without its staging, 1, which for tf32 also leaves out its
fragment loads and for wgmma_tf32 its rounding; without its products, 2;
without the acc update, 3; without the store, 4; with none of 1, 2 and 4,
5, the launch and the loops' skeleton). Each of ffma, tf32, wgmma_tf32
and bf16 at 1024 x 64 x 960 and (not bf16) at ``SHAPE_K512``, one copy, on
its ``mm_plan``, the normal build first held against the plain loop, then
timed by ``mm_time`` with the knock-outs in turns (normal, 1 .. 5, twice);
what each knock-out saves against the normal build is the time of its
part, where the parts do not overlap.

The wgmma forms (``--only wgmma``, the normal build): wgmma_tf32 at every
shape of both contracts, one copy, at wgmma N 64 and 128 (where a
warpgroup's k-steps are one chunk) on every arrangement of the plan, each
held against the plain loop (s 1e-3 and -0.125) and then timed by
``mm_time`` in turns, twice, beside the plan that ``mm_plan`` takes.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
PATCH = HERE / "mm_breakdown.patch"
PATCH_DIR = HERE / "build" / "mm_breakdown"
SHAPE = (1024, 64, 960)
SHAPE_K512 = (480, 512, 1024)
# build -> the patched source's defines (None: probe_mm.cu as it is)
BUILDS = {"A registers, N 64": None, "A registers, N 32": ("MM_BN=32",),
          "A shared, N 64": ("MM_ASMEM=1",), "A shared, N 32": ("MM_BN=32", "MM_ASMEM=1"),
          "A registers, N 64, unpipelined": ("MM_PIPE=0",)}
ORDER = ("A registers, N 64", "A registers, N 32", "A shared, N 64", "A shared, N 32",
         "A registers, N 64, unpipelined", "A registers, N 64")
# the knock-outs (MM_KO) of probe_mm_ffma_kernel and probe_mm_tc_kernel
KO_BUILDS = {"no staging": ("MM_KO=1",), "no products": ("MM_KO=2",),
             "no acc update": ("MM_KO=3",), "no store": ("MM_KO=4",),
             "skeleton": ("MM_KO=5",)}
KO_VARIANTS = ("ffma", "tf32", "wgmma_tf32", "bf16")
TF32_PEAK = 495e12  # H100 SXM dense TF32, NVIDIA data sheet


def apply_patch(text: str, patch: str) -> str:
    """``text`` with each hunk of the unified diff ``patch`` applied: the
    hunk's old lines (context and removed), which must occur exactly once,
    replaced by its new lines (context and added)."""
    hunks, cur = [], None
    for ln in patch.splitlines(keepends=True):
        if ln.startswith("@@"):
            cur = ([], [])
            hunks.append(cur)
        elif cur is not None and ln[:1] in (" ", "-", "+"):
            if ln[0] != "+":
                cur[0].append(ln[1:])
            if ln[0] != "-":
                cur[1].append(ln[1:])
    for old, new in hunks:
        old, new = "".join(old), "".join(new)
        if text.count(old) != 1:
            raise RuntimeError(f"{PATCH.name}: a hunk matches {text.count(old)} times:\n{old}")
        text = text.replace(old, new, 1)
    return text


def build_patched(defines) -> Path:
    """probe_mm.cu with the patch applied, built with ``defines`` into
    PATCH_DIR by kernels' nvcc and flags (headers from csrc); the ptxas
    report beside it as ``<library>.log``. Returns the library's path."""
    from sevennet_tpu_torch.ops import kernels

    text = apply_patch((kernels.CSRC_DIR / "probe_mm.cu").read_text(), PATCH.read_text())
    flags = kernels._flags(False, defines)
    digest = hashlib.sha256((text + " ".join(flags)).encode()).hexdigest()[:16]
    PATCH_DIR.mkdir(parents=True, exist_ok=True)
    src = PATCH_DIR / f"probe_mm_{digest}.cu"
    src.write_text(text)
    so = PATCH_DIR / f"libprobe_mm{''.join('_' + d.replace('=', '') for d in defines)}_{digest}.so"
    proc = subprocess.run([kernels._nvcc(), *flags, "-I", str(kernels.CSRC_DIR), "-o", str(so),
                           str(src)], capture_output=True, text=True)
    Path(str(so) + ".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the patched probe_mm.cu {defines}:\n{proc.stderr}")
    return so


def main() -> int:
    import argparse
    import ctypes

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("3x", "ko", "wgmma"), help="only one of the parts")
    args = ap.parse_args()
    builds = {**({} if args.only in ("ko", "wgmma") else BUILDS),
              **({} if args.only in ("3x", "wgmma") else {"A registers, N 64": None, **KO_BUILDS}),
              **({} if args.only in ("3x", "ko") else {"A registers, N 64": None})}

    if not torch.cuda.is_available():
        print("mm_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from sevennet_tpu_torch.ops import kernels
    from sevennet_tpu_torch.probes import mm_rate as mr
    from sevennet_tpu_torch.probes._lib import stream

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.abspath("chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    sos = {}

    def one(name, defines):
        sos[name] = (kernels.build(["probe_mm"])["probe_mm"] if defines is None
                     else build_patched(defines))

    threads = [threading.Thread(target=one, args=kv) for kv in builds.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if len(sos) != len(builds):
        raise SystemExit(f"mm_breakdown: builds failed: {sorted(set(builds) - set(sos))}")
    ptxas, libs = {}, {}
    for name, so in sos.items():
        text = open(str(so) + ".log").read()
        regs = re.findall(r"Compiling entry function '(\S*probe_mm(?:3x|_ffma|_tc)\S*)'"
                          r"[\s\S]*?Used (\d+) registers", text)
        ptxas[name] = {fn: int(r) for fn, r in regs}
        libs[name] = ctypes.CDLL(str(so))
        libs[name].probe_mm_launch.restype = ctypes.c_int
    dev = torch.device("cuda")
    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    s_zero = torch.zeros((1, 1), device=dev)
    s_check = torch.full((1, 1), 1e-3, device=dev)
    rows, ko_rows = [], []
    for shape in (SHAPE, SHAPE_K512) if args.only in (None, "3x") else ():
        m, k, n = shape
        gen = torch.Generator(device="cpu").manual_seed(m + k + n)
        a = torch.randn(m, k, generator=gen).to(dev)
        b = torch.randn(k, n, generator=gen).to(dev)
        out = torch.empty(m, n, device=dev)
        fl = mr.mm_flops(m, k, n)

        def launch(lib, variant, s, plan, rep=mr.REP):
            rc = lib.probe_mm_launch(ctypes.c_int(mr.VARIANTS.index(variant)), ctypes.c_int(0),
                                     mr.mm_args(a, b, s, out, rep, 1, plan), stream(dev))
            if rc:
                raise RuntimeError(f"probe_mm_launch failed with error {rc}")
            return out

        def plans(bn):
            return {"mw 2": mr.MmPlan(2, 1, -(-m // 128) * -(-n // bn)),
                    "ks 2": mr.MmPlan(1, 2, -(-m // 64) * -(-n // bn))}

        order = ORDER if shape == SHAPE else ("A registers, N 64",) * 2
        for name in dict.fromkeys(order):
            bn = 32 if "N 32" in name else 64
            for v in mr.WGMMA_3X:
                want = mr.mm_rate(a, b, s_check, variant=v, plain=True)
                for pname, plan in plans(bn).items():
                    err = float((launch(libs[name], v, s_check, plan) - want).abs().max())
                    if err > mr.PROBE_TOL[v] * float(want.abs().max()):
                        raise SystemExit(f"{name} {v} {pname} {shape}: {err} from plain")
        for turn, name in enumerate(order):
            bn = 32 if "N 32" in name else 64
            for v in mr.WGMMA_3X:
                for pname, plan in plans(bn).items():
                    ms = mr.mm_time(lambda: launch(libs[name], v, s_zero, plan))
                    rows.append(dict(shape=shape, turn=turn, build=name, variant=v, plan=pname,
                                     ctas=plan.ctas, ms=ms, raw_tflops=3 * fl / ms / 1e9))
                    print(f"{'x'.join(map(str, shape))} turn {turn} {name}, {v}, {pname} "
                          f"({plan.ctas} CTAs on {n_sm} SMs): {ms:.5f} ms, "
                          f"{fl / ms / 1e9:.2f} TFLOP/s, raw TF32 {3 * fl / ms / 1e9:.2f} "
                          f"({3 * fl / ms / TF32_PEAK * 1e3:.1%} of {TF32_PEAK / 1e12:.0f}) | "
                          f"{card}", flush=True)
    for shape in (SHAPE, SHAPE_K512) if args.only in (None, "ko") else ():
        ko_rows += knockouts(libs, shape, dev, n_sm, card)
    wgmma_rows = (wgmma_forms(libs["A registers, N 64"], dev, card)
                  if args.only in (None, "wgmma") else [])
    for name, regs in ptxas.items():
        print(f"ptxas {name}: {regs}")
    res = dict(card=card, rows=rows, ko_rows=ko_rows, wgmma_rows=wgmma_rows, ptxas=ptxas,
               bound_ms={str(sh): mr.mm_flops(*sh) / (TF32_PEAK / 3) * 1e3
                         for sh in (SHAPE, SHAPE_K512)})
    with open(os.path.join(out_dir, "mm_breakdown.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps(res))
    return 0


def knockouts(libs, shape, dev, n_sm, card) -> list:
    """The knock-out builds against the normal one for each of KO_VARIANTS
    (bf16 at SHAPE only) at ``shape``, one copy, rate contract, in turns."""
    import ctypes

    import torch

    from sevennet_tpu_torch.probes import mm_rate as mr
    from sevennet_tpu_torch.probes._lib import stream

    m, k, n = shape
    s_zero = torch.zeros((1, 1), device=dev)
    s_check = torch.full((1, 1), 1e-3, device=dev)
    rows = []
    for v in KO_VARIANTS:
        if v == "bf16" and shape != SHAPE:
            continue
        gen = torch.Generator(device="cpu").manual_seed(m + k + n)
        dtype = torch.bfloat16 if v == "bf16" else torch.float32
        a = torch.randn(m, k, generator=gen).to(dev, dtype)
        b = torch.randn(k, n, generator=gen).to(dev, dtype)
        out = torch.empty(m, n, device=dev)
        plan = mr.mm_plan(m, k, n, variant=v, n_sm=n_sm)

        def launch(lib, s):
            rc = lib.probe_mm_launch(ctypes.c_int(mr.VARIANTS.index(v)), ctypes.c_int(0),
                                     mr.mm_args(a, b, s, out, mr.REP, 1, plan), stream(dev))
            if rc:
                raise RuntimeError(f"probe_mm_launch failed with error {rc}")
            return out

        sc = s_zero if v == "bf16" else s_check
        want = mr.mm_rate(a, b, sc, variant=v, plain=True)
        err = float((launch(libs["A registers, N 64"], sc) - want).abs().max())
        if err > mr.PROBE_TOL[v] * float(want.abs().max()):
            raise SystemExit(f"{v} {shape}: {err} from plain")
        order = ("A registers, N 64", *KO_BUILDS)
        for turn in range(2):
            times = {name: mr.mm_time(lambda: launch(libs[name], s_zero)) for name in order}
            base = times["A registers, N 64"]
            rows.append(dict(shape=shape, variant=v, plan=tuple(plan), turn=turn, ms=times,
                             saved={name: base - t for name, t in times.items()}))
            print(f"{'x'.join(map(str, shape))} {v} {tuple(plan)} turn {turn}: normal {base:.5f} ms; "
                  + "; ".join(f"{name} {times[name]:.5f} (saves {base - times[name]:.5f})"
                              for name in KO_BUILDS) + f" | {card}", flush=True)
    return rows


def wgmma_forms(lib, dev, card) -> list:
    """wgmma_tf32's forms, one copy, at every shape of both contracts, in
    turns (two rounds): wgmma N (a warpgroup's columns) 64 and 128 (where a
    warpgroup's k-steps are one chunk), on every arrangement of the plan
    (mw 2; ks 2; one warpgroup a CTA). Each form is first
    held against the plain loop (s 1e-3, and s -0.125, where a factor 1 + s
    i is 0), then timed by ``mm_time``; a row per form and turn, beside the
    plan that ``mm_plan`` takes."""
    import ctypes

    import torch

    from sevennet_tpu_torch.probes import mm_rate as mr
    from sevennet_tpu_torch.probes._lib import stream

    v = "wgmma_tf32"
    s_zero = torch.zeros((1, 1), device=dev)
    rows = []
    for chain in (False, True):
        for m, k, n in mr.shapes(v, chain):
            gen = torch.Generator(device="cpu").manual_seed(m + k + n)
            a = torch.randn(m, k, generator=gen).to(dev)
            b = torch.randn(k, n, generator=gen).to(dev)
            out = torch.empty(m, n, device=dev)
            nks = -(-k // 8)
            forms = {}
            for bn in (64, 128):
                for mw, ks in ((2, 1), (1, 2), (1, 1)):
                    if (ks == 2 and (chain or nks < 2)) or (bn == 128 and -(-nks // ks) > 8):
                        continue
                    forms[f"N {bn}, mw {mw} ks {ks}"] = mr.MmPlan(
                        mw, ks, -(-m // (64 * mw)) * -(-n // bn), 64, bn)

            def launch(plan, s):
                rc = lib.probe_mm_launch(ctypes.c_int(mr.VARIANTS.index(v)), ctypes.c_int(chain),
                                         mr.mm_args(a, b, None if chain else s, out, mr.REP, 1,
                                                    plan), stream(dev))
                if rc:
                    raise RuntimeError(f"probe_mm_launch failed with error {rc}")
                return out

            for sv in (1e-3, -0.125)[:1 if chain else 2]:
                s = torch.full((1, 1), sv, device=dev)
                want = (mr.mm_chain(a, b, variant=v, plain=True) if chain
                        else mr.mm_rate(a, b, s, variant=v, plain=True))
                for name, plan in forms.items():
                    err = float((launch(plan, s) - want).abs().max())
                    if not err <= mr.PROBE_TOL[v] * float(want.abs().max()):
                        raise SystemExit(f"{v} {name} {(m, k, n)} s {sv}: {err} from plain")
            tag = f"{'chain' if chain else 'rate'} {m}x{k}x{n}"
            for turn in range(2):
                for name, plan in forms.items():
                    ms = mr.mm_time(lambda: launch(plan, s_zero))
                    rows.append(dict(contract="chain" if chain else "rate", shape=(m, k, n),
                                     form=name, plan=tuple(plan), turn=turn, ms=ms))
                    print(f"wgmma {tag} turn {turn} {name} ({plan.ctas} CTAs): {ms:.5f} ms | "
                          f"{card}", flush=True)
            print(f"wgmma {tag}: mm_plan takes {mr.mm_plan(m, k, n, chain, variant=v)}",
                  flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
