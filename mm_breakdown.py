#!/usr/bin/env python3
"""Register A against shared-memory A, at N 32 and at N 64, for the
matmul-rate probe's 3xTF32 wgmma kernel, on one NVIDIA GPU.

    python3 mm_breakdown.py

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
    import ctypes

    import torch

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

    threads = [threading.Thread(target=one, args=kv) for kv in BUILDS.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if len(sos) != len(BUILDS):
        raise SystemExit(f"mm_breakdown: builds failed: {sorted(set(BUILDS) - set(sos))}")
    ptxas, libs = {}, {}
    for name, so in sos.items():
        text = open(str(so) + ".log").read()
        regs = re.findall(r"Compiling entry function '(\S*probe_mm3x\S*)'[\s\S]*?Used (\d+) "
                          r"registers", text)
        ptxas[name] = {fn: int(r) for fn, r in regs}
        libs[name] = ctypes.CDLL(str(so))
        libs[name].probe_mm_launch.restype = ctypes.c_int
    dev = torch.device("cuda")
    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    s_zero = torch.zeros((1, 1), device=dev)
    s_check = torch.full((1, 1), 1e-3, device=dev)
    rows = []
    for shape in (SHAPE, SHAPE_K512):
        m, k, n = shape
        gen = torch.Generator(device="cpu").manual_seed(m + k + n)
        a = torch.randn(m, k, generator=gen).to(dev)
        b = torch.randn(k, n, generator=gen).to(dev)
        out = torch.empty(m, n, device=dev)
        fl = mr.mm_flops(m, k, n)

        def launch(lib, variant, s, plan, rep=mr.REP):
            args = mr._MmArgs(a.data_ptr(), b.data_ptr(), out.data_ptr(), s.data_ptr(), m, k, n,
                              rep, 1, plan.mw, plan.ks)
            rc = lib.probe_mm_launch(ctypes.c_int(mr.VARIANTS.index(variant)), ctypes.c_int(0),
                                     args, stream(dev))
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
    for name, regs in ptxas.items():
        print(f"ptxas {name}: {regs}")
    res = dict(card=card, rows=rows, ptxas=ptxas,
               bound_ms={str(sh): mr.mm_flops(*sh) / (TF32_PEAK / 3) * 1e3
                         for sh in (SHAPE, SHAPE_K512)})
    with open(os.path.join(out_dir, "mm_breakdown.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
