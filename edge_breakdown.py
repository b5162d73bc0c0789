#!/usr/bin/env python3
"""Where the time of the breakdown template's per-edge uvu product goes
(``csrc/probe_breakdown.cuh:uvu_edges``), in knock-out nofold and breakdown
tpredmm, on one NVIDIA GPU: section clocks and knock-out builds.

    python3 edge_breakdown.py

Section clocks: the profile builds (``-DFUSED_CONV_PROFILE``) of
``probe_knockout`` and ``probe_breakdown_k``, ``probe_breakdown`` give B4's
tile loop by section (``conv_breakdown.SECTIONS``) for knock-out nofold,
notp and full (N 10,016, K 72) and breakdown tpredmm, tmp and tpred (N
3,072, K 96); section 4 ("uvu product (forward)") is the per-edge phase
where the variant has one (the product, its K sum and stores). Each share
is printed with its part of the variant's time.

Knock-out builds: ``csrc/probe_breakdown.cuh`` with ``edge_breakdown.patch``
applied, beside copies of ``probe_knockout.cu``, ``probe_breakdown.cu`` and
``probe_breakdown_k.cu`` in ``build/edge_breakdown``, built with
``-DEB_KO=`` bits of what a build knocks out of the per-edge phase: 1
nofold's staging stores (its messages summed into a register a lane,
stored once a task), 2 the 0/1 sum's fragment reads, splits and ``mma``
(the staging kept), 4 the terms (a message is its w: the x and tmp reads
and the FMAs gone). Every build takes the same launch (the wrappers'
arguments, ``breakdown.launch_args``). The variants are first held against
their plain versions (the wrappers, the kernel build); then every build's
six variants are timed by ``diff_ms(fn, *KNOCK_TIME)``, the builds in turns
(the kernel build first and last). Prints each time and each build's
ptxas report; the last line is one JSON object with every number, also
written to ``chiprun_out/edge_breakdown.json``. The inputs are
``chip_smoke.py``'s (seed 12).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

from mm_breakdown import apply_patch

HERE = Path(__file__).resolve().parent
PATCH = HERE / "edge_breakdown.patch"
PATCH_DIR = HERE / "build" / "edge_breakdown"
LIBS = ("probe_knockout", "probe_breakdown", "probe_breakdown_k")
# build -> EB_KO (None: the sources as they are)
BUILDS = {"kernel": None, "no nofold staging": 1, "no 0/1 mma": 2, "no terms": 4,
          "no terms, staging or 0/1 mma": 7}
ORDER = ("kernel", "no nofold staging", "no 0/1 mma", "no terms", "no terms, staging or 0/1 mma",
         "kernel")
# (probe, variant): the two rows redesigned and what they are read against
VARIANTS = (("knockout", "nofold"), ("knockout", "notp"), ("knockout", "full"),
            ("breakdown", "tpredmm"), ("breakdown", "tmp"), ("breakdown", "tpred"))


def build_patched(ko: int) -> dict:
    """The probe libraries of LIBS with the patched header, built with
    ``-DEB_KO=ko`` into PATCH_DIR by kernels' nvcc and flags (the other
    headers from csrc), one nvcc each, together; each ptxas report beside
    its library as ``<library>.log``. Returns name -> library path."""
    from sevennet_tpu_torch.ops import kernels

    text = apply_patch((kernels.CSRC_DIR / "probe_breakdown.cuh").read_text(), PATCH.read_text())
    flags = kernels._flags(False, (f"EB_KO={ko}",))
    digest = hashlib.sha256((text + " ".join(flags)).encode()).hexdigest()[:16]
    d = PATCH_DIR / f"ko{ko}_{digest}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probe_breakdown.cuh").write_text(text)
    procs = {}
    for name in LIBS:
        src = d / f"{name}.cu"
        src.write_text((kernels.CSRC_DIR / f"{name}.cu").read_text())
        so = d / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *flags, "-I", str(kernels.CSRC_DIR), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        Path(str(so) + ".log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} with the patched header, EB_KO {ko}:\n"
                               f"{log[-4000:]}")
        out[name] = so
    return out


def ptxas(so) -> dict:
    """(registers, stack bytes, spill store bytes) of each breakdown instance
    in library ``so``, from the ptxas report beside it."""
    rows, name = {}, None
    for ln in open(str(so) + ".log"):
        m = re.search(r"Compiling entry function '_Z\d+probe_breakdown_kernelILi(\d+)E", ln)
        if m:
            name = int(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m and name is not None:
            rows.setdefault(name, [None, *map(int, m.groups())])
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            rows.setdefault(name, [None, None, None])[0] = int(m.group(1))
            name = None
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("edge_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from conv_breakdown import SECTIONS, profile_call
    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops import kernels
    from sevennet_tpu_torch.probes import breakdown as bd
    from sevennet_tpu_torch.probes import fold_conv as fcv
    from sevennet_tpu_torch.probes import knockout as ko
    from sevennet_tpu_torch.probes._lib import diff_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sos = {}

    def one(name, k):
        if k is None:
            sos[name] = kernels.build(LIBS)
            kernels.build(LIBS, profile=True)
        else:
            sos[name] = build_patched(k)

    threads = [threading.Thread(target=one, args=kv) for kv in BUILDS.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if len(sos) != len(BUILDS):
        raise SystemExit(f"edge_breakdown: builds failed: {sorted(set(BUILDS) - set(sos))}")
    libs = {b: {n: ctypes.CDLL(str(so)) for n, so in s.items()} for b, s in sos.items()}
    for per in libs.values():
        for lib in per.values():
            fc.check_uvu_layout(lib)
    dev = torch.device("cuda")
    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    gen = torch.Generator(device="cpu").manual_seed(12)  # chip_smoke.py's breakdown inputs

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    conv, mlp = fcv.sevennet0_conv()
    op = fc.conv_op(conv, mlp)
    ws = [rnd(a, b) for a, b in zip(mlp.dims[:-1], mlp.dims[1:])]
    inputs = {}
    for key, n, k in (("breakdown", bd.N, bd.K), ("knockout", ko.N, ko.K)):
        xg = rnd(n * k, op.dim_x, scale=0.5)
        inputs[key] = (xg, rnd(n * k, op.n_basis, scale=0.3), rnd(n * k, op.dim_f, scale=0.5), n, k)

    def where(key, v):
        """(library, code, per-edge mapping) of a variant."""
        if key == "knockout":
            return "probe_knockout", ko._CODE[v], ko.EDGE_VW.get(v)
        lib, code = bd._KERNEL[v]
        return lib, code, bd.EDGE_VW.get(v)

    fns = {"knockout": ko.knockout, "breakdown": bd.breakdown}
    for key, v in VARIANTS:
        xg, emb, sh, n, k = inputs[key]
        want = fns[key](op, xg, emb, sh, ws, k, v, plain=True)
        got = fns[key](op, xg, emb, sh, ws, k, v)
        err = float((got - want).abs().max()) / float(want.abs().max())
        tol = ko.TOL if key == "knockout" else bd.tol(v)
        print(f"{key} {v}: kernel against plain {err:.3e} of max |plain| (tol {tol:.3e})",
              flush=True)
        if not err <= tol:
            raise SystemExit(f"{key} {v}: the kernel build is off its plain version")
        del want, got
    def args_of(key, v):
        """(library, the C entry's arguments) of a variant, on the current
        stream (a timing graph captures on a stream of its own)."""
        xg, emb, sh, n, k = inputs[key]
        lib, code, vw = where(key, v)
        return lib, bd.launch_args(op, xg, emb, sh, ws, k, code, vw=vw)[0]

    def launch(build, key, v):
        lib, args = args_of(key, v)
        fn = getattr(libs[build][lib], f"{lib}_launch")
        if fn.argtypes is None:
            fn.argtypes = [type(a) for a in args]
            fn.restype = ctypes.c_int
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{lib}_launch ({build}) failed with error {rc}")

    rows = []
    for turn, build in enumerate(ORDER):
        for key, v in VARIANTS:
            ms = diff_ms(lambda: launch(build, key, v), *bd.KNOCK_TIME)
            rows.append(dict(turn=turn, build=build, probe=key, variant=v, ms=ms))
            print(f"turn {turn} {build}, {key} {v}: {ms:.4f} ms | {card}", flush=True)
    kern_ms = {(r["probe"], r["variant"]): r["ms"] for r in rows if r["turn"] == 0}
    sections = {}
    for key, v in VARIANTS:
        lib, args = args_of(key, v)
        n = inputs[key][3]
        cyc = profile_call(lib, f"{lib}_launch", args, n, dev).sum(0).tolist()
        total = sum(cyc)
        sections[f"{key} {v}"] = {lab: c / total for lab, c in zip(SECTIONS, cyc) if c}
        for lab, share in sections[f"{key} {v}"].items():
            print(f"  {key} {v} section {lab:32s} {share:6.1%} "
                  f"({share * kern_ms[(key, v)]:.4f} ms) | {card}")
    reports = {b: {n: ptxas(so) for n, so in s.items()} for b, s in sos.items()}
    for b, rep in reports.items():
        print(f"ptxas {b} (registers, stack, spill stores) by library and kernel number: {rep}")
    res = dict(card=card, rows=rows, sections=sections, ptxas=reports)
    with open(out_dir / "edge_breakdown.json", "w") as f:
        json.dump(res, f)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
