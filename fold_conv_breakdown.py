#!/usr/bin/env python3
"""Where the conv fold probe's time goes (``csrc/probe_fold_conv.cu``), on
one NVIDIA GPU, by knock-out builds.

    python3 fold_conv_breakdown.py

Builds ``sevennet_tpu_torch/csrc/probe_fold_conv.cu`` as it is and, as
builds of their own, that file with ``fold_conv_breakdown.patch`` applied
(into ``build/fold_conv_breakdown``) and ``-DFC_KO=`` bits of what a build
knocks out: 1 the x loads (x from registers), 2 the tmp loads (tmp from
registers), 4 the terms and sums (left: the MLP's products, the tmp window,
the loads of the split weights), 8 the W3 products (w a constant; the
terms run on it). Every build takes the same launch (the wrapper's plan and
arguments). The kernel build's three variants are first held against
their plain versions (``fold_conv.TOL``) at the script's shape (N 10,016, K
72, SevenNet-0's layer); then every build's variants are timed by
``diff_ms(fn, *FOLD_TIME)``, the builds in turns (the kernel build first and
last). Prints each time and each build's ptxas report (registers, stack,
spills of each instance); the last line is one JSON object with every
number, also written to ``chiprun_out/fold_conv_breakdown.json``.
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

from mm_breakdown import apply_patch

HERE = Path(__file__).resolve().parent
PATCH = HERE / "fold_conv_breakdown.patch"
PATCH_DIR = HERE / "build" / "fold_conv_breakdown"
# build -> FC_KO (None: probe_fold_conv.cu as it is)
BUILDS = {"kernel": None, "no x loads": 1, "no tmp loads": 2, "no x or tmp loads": 3,
          "no terms and sums": 4, "no W3 products": 8}
ORDER = ("kernel", "no x loads", "no tmp loads", "no x or tmp loads", "no terms and sums",
         "no W3 products", "kernel")


def build_patched(ko: int) -> Path:
    """probe_fold_conv.cu with the patch applied, built with ``-DFC_KO=ko``
    into PATCH_DIR by kernels' nvcc and flags (headers from csrc); the
    ptxas report beside it as ``<library>.log``. Returns the library's
    path."""
    from sevennet_tpu_torch.ops import kernels

    text = apply_patch((kernels.CSRC_DIR / "probe_fold_conv.cu").read_text(), PATCH.read_text())
    flags = kernels._flags(False, (f"FC_KO={ko}",))
    digest = hashlib.sha256((text + " ".join(flags)).encode()).hexdigest()[:16]
    PATCH_DIR.mkdir(parents=True, exist_ok=True)
    src = PATCH_DIR / f"probe_fold_conv_{digest}.cu"
    src.write_text(text)
    so = PATCH_DIR / f"libprobe_fold_conv_ko{ko}_{digest}.so"
    proc = subprocess.run([kernels._nvcc(), *flags, "-I", str(kernels.CSRC_DIR), "-o", str(so),
                           str(src)], capture_output=True, text=True)
    Path(str(so) + ".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the patched probe_fold_conv.cu, FC_KO {ko}:\n"
                           f"{proc.stderr[-4000:]}")
    return so


def ptxas(so) -> dict:
    """(registers, stack bytes, spill store bytes, spill load bytes) of each
    conv fold instance, from the ptxas report beside ``so``."""
    rows, name = {}, None
    for ln in open(str(so) + ".log"):
        m = re.search(r"Compiling entry function '_Z\d+(probe_fold_conv_kernelI\w+?)E", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            rows.setdefault(name, [None, *map(int, m.groups())])
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.setdefault(name, [None, None, None, None])[0] = int(m.group(1))
            name = None
    return rows


def main() -> int:
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("fold_conv_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from sevennet_tpu_torch.ops import kernels
    from sevennet_tpu_torch.probes import fold_conv as fcv
    from sevennet_tpu_torch.probes._lib import FOLD_TIME, diff_ms, stream

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sos = {}

    def one(name, ko):
        sos[name] = (kernels.build(["probe_fold_conv"])["probe_fold_conv"] if ko is None
                     else build_patched(ko))

    threads = [threading.Thread(target=one, args=kv) for kv in BUILDS.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if len(sos) != len(BUILDS):
        raise SystemExit(f"fold_conv_breakdown: builds failed: {sorted(set(BUILDS) - set(sos))}")
    libs = {name: ctypes.CDLL(str(so)) for name, so in sos.items()}
    dev = torch.device("cuda")
    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    conv, mlp = fcv.sevennet0_conv()
    n, k, dims = fcv.N, fcv.K, tuple(mlp.dims)
    gen = torch.Generator(device="cpu").manual_seed(10)  # chip_smoke.py's conv fold inputs

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    x = rnd(n, conv.irreps_x.dim, scale=0.5)
    src = torch.randint(0, n, (n, k), generator=gen, dtype=torch.int32).to(dev)
    xg = x[src.reshape(-1).long()].contiguous()
    emb, sh = rnd(n * k, dims[0], scale=0.3), rnd(n * k, conv.irreps_filter.dim, scale=0.5)
    ws = [rnd(a, b) for a, b in zip(dims[:-1], dims[1:])]
    w3j = torch.as_tensor(fcv._tables(conv)[1], device=dev)
    out = torch.empty(n, fcv._tables(conv)[2], device=dev)
    frag = torch.empty(fcv.plan(conv, dims, k, "sliceadd").frag, device=dev)

    def launch(lib, v):
        args = fcv._args(conv, dims, xg, emb, sh, ws, w3j, k, v, out, frag,
                         fcv._device_plan(conv, dims, k, v, dev))
        rc = lib.probe_fold_conv_launch(ctypes.c_int(fcv.VARIANTS.index(v)), args, stream(dev))
        if rc:
            raise RuntimeError(f"probe_fold_conv_launch failed with error {rc}")
        return out

    for v in fcv.VARIANTS:
        want = fcv.fold_conv(conv, xg, emb, sh, ws, w3j, k, v, plain=True)
        err = float((launch(libs["kernel"], v) - want).abs().max()) / float(want.abs().max())
        if not err <= fcv.TOL:
            raise SystemExit(f"fold_conv {v}: the kernel build is {err:.3e} of max |plain| off")
        del want
    rows = []
    for turn, name in enumerate(ORDER):
        for v in fcv.VARIANTS:
            ms = diff_ms(lambda: launch(libs[name], v), *FOLD_TIME)
            rows.append(dict(turn=turn, build=name, variant=v, ms=ms))
            print(f"turn {turn} {name}, {v} (N {n}, K {k}): {ms:.4f} ms | {card}", flush=True)
    reports = {name: ptxas(so) for name, so in sos.items()}
    for name, rep in reports.items():
        print(f"ptxas {name} (registers, stack, spill stores, spill loads): {rep}")
    res = dict(card=card, rows=rows, ptxas=reports)
    with open(out_dir / "fold_conv_breakdown.json", "w") as f:
        json.dump(res, f)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
