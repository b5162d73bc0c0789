#!/usr/bin/env python3
"""Drives the PyTorch port (``sevennet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]      # everything below, one card

1. Builds the CUDA kernels from ``sevennet_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and prints each one's ptxas report.
2. Holds each kernel against its plain PyTorch version on the card at the
   SevenNet-0 shapes of layer 0, layers 1-3 and layer 4, on a water box of
   ~3,000 atoms (K from its neighbour list); times both with CUDA events.
3. Serves single points through the calculator at full SevenNet-0 width
   (random weights from a seed) for water boxes of 192, 3,000 and 9,999
   atoms: 5 forward and 5 backward kernel launches per request; against the
   plain path (192 and 3,000 atoms) forces within 1e-3 eV/A and 1e-4 of the
   largest force, energy within 1e-5 relative, stress within 1e-6 eV/A^3;
   ms per request.
4. Prints a ``kernels`` JSON line, the card's name and power limit, and as
   its last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without CUDA or without the package.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

FP32_PEAK = 67e12     # H100 SXM fp32 (non-tensor) FLOP/s, NVIDIA data sheet
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 bytes/s
REL_TOL = 1e-4        # kernel vs plain: fp32 with another summation order
FORCE_TOL = 1e-3      # eV/A, the repo's force budget (BASELINE.md)
# kernel path against plain path, both fp32 on the card, sums in another
# order (the limits of tests/test_torch_kernels.py); the relative force
# limit keeps the check sharp when random weights give small forces
FORCE_REL_TOL = 1e-4  # of max |F_plain|
ENERGY_REL_TOL = 1e-5
STRESS_TOL = 1e-6     # eV/A^3
SIZES = (192, 3000, 9999)
REPS = 5              # timed requests per size
PLAIN_MAX_ATOMS = 3000  # the plain path's autograd graph grows past ~30 GB above this


def log(msg):
    print(msg, flush=True)


def water_box(n_molecules: int, density_g_cm3: float = 1.0, seed: int = 0):
    """Simple-cubic lattice of water molecules (bench.py's water_box)."""
    import numpy as np

    mass_h2o = 18.015
    n_av = 6.02214076e23
    vol_cm3 = n_molecules * mass_h2o / (n_av * density_g_cm3)
    box = (vol_cm3 ** (1 / 3)) * 1e8
    n_side = int(np.ceil(n_molecules ** (1 / 3)))
    a = box / n_side
    rng = np.random.default_rng(seed)
    pos, Z = [], []
    count = 0
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                if count >= n_molecules:
                    break
                o = (np.array([i, j, k]) + 0.5) * a
                pos += [o, o + [0.757, 0.586, 0.0], o + [-0.757, 0.586, 0.0]]
                Z += [8, 1, 1]
                count += 1
    pos = np.asarray(pos) + rng.normal(scale=0.01, size=(len(pos), 3))
    return pos, np.asarray(Z), np.eye(3) * box


def sevennet0_spec():
    """SevenNet-0 (bench.py:87-147): 5 layers, 128x0e+64x1e+32x2e, lmax 2,
    XPLOR cutoff 5.0 A (on at 4.5), radial MLP [8, 64, 64, numel]."""
    from sevennet_tpu_torch.model.build import build_model_spec

    mid = "128x0e+64x1e+32x2e"
    return build_model_spec({
        "lmax": 2,
        "irreps_manual": ["128x0e", mid, mid, mid, mid, "128x0e"],
        "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 4.5},
        "self_connection_type": "linear",
        "cutoff": 5.0,
        "channel": 128,
        "is_parity": False,
        "num_convolution_layer": 5,
        "weight_nn_hidden_neurons": [64, 64],
        "radial_basis": {"radial_basis_name": "bessel", "bessel_basis_num": 8},
        "conv_denominator": 35.0,
        "chemical_species": ["H", "O"],
    })


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of ``fn`` over ``reps`` calls, CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_median(fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` calls, each timed alone with CUDA
    events, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def work(op, N: int, K: int, n_edges: int, bwd: bool):
    """(flops, bytes) the kernel's function needs on these inputs: the fp32
    multiplies and adds of the edges inside the cutoff (activations, envelope
    and spherical harmonics left out), each input read once, each output
    written once.

    A sum of n products counts 2n - 1 operations. Per edge: the MLP's three
    products, ``tmp = w3j_pack @ sh`` over the nonzeros of ``w3j_pack``, and
    the uvu product with the sums over m factored as the JAX kernel factors
    them (sevennet_tpu/ops/fused_conv.py:906-920). An output column is
    ``w[u] * s``, ``s = sum_m x[m, u] tmp[m, p]``, one product per elementary
    term (c, xc, wc, r); the forward scales s by w and sums it over the
    receiver's edges. The backward recomputes the MLP and tmp, then forms
    ``a[m, u] = sum_p ybar[p, u] tmp[m, p]`` and ``dtmp[r] = sum_u
    (ybar w)[p, u] x[m, u]`` (one product per term each), ``ybar * w`` per
    output column, ``dxg = sum w a`` and ``dw = sum x a`` per gathered x entry
    of each instruction, ``dsh = w3j_packᵀ dtmp`` and the MLP's backward. It
    writes no output of the forward."""

    def mv(n_in, n_out):
        return n_out * (2 * n_in - 1)

    d = op.mlp_spec.dims
    mlp = sum(mv(a, b) for a, b in zip(d[:-1], d[1:]))
    nnz = int((op.w3j_pack != 0).sum())
    tmp = 2 * nnz - op.R
    conv = op.conv
    x_entries = sum(conv.irreps_x[i].dim for i, _, _, _ in conv.instructions)
    ins = 4 * (N * op.dim_x + N * K + 3 * N * K + d[0]
               + sum(a * b for a, b in zip(d[:-1], d[1:])))
    if not bwd:
        # s: 2 n_terms - dim_mid per edge; w * s summed over each row's edges
        flops = (n_edges * (mlp + tmp + 2 * op.n_terms + op.dim_mid) - N * op.dim_mid)
        return flops, ins + 4 * N * op.dim_mid
    mlp_bwd = sum(mv(b, a) for a, b in zip(d[:-1], d[1:]))
    uvu = (4 * op.n_terms - x_entries - op.R + op.dim_mid
           + (2 * x_entries - op.dim_x) + (2 * x_entries - op.numel))
    flops = n_edges * (mlp + tmp + uvu + (2 * nnz - op.embed.dim_f) + mlp_bwd)
    return flops, ins + 4 * (N * op.dim_mid + N * K * op.dim_x + 3 * N * K)


def kernel_phase(spec, params, dev, atoms):
    """Each kernel against its plain version at the three SevenNet-0 layer
    shapes. Returns per-kernel records."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.model.model import edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc

    calc = SevenNetCalculator(spec, params, device=str(dev))
    g = calc.graph(atoms)
    N, K = g.n_atoms_cap, g.dense_k
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=dev)
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T, sentinel[:, None]).contiguous()
    src = g.edge_src.view(N, K).to(torch.int32).contiguous()
    n_edges = int(g.edge_mask.sum())
    coef = calc.params["edge_embedding"]["bessel_coeffs"]
    log(f"kernel shapes: N={N} K={K} real edges={n_edges}")
    gen = torch.Generator(device="cpu").manual_seed(1)
    per_shape = {}
    for tag, t in (("layer0", 0), ("layers1-3", 1), ("layer4", 4)):
        layer = spec.layers[t]
        op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        ws = calc.params[f"{t}_convolution"]["weight_nn"]["w"]
        x = torch.randn(N, op.dim_x, generator=gen).to(dev)
        ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
        args = (op, x, src, vec, coef, ws)
        out_k = fc.fused_conv_fwd(*args)
        out_p = fc.fused_conv_fwd_plain(*args)
        dxg_k, dvec_k = fc.fused_conv_bwd(*args, ybar)
        dxg_p, dvec_p = fc.fused_conv_bwd_plain(*args, ybar)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in (("fwd", out_k, out_p), ("dxg", dxg_k, dxg_p), ("dvec", dvec_k, dvec_p)):
            ok = bool(torch.isfinite(a).all())
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            rel = err / max(scale, 1e-30)
            errs[name] = (err, rel)
            status = "ok" if ok and rel <= REL_TOL else "FAIL"
            log(f"  {tag} {name}: max_abs_err={err:.3e} max|plain|={scale:.3e} "
                f"rel={rel:.3e} (tol {REL_TOL:g}) {status}")
            if status != "ok":
                raise SystemExit(f"kernel {name} disagrees with its plain version at {tag}")
        reps = 10
        t_fk = cuda_time(lambda: fc.fused_conv_fwd(*args), reps)
        t_fp = cuda_time(lambda: fc.fused_conv_fwd_plain(*args), 3)
        t_bk = cuda_time(lambda: fc.fused_conv_bwd(*args, ybar), reps)
        t_bp = cuda_time(lambda: fc.fused_conv_bwd_plain(*args, ybar), 3)
        fw, bw = work(op, N, K, n_edges, False), work(op, N, K, n_edges, True)
        per_shape[tag] = dict(t=t, fwd=(t_fk, t_fp, fw, errs["fwd"][0]),
                              bwd=(t_bk, t_bp, bw, max(errs["dxg"][0], errs["dvec"][0])))
        for kname, (tk, tp, (fl, by), _) in (("fwd", per_shape[tag]["fwd"]),
                                             ("bwd", per_shape[tag]["bwd"])):
            bound = max(fl / FP32_PEAK, by / HBM_BYTES_S) * 1e3
            log(f"  {tag} {kname}: kernel {tk:.4f} ms, plain {tp:.4f} ms, bound {bound:.4f} ms "
                f"({fl / 1e9:.2f} GFLOP, {by / 1e6:.1f} MB), {fl / tk / 1e9:.2f} TFLOP/s")
        del out_k, out_p, dxg_k, dvec_k, dxg_p, dvec_p
        torch.cuda.empty_cache()
    # per request: layer 0 once, layers 1-3 three times, layer 4 once
    counts = {"layer0": 1, "layers1-3": 3, "layer4": 1}
    records = {}
    for kname in ("fwd", "bwd"):
        ms = sum(counts[s] * per_shape[s][kname][0] for s in counts)
        plain_ms = sum(counts[s] * per_shape[s][kname][1] for s in counts)
        flops = sum(counts[s] * per_shape[s][kname][2][0] for s in counts)
        nbytes = sum(counts[s] * per_shape[s][kname][2][1] for s in counts)
        err = max(per_shape[s][kname][3] for s in counts)
        records[kname] = dict(ms=ms, plain_ms=plain_ms, flops=flops, bytes=nbytes, err=err)
    return records, np.asarray([N, K, n_edges])


def request_phase(spec, params, dev):
    """Calculator requests at full width; returns the launches of each
    kernel over the whole phase."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.model.model import model_compute
    from sevennet_tpu_torch.ops import fused_conv as fc

    calc = SevenNetCalculator(spec, params, device=str(dev))
    plain = SevenNetCalculator(spec, params, device=str(dev), plain=True)
    boxes = {n: water_box(n // 3) for n in SIZES}
    fc.fused_conv_fwd.launches = 0
    fc.fused_conv_bwd.launches = 0
    for n in SIZES:
        pos, Z, cell = boxes[n]
        at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
        torch.cuda.reset_peak_memory_stats()
        f0, b0 = fc.fused_conv_fwd.launches, fc.fused_conv_bwd.launches
        res = calc.calculate(at)
        nf, nb = fc.fused_conv_fwd.launches - f0, fc.fused_conv_bwd.launches - b0
        n_layers = len(spec.layers)
        if (nf, nb) != (n_layers, n_layers):
            raise SystemExit(f"{n} atoms: {nf} forward / {nb} backward launches, "
                             f"expected {n_layers} + {n_layers}")
        if not (np.isfinite(res["energy"]) and np.isfinite(res["forces"]).all()
                and np.isfinite(res["stress"]).all()):
            raise SystemExit(f"{n} atoms: non-finite results")
        if res["forces"].shape != (n, 3) or res["stress"].shape != (6,):
            raise SystemExit(f"{n} atoms: forces {res['forces'].shape}, "
                             f"stress {res['stress'].shape}")
        drift = float(np.abs(res["forces"].sum(0)).max())
        line = (f"request {n} atoms: E={res['energy']:.6f} eV, "
                f"|sum F|={drift:.2e}, launches {nf}+{nb}")
        if n <= PLAIN_MAX_ATOMS:
            ref = plain.calculate(at)
            df = float(np.abs(res["forces"] - ref["forces"]).max())
            de = abs(res["energy"] - ref["energy"]) / max(abs(ref["energy"]), 1e-30)
            ds = float(np.abs(res["stress"] - ref["stress"]).max())
            fmax = float(np.abs(ref["forces"]).max())
            line += (f", vs plain: max|dF|={df:.3e} eV/A (max|F_plain|={fmax:.3e}), "
                     f"rel dE={de:.3e}, max|dS|={ds:.3e} eV/A^3")
            checks = ((df <= FORCE_TOL, f"max|dF| {df} > {FORCE_TOL} eV/A"),
                      (df <= FORCE_REL_TOL * fmax,
                       f"max|dF| {df} > {FORCE_REL_TOL} * max|F_plain| {fmax}"),
                      (de <= ENERGY_REL_TOL, f"rel dE {de} > {ENERGY_REL_TOL}"),
                      (ds <= STRESS_TOL, f"max|dS| {ds} > {STRESS_TOL} eV/A^3"))
            for ok, why in checks:
                if not ok:
                    raise SystemExit(f"{n} atoms: kernel path against plain path: {why}")
        log(line)
        # timing after the request above as warm-up: host wall clock of
        # whole requests (neighbour list and host-device copies included),
        # and CUDA events around the model on a prebuilt graph
        walls = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            calc.calculate(at)
            walls.append((time.perf_counter() - t0) * 1e3)
        graph_walls = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            graph = calc.graph(at)
            torch.cuda.synchronize()
            graph_walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        model_ms = cuda_median(lambda: model_compute(spec, calc.params, graph, True, device=dev),
                               REPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  {n} atoms: K={graph.dense_k} edges={int(graph.edge_mask.sum())} "
            f"request median {statistics.median(walls):.1f} ms (wall, {REPS} runs), "
            f"host graph median {statistics.median(graph_walls):.1f} ms (wall), "
            f"model median {model_ms:.2f} ms (CUDA events, {REPS} runs), "
            f"model peak mem {peak:.2f} GiB")
    return fc.fused_conv_fwd.launches, fc.fused_conv_bwd.launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from sevennet_tpu_torch.atoms import AtomsLite
        from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
        from sevennet_tpu_torch.ops import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = kernels.build()
    log(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, so in libs.items():
        rep = [ln.strip() for ln in open(str(so) + ".log") if "registers" in ln or "spill" in ln]
        for ln in rep:
            log(f"  {name}: {ln}")

    spec = sevennet0_spec()
    params = params_from_numpy(spec, random_params(spec, args.seed))
    pos, Z, cell = water_box(1000)
    atoms = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
    records, (N, K, n_edges) = kernel_phase(spec, params, dev, atoms)
    launches = dict(zip(("fwd", "bwd"), request_phase(spec, params, dev)))
    names = {
        "fwd": ("fused_conv_fwd", "sevennet_tpu_torch/csrc/fused_conv_fwd.cu",
                "sevennet_tpu/ops/fused_conv.py:678"),
        "bwd": ("fused_conv_bwd", "sevennet_tpu_torch/csrc/fused_conv_bwd.cu",
                "sevennet_tpu/ops/fused_conv.py:1222"),
    }
    kernels_line = []
    for k in ("fwd", "bwd"):
        r = records[k]
        t_ops, t_bytes = r["flops"] / FP32_PEAK * 1e3, r["bytes"] / HBM_BYTES_S * 1e3
        name, source, replaces = names[k]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
    log(f"kernel times are per request of {N} atoms (K={K}, {n_edges} edges): "
        "layer 0 + 3 x layers 1-3 + layer 4")
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
