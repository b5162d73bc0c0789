#!/usr/bin/env python3
"""Drives the PyTorch port (``sevennet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

1. Builds the CUDA kernels from ``sevennet_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and prints each kernel instance's registers, stack
   frame and spills from the ptxas report.
2. Holds each kernel against its plain PyTorch version on the card at the
   SevenNet-0 shapes of layer 0, layers 1-3 and layer 4, on a water box of
   ~3,000 atoms (K from its neighbour list); times both with CUDA events and
   prints two bounds beside each time: the design's, with the products that
   the kernels run as 3xTF32 on the tensor cores at a third of the TF32
   peak (``work``, ``bound_ms``; the ``kernels`` line's ``bound_ms``), and
   every operation at the fp32 rate.
   Kernels: B1 (forward), B2 (backward), B2' (backward with the radial-MLP
   weight and Bessel-coefficient gradients: records pass and reduction),
   and in emb/sh mode, on the embedding and unnormalized spherical
   harmonics a legacy model feeds them: B4 (forward), B4 bwd, B4' (both
   passes) and B6 (``dense_conv_pallas`` on B4's kernel). Cross-check of
   the modes: B4 on the normalized emb/sh of the same edges matches B1, and
   B4 bwd's demb/dsh chained to the edge vectors by autograd match B2.
   Then B6's own path: ``dense_conv_pallas`` over the five layers. B3 (B2
   on one row chunk writing into a slot of the ring backward's buffer) is
   held against its plain twin in step 5, at the shape the ring runs it.
3. Serves single points through the calculator at full SevenNet-0 width
   (random weights from a seed) for water boxes of 192, 3,000 and 9,999
   atoms: 5 forward and 5 backward kernel launches per request; against the
   plain path (192 and 3,000 atoms) forces within 1e-3 eV/A and 1e-4 of the
   largest force, energy within 1e-5 relative, stress within 1e-6 eV/A^3;
   ms per request. Then the same with ``_normalize_sph: False`` (the
   legacy config every pre-0.10 checkpoint loads as): 5 B4 + 5 B4 bwd
   launches per request and none of B1/B2.
4. Trains SevenNet-0 (full width and depth) on 16 water boxes of 192 atoms
   labelled by a teacher of the same architecture: the first 3 steps of the
   kernel path against the plain path at the same weights (loss within 1e-5
   relative, every gradient leaf within 1e-4 of its largest entry), 5 B1 +
   10 B2' launches per step, the same for the legacy config (5 B4 + 10 B4'
   per step), then 2 epochs through ``train_run`` (lc.csv, checkpoint
   reload); step time, structures/s, peak memory.
5. Runs NVE MD of water (0.5 fs steps, 300 K) through ``MDEngine``: 3,000
   atoms for 10 steps against an engine on the plain conv (positions within
   1e-4 A, energy within 1e-5 relative, a device rebuild whose slots equal
   a host build); 9,999 atoms unchunked (40 timed steps); 99,999 atoms
   with the ring backward in every layer: B3 against its plain twin at the
   ring's chunk shape and on its edges (an interior and a wrapped chunk,
   the other slots bitwise unchanged; timed over the nb chunks), the ring
   engine's initial forces against an unchunked engine's (1e-3 eV/A and
   1e-4 of max |F|), the peak memory of one step of each, then 10 timed
   ring steps. Launches per force evaluation: 5 B1 + 5 B2, or with the
   ring 5 B1 + 5 nb B3 and no B2.
6. Prints a ``kernels`` JSON line, the card's name and power limit, and as
   its last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without CUDA or without the package.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time

FP32_PEAK = 67e12     # H100 SXM fp32 (non-tensor) FLOP/s, NVIDIA data sheet
TC_3XTF32_PEAK = 495e12 / 3  # TF32 tensor cores (data sheet), three products per fp32 one
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
# training phase: full SevenNet-0 on water boxes labelled by a teacher
TRAIN_BOXES = 16       # structures of 192 atoms (64 molecules)
TRAIN_BATCH = 4
TRAIN_EPOCHS = 2
TRAIN_LR = 1e-3
TRAIN_CMP_STEPS = 3    # steps held against the plain path
# MD phases: NVE of water boxes at 300 K
MD_T = 300.0
MD_DT = 0.5            # fs
MD_CMP_STEPS = 10      # 3,000 atoms, kernel engine vs plain-conv engine
MD_CMP_SKIN = 0.2      # A: a device rebuild within the compared steps
MD_POS_TOL = 1e-4      # A, positions after MD_CMP_STEPS steps
MD_CHUNK = 10          # steps per chunk (a capacity growth retries one chunk)
MD_WARMUP_STEPS = 10   # 9,999 atoms
MD_TIMED_STEPS = 40
MD_RING_WARMUP = 4     # 99,999 atoms, ring: after one step measured alone
MD_RING_STEPS = 10
MD_RING_EDGE_CHUNK = 163840  # slots per chunk, bench.py:139-141
MD_RING_THRESHOLD = 1_000_000_000  # bytes: every layer chunks, bench.py:355-357
LOSS_REL_TOL = 1e-5    # kernel vs plain train step, loss
GRAD_REL_TOL = 1e-4    # kernel vs plain train step, per leaf of max |g_plain|


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


SEVENNET0 = {  # bench.py:87-147
    "lmax": 2,
    "irreps_manual": ["128x0e"] + ["128x0e+64x1e+32x2e"] * 4 + ["128x0e"],
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
}


def sevennet0_spec():
    """SevenNet-0 (bench.py:87-147): 5 layers, 128x0e+64x1e+32x2e, lmax 2,
    XPLOR cutoff 5.0 A (on at 4.5), radial MLP [8, 64, 64, numel]."""
    from sevennet_tpu_torch.model.build import build_model_spec

    return build_model_spec(SEVENNET0)


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


def work(op, N: int, K: int, n_edges: int, kind: str):
    """(flops, bytes, tc_flops) the kernel's function needs on these inputs:
    ``tc_flops`` is the part of ``flops`` that the kernels run on the tensor
    cores as 3xTF32: every product counted here (the radial MLP's layers,
    ``tmp``, the uvu product and, in the backward, their transposes and
    pullbacks) but the parameter-gradient sums of B2' and B4', which the
    reduction kernel runs on the CUDA cores. The fp32
    multiplies and adds of the edges inside the cutoff (activations, envelope
    and spherical harmonics left out), each input read once, each output
    written once. ``kind``: ``fwd`` (B1), ``bwd`` (B2, and B3: B2 writing
    into a slot), ``bwd_pg`` (B2'), ``reduce`` (B2''s second pass alone),
    ``fwd_embsh`` (B4's forward and B6: the forward on a precomputed
    embedding and spherical harmonics), ``bwd_embsh`` (B4's backward and
    B5: ``dxg``, ``demb`` and ``dsh`` in place of ``dvec``) or
    ``bwd_embsh_pg`` (B4': no ``dcoef``). The emb/sh backward needs every
    slot, padding included: a zero emb row still has a nonzero ``demb``.

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
    writes no output of the forward.

    B2' adds the parameter gradients, sums over all E edges:
    ``dW_l = sum_e h_l ⊗ g_l / sqrt(d_l)`` (2E operations per entry) and
    ``dcoef[n] = sum_e demb * (2/rc) cos(c_n r) env`` (4E - 1 per basis
    function), and writes them. Its per-edge records are an intermediate of
    the kernel's design, not of the function, and are not counted. The
    reduction alone reads the records of the E edges (and a validity byte
    per slot) and does the same sums."""

    def mv(n_in, n_out):
        return n_out * (2 * n_in - 1)

    d = op.mlp_spec.dims
    embsh = "_embsh" in kind
    n_dw = sum(a * b for a, b in zip(d[:-1], d[1:]))
    n_dc = 0 if embsh else d[0]
    pg_flops = n_dw * 2 * n_edges + n_dc * (4 * n_edges - 1)
    pg_bytes = 4 * (n_dw + n_dc)
    if kind == "reduce":
        record = sum(d[:-1]) + sum(d[1:]) + d[0]  # emb h1 h2 | dz1 dz2 dw | dcoef terms
        return pg_flops, 4 * n_edges * record + N * K + pg_bytes, 0
    mlp = sum(mv(a, b) for a, b in zip(d[:-1], d[1:]))
    nnz = int((op.w3j_pack != 0).sum())
    tmp = 2 * nnz - op.R
    conv = op.conv
    x_entries = sum(conv.irreps_x[i].dim for i, _, _, _ in conv.instructions)
    # per edge slot: the edge vector, or in emb/sh mode (B4, B5, B6) the
    # precomputed embedding and spherical harmonics
    edge_in = op.n_basis + op.dim_f if embsh else 3
    ins = 4 * (N * op.dim_x + N * K + edge_in * N * K + d[0] + n_dw)
    if kind in ("fwd", "fwd_embsh"):
        # s: 2 n_terms - dim_mid per edge; w * s summed over each row's edges
        flops = (n_edges * (mlp + tmp + 2 * op.n_terms + op.dim_mid) - N * op.dim_mid)
        return flops, ins + 4 * N * op.dim_mid, flops
    mlp_bwd = sum(mv(b, a) for a, b in zip(d[:-1], d[1:]))
    uvu = (4 * op.n_terms - x_entries - op.R + op.dim_mid
           + (2 * x_entries - op.dim_x) + (2 * x_entries - op.numel))
    n_bwd = N * K if embsh else n_edges
    flops = n_bwd * (mlp + tmp + uvu + (2 * nnz - op.dim_f) + mlp_bwd)
    nbytes = ins + 4 * (N * op.dim_mid + N * K * op.dim_x + edge_in * N * K)
    if kind in ("bwd_pg", "bwd_embsh_pg"):
        return flops + pg_flops, nbytes + pg_bytes, flops
    return flops, nbytes, flops


def bound_ms(flops: float, nbytes: float, tc_flops: float = 0.0):
    """(ms, bound_by): the least time the card could take for this work, the
    larger of its operations over their peak rates and its bytes over the
    memory rate. The ``tc_flops`` of ``flops`` that the kernels run on the
    tensor cores as 3xTF32 (fp32 accuracy) count at a third of the TF32
    peak, the others at the fp32 peak (one after the other, as one CTA's
    warps issue them). ``tc_flops=0`` gives the fp32 bound: every operation
    at the fp32 peak."""
    t_ops = (tc_flops / TC_3XTF32_PEAK + (flops - tc_flops) / FP32_PEAK) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# kernel instances by mangled name and template arguments (ILb<PG>ELb<EMBSH>EE)
INSTANCES = {
    ("fused_conv_fwd_kernel", "0"): "fwd<vec> (B1)",
    ("fused_conv_fwd_kernel", "1"): "fwd<emb/sh> (B4 fwd, B6)",
    ("fused_conv_bwd_kernel", "00"): "bwd<vec> (B2, B3)",
    ("fused_conv_bwd_kernel", "10"): "bwd<vec, records> (B2' first pass)",
    ("fused_conv_bwd_kernel", "01"): "bwd<emb/sh> (B4 bwd, B5)",
    ("fused_conv_bwd_kernel", "11"): "bwd<emb/sh, records> (B4' first pass)",
    ("pg_partial_kernel", ""): "pg_partial (reduction)",
    ("pg_final_kernel", ""): "pg_final (reduction)",
}


def ptxas_table(libs):
    """Registers, stack frame and spills of every kernel instance, from the
    ptxas reports (``-Xptxas -v``) that ``kernels.build`` keeps beside each
    library."""
    import re

    rows, row = [], None
    for so in libs.values():
        for ln in open(str(so) + ".log"):
            m = re.search(r"Compiling entry function '_Z(\d+)(\w+)", ln)
            if m:
                n = int(m.group(1))
                name, rest = m.group(2)[:n], m.group(2)[n:]
                args = "".join(re.findall(r"Lb(\d)E", rest.split("Ev")[0])) if rest[:1] == "I" else ""
                row = dict(instance=INSTANCES.get((name, args), name + args),
                           registers=None, stack=None, spill_stores=None, spill_loads=None)
                rows.append(row)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and row is not None:
                row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and row is not None:
                row["registers"] = int(m.group(1))
    return rows


def check_close(tag: str, name: str, got, want, tol: float = REL_TOL):
    """max |got - want| within ``tol`` of max |want|, all finite; returns
    the max abs error. Raises SystemExit otherwise."""
    import torch

    ok = bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = err / max(scale, 1e-30)
    status = "ok" if ok and rel <= tol else "FAIL"
    log(f"  {tag} {name}: max_abs_err={err:.3e} max|plain|={scale:.3e} "
        f"rel={rel:.3e} (tol {tol:g}) {status}")
    if status != "ok":
        raise SystemExit(f"{name} disagrees with its plain version at {tag}")
    return err


KERNELS = ("fwd", "bwd", "bwd_pg", "reduce", "fwd_embsh", "bwd_embsh", "bwd_embsh_pg", "b6")
# per 3,000-atom pass: layer 0 once, layers 1-3 three times, layer 4 once
SHAPES = (("layer0", 0, 1), ("layers1-3", 1, 3), ("layer4", 4, 1))


def pg_float64_check(tag, op, args, ybar, outs_k, outs_p):
    """When B2''s parameter gradients miss the limit: both sides against a
    float64 plain version on the card, printed, to tell the kernel's error
    from the fp32 plain version's."""
    from sevennet_tpu_torch.ops import fused_conv as fc

    op_, x, src, vec, coef, ws = args
    ref = fc.fused_conv_bwd_plain(op_, x.double(), src, vec.double(), coef.double(),
                                  [w.double() for w in ws], ybar.double(), param_grads=True)
    for i, name in enumerate(("dW1", "dW2", "dW3")):
        r = ref[2][i]
        for side, o in (("kernel", outs_k), ("plain fp32", outs_p)):
            err = float((o[2][i].double() - r).abs().max()) / float(r.abs().max())
            log(f"  {tag} {name} {side} vs float64: rel {err:.3e}")


def kernel_phase(spec, params, dev, atoms):
    """Each kernel against its plain version at the three SevenNet-0 layer
    shapes, in vec mode on the box's edge vectors and in emb/sh mode on the
    embedding and unnormalized spherical harmonics a legacy model computes
    from them; and the two modes against each other. Returns per-kernel
    records (times summed over one 3,000-atom pass) and the shapes."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.model.model import edge_emb_sh, edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops.pallas_conv import dense_conv_pallas

    calc = SevenNetCalculator(spec, params, device=str(dev))
    g = calc.graph(atoms)
    N, K = g.n_atoms_cap, g.dense_k
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=dev)
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T, sentinel[:, None]).contiguous()
    src = g.edge_src.view(N, K).to(torch.int32).contiguous()
    n_edges = int(g.edge_mask.sum())
    coef = calc.params["edge_embedding"]["bessel_coeffs"]
    # what the legacy model (unnormalized spherical harmonics) feeds the conv
    emb_l, sh_l = (t.contiguous() for t in edge_emb_sh(
        dataclasses.replace(spec, normalize_sph=False), coef, vec, g.edge_mask))
    log(f"kernel shapes: N={N} K={K} real edges={n_edges}")
    gen = torch.Generator(device="cpu").manual_seed(1)
    per_shape, ops = {}, {}
    for tag, t, _ in SHAPES:
        layer = spec.layers[t]
        op = ops[tag] = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        op_e = fc.conv_op(layer.conv, layer.radial_mlp)
        ws = calc.params[f"{t}_convolution"]["weight_nn"]["w"]
        x = torch.randn(N, op.dim_x, generator=gen).to(dev)
        ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
        args = (op, x, src, vec, coef, ws)
        eargs = (op_e, x, src, emb_l, sh_l, ws)
        errs = {}
        out_b1 = fc.fused_conv_fwd(*args)
        errs["fwd"] = check_close(tag, "fwd", out_b1, fc.fused_conv_fwd_plain(*args))
        dxg_k, dvec_k = fc.fused_conv_bwd(*args, ybar)
        dxg_p, dvec_p = fc.fused_conv_bwd_plain(*args, ybar)
        errs["bwd"] = max(check_close(tag, "dxg", dxg_k, dxg_p),
                          check_close(tag, "dvec", dvec_k, dvec_p))
        del dxg_p, dvec_p
        # B2': both passes through the wrapper, against the plain twin
        outs_k = fc.fused_conv_bwd(*args, ybar, param_grads=True)
        outs_p = fc.fused_conv_bwd_plain(*args, ybar, param_grads=True)
        torch.cuda.synchronize()
        pairs = [("pg dxg", outs_k[0], outs_p[0]), ("pg dvec", outs_k[1], outs_p[1])]
        pairs += [(f"dW{i + 1}", a, b) for i, (a, b) in enumerate(zip(outs_k[2], outs_p[2]))]
        pairs += [("dcoef", outs_k[3], outs_p[3])]
        try:
            errs["bwd_pg"] = max(check_close(tag, n, a, b) for n, a, b in pairs)
        except SystemExit:
            pg_float64_check(tag, op, args, ybar, outs_k, outs_p)
            raise
        # the reduction alone, on the records of the first pass
        _, _, work_, valid = fc.fused_conv_bwd_pg_records(*args, ybar)
        red_k = fc.param_grad_reduce(op, work_, valid, N, K)
        red_p = fc.param_grad_reduce_plain(op, work_, valid)
        errs["reduce"] = max(check_close(tag, f"reduce {n}", a, b) for n, a, b in zip(
            ("dW1", "dW2", "dW3", "dcoef"), [*red_k[0], red_k[1]], [*red_p[0], red_p[1]]))
        del outs_k, outs_p, red_k, red_p

        # emb/sh mode against vec mode on the same edges: B4 on the normalized
        # emb/sh of the edge vectors matches B1; B4 bwd's demb and dsh, chained
        # to the edge vectors by autograd, match B2's dvec
        emb_n, sh_n = fc.edge_embedding_plain(op, vec, coef)
        nargs = (op_e, x, src, emb_n.contiguous(), sh_n.contiguous(), ws)
        check_close(tag, "B4 fwd (normalized emb/sh) vs B1", fc.fused_conv_fwd_embsh(*nargs),
                    out_b1)
        dxg_n, demb_n, dsh_n = fc.fused_conv_bwd_embsh(*nargs, ybar)
        v = vec.clone().requires_grad_(True)
        (dvec_chain,) = torch.autograd.grad(fc.edge_embedding_plain(op, v, coef), v,
                                            (demb_n, dsh_n))
        check_close(tag, "B4 bwd dxg vs B2", dxg_n, dxg_k)
        check_close(tag, "B4 bwd demb, dsh chained to dvec vs B2", dvec_chain, dvec_k)
        del dxg_k, dvec_k, dxg_n, demb_n, dsh_n, dvec_chain, emb_n, sh_n

        # emb/sh mode on the legacy model's inputs: B4, B4 bwd, B4' and B6
        out_p = fc.fused_conv_fwd_embsh_plain(*eargs)
        errs["fwd_embsh"] = check_close(tag, "B4 fwd", fc.fused_conv_fwd_embsh(*eargs), out_p)
        errs["b6"] = check_close(tag, "B6 dense_conv_pallas", dense_conv_pallas(
            layer.conv, layer.radial_mlp, x, emb_l.view(N, K, -1), sh_l.view(N, K, -1), src, ws),
            out_p)
        got = fc.fused_conv_bwd_embsh(*eargs, ybar)
        want = fc.fused_conv_bwd_embsh_plain(*eargs, ybar, param_grads=True)
        errs["bwd_embsh"] = max(check_close(tag, f"B4 bwd {n}", a, b)
                                for n, a, b in zip(("dxg", "demb", "dsh"), got, want))
        got = fc.fused_conv_bwd_embsh(*eargs, ybar, param_grads=True)
        pairs = [(f"B4' {n}", a, b) for n, a, b in zip(("dxg", "demb", "dsh"), got, want)]
        pairs += [(f"B4' dW{i + 1}", a, b) for i, (a, b) in enumerate(zip(got[3], want[3]))]
        errs["bwd_embsh_pg"] = max(check_close(tag, n, a, b) for n, a, b in pairs)
        del got, want, out_p

        reps = 10
        times = {
            "fwd": (cuda_time(lambda: fc.fused_conv_fwd(*args), reps),
                    cuda_time(lambda: fc.fused_conv_fwd_plain(*args), 3)),
            "bwd": (cuda_time(lambda: fc.fused_conv_bwd(*args, ybar), reps),
                    cuda_time(lambda: fc.fused_conv_bwd_plain(*args, ybar), 3)),
            "bwd_pg": (cuda_time(lambda: fc.fused_conv_bwd(*args, ybar, param_grads=True), reps),
                       cuda_time(lambda: fc.fused_conv_bwd_plain(*args, ybar, param_grads=True), 3)),
            "reduce": (cuda_time(lambda: fc.param_grad_reduce(op, work_, valid, N, K), reps),
                       cuda_time(lambda: fc.param_grad_reduce_plain(op, work_, valid), 3)),
            "fwd_embsh": (cuda_time(lambda: fc.fused_conv_fwd_embsh(*eargs), reps),
                          cuda_time(lambda: fc.fused_conv_fwd_embsh_plain(*eargs), 3)),
            "bwd_embsh": (cuda_time(lambda: fc.fused_conv_bwd_embsh(*eargs, ybar), reps),
                          cuda_time(lambda: fc.fused_conv_bwd_embsh_plain(*eargs, ybar), 3)),
            "bwd_embsh_pg": (
                cuda_time(lambda: fc.fused_conv_bwd_embsh(*eargs, ybar, param_grads=True), reps),
                cuda_time(lambda: fc.fused_conv_bwd_embsh_plain(*eargs, ybar, param_grads=True),
                          3)),
            "b6": (cuda_time(lambda: dense_conv_pallas(
                layer.conv, layer.radial_mlp, x, emb_l.view(N, K, -1), sh_l.view(N, K, -1), src,
                ws), reps), cuda_time(lambda: fc.fused_conv_fwd_embsh_plain(*eargs), 3)),
        }
        per_shape[tag] = {}
        for k in KERNELS:
            tk, tp = times[k]
            fl, by, tc = work(op_e if "embsh" in k or k == "b6" else op, N, K, n_edges,
                              "fwd_embsh" if k == "b6" else k)
            per_shape[tag][k] = (tk, tp, (fl, by, tc), errs[k])
            log(f"  {tag} {k}: kernel {tk:.4f} ms, plain {tp:.4f} ms, bound "
                f"{bound_ms(fl, by, tc)[0]:.4f} ms (fp32 {bound_ms(fl, by)[0]:.4f} ms; "
                f"{fl / 1e9:.2f} GFLOP of which {tc / 1e9:.2f} 3xTF32, {by / 1e6:.1f} MB), "
                f"{fl / tk / 1e9:.2f} TFLOP/s")
        del work_, valid
        torch.cuda.empty_cache()
    records = {}
    for k in KERNELS:
        rows = [(per_shape[tag][k], n) for tag, _, n in SHAPES]
        records[k] = dict(ms=sum(n * r[0] for r, n in rows), plain_ms=sum(n * r[1] for r, n in rows),
                          flops=sum(n * r[2][0] for r, n in rows),
                          bytes=sum(n * r[2][1] for r, n in rows),
                          tc_flops=sum(n * r[2][2] for r, n in rows), err=max(r[3] for r, _ in rows))
    return records, np.asarray([N, K, n_edges])


def b3_check(eng, st, dev, card: str):
    """Kernel B3 (``fused_conv_bwd_slot``: B2 on one row chunk, its dxg
    written into a slot of the ring backward's buffer) against its plain
    twin at the shape the ring engine ``eng`` runs it on the state ``st``:
    chunks of RC = ``eng.row_chunk`` rows of K = ``eng.k_model`` slots on
    the state's edges, x over all nb * RC rows, a buffer of 4W + 1 slots
    pre-filled with a sentinel; at the three SevenNet-0 layer shapes, random
    x and ybar. For an interior and a wrapped (pinned) chunk: the slot's dxg
    and the chunk's dvec within REL_TOL of max |plain|, every other slot
    bitwise unchanged. Times: B3 over the nb chunks per force evaluation
    (layer 0 + 3 x layers 1-3 + layer 4), CUDA events; bound: B2's work over
    the chunks' rows. Returns the kernels-line record."""
    import torch

    from sevennet_tpu_torch.model.model import edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc

    spec = eng.spec
    N, K, RC, W, nb = st.n_atoms_cap, eng.k_model, eng.row_chunk, eng._ring_w, eng._ring_nb
    S = 4 * W + 1
    g = eng._graph(st)
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=dev)
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T, sentinel[:, None]).contiguous()
    src = g.edge_src.view(N, K).to(torch.int32).contiguous()
    coef = eng.params["edge_embedding"]["bessel_coeffs"]
    valid = g.edge_mask.view(N, K)
    gen = torch.Generator(device="cpu").manual_seed(4)

    def chunk(j, ybar):
        return fc._chunk(RC, K, j, src, vec, ybar)

    log(f"  B3 at the ring's shape: N={N} K={K}, {nb} chunks of RC={RC} rows, W={W}, {S} slots")
    rec = dict(ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, tc_flops=0.0, err=0.0)
    for tag, t, n_layers in SHAPES:
        layer = spec.layers[t]
        op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        ws = eng.params[f"{t}_convolution"]["weight_nn"]["w"]
        x = torch.randn(N, op.dim_x, generator=gen).to(dev)
        ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
        buf = torch.full((S * RC * K, op.dim_x), -7.25e30, device=dev)
        for j in (nb // 2, 0):  # an interior chunk and a wrapped (pinned) one
            slot = fc.ring_slot(j, W)
            before = buf.clone()
            src_c, vec_c, yb = chunk(j, ybar)
            dvec = fc.fused_conv_bwd_slot(op, x, src_c, vec_c, coef, ws, yb, buf, slot)
            dxg_p, dvec_p = fc.fused_conv_bwd_plain(op, x, src_c, vec_c, coef, ws, yb)
            torch.cuda.synchronize()
            rows = slice(slot * RC * K, (slot + 1) * RC * K)
            err = max(check_close(f"{tag} chunk {j}", "B3 dxg in its slot", buf[rows], dxg_p),
                      check_close(f"{tag} chunk {j}", "B3 dvec", dvec, dvec_p))
            rec["err"] = max(rec["err"], err)
            other = torch.ones(S * RC * K, dtype=torch.bool, device=dev)
            other[rows] = False
            if not torch.equal(buf[other], before[other]):
                raise SystemExit(f"B3 at {tag}, chunk {j}: rows outside slot {slot} changed")
            log(f"  {tag} chunk {j} (slot {slot}): the other {S - 1} slots bitwise unchanged")
            del dxg_p, dvec_p, before, other
        torch.cuda.empty_cache()

        chunks = [chunk(j, ybar) for j in range(nb)]

        def run(fn):
            return lambda: [fn(op, x, s_c, v_c, coef, ws, y_c, buf, fc.ring_slot(j, W))
                            for j, (s_c, v_c, y_c) in enumerate(chunks)]

        tk = cuda_time(run(fc.fused_conv_bwd_slot), 3)
        tp = cuda_time(run(fc.fused_conv_bwd_slot_plain), 1)
        parts = [work(op, RC, K, int(valid[j * RC:(j + 1) * RC].sum()), "bwd") for j in range(nb)]
        fl, by, tc = (sum(p[i] for p in parts) for i in range(3))
        log(f"  {tag} B3 over {nb} chunks: kernel {tk:.4f} ms, plain {tp:.4f} ms, bound "
            f"{bound_ms(fl, by, tc)[0]:.4f} ms (fp32 {bound_ms(fl, by)[0]:.4f} ms; "
            f"{fl / 1e9:.2f} GFLOP, {by / 1e6:.1f} MB) | {card}")
        for key, v in (("ms", tk), ("plain_ms", tp), ("flops", fl), ("bytes", by),
                       ("tc_flops", tc)):
            rec[key] += n_layers * v
        del buf, chunks, x, ybar
        torch.cuda.empty_cache()
    return rec


def b6_path(spec, params, dev, atoms):
    """B6's own path: ``dense_conv_pallas`` (the counterpart of the JAX
    package's, whose one caller runs a forward conv) over the five
    SevenNet-0 layers of the box, on the legacy model's emb/sh and random
    features, counts from 0. Returns the launches."""
    import torch

    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.model.model import edge_emb_sh
    from sevennet_tpu_torch.ops.pallas_conv import dense_conv_pallas

    calc = SevenNetCalculator(spec, params, device=str(dev))
    g = calc.graph(atoms)
    N, K = g.n_atoms_cap, g.dense_k
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=dev)
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T, sentinel[:, None])
    emb, sh = edge_emb_sh(spec, calc.params["edge_embedding"]["bessel_coeffs"], vec, g.edge_mask)
    gen = torch.Generator(device="cpu").manual_seed(3)
    src = g.edge_src.view(N, K)
    reset_launches()
    for layer in spec.layers:
        ws = calc.params[f"{layer.t}_convolution"]["weight_nn"]["w"]
        x = torch.randn(N, layer.conv.irreps_x.dim, generator=gen).to(dev)
        out = dense_conv_pallas(layer.conv, layer.radial_mlp, x, emb.view(N, K, -1),
                                sh.view(N, K, -1), src, ws)
        if out.shape != (N, layer.conv.irreps_mid.dim) or not bool(torch.isfinite(out).all()):
            raise SystemExit(f"B6 path, layer {layer.t}: {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    counts = read_launches()
    want = dict.fromkeys(counts, 0)
    want["b6"] = len(spec.layers)
    if counts != want:
        raise SystemExit(f"B6 path launches {counts}, expected {want}")
    return counts


def counters():
    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops.pallas_conv import dense_conv_pallas

    return {"fwd": fc.fused_conv_fwd, "bwd": fc.fused_conv_bwd, "bwd_slot": fc.fused_conv_bwd_slot,
            "bwd_pg": fc.fused_conv_bwd_pg_records, "reduce": fc.param_grad_reduce,
            "fwd_embsh": fc.fused_conv_fwd_embsh, "bwd_embsh": fc.fused_conv_bwd_embsh,
            "bwd_embsh_pg": fc.fused_conv_bwd_embsh_pg_records, "b6": dense_conv_pallas}


def reset_launches():
    for fn in counters().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in counters().items()}


def request_phase(spec, params, dev, label: str, fwd: str, bwd: str, graph_times: bool = True):
    """Calculator requests at full width, each launching the kernels
    ``fwd`` and ``bwd`` (keys of :func:`counters`) once per layer and no
    other; returns the launches of each kernel over the whole phase."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.model.model import model_compute

    calc = SevenNetCalculator(spec, params, device=str(dev))
    plain = SevenNetCalculator(spec, params, device=str(dev), plain=True)
    boxes = {n: water_box(n // 3) for n in SIZES}
    reset_launches()
    for n in SIZES:
        pos, Z, cell = boxes[n]
        at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
        torch.cuda.reset_peak_memory_stats()
        before = read_launches()
        res = calc.calculate(at)
        got = {k: v - before[k] for k, v in read_launches().items()}
        want = dict.fromkeys(got, 0)
        want[fwd] = want[bwd] = len(spec.layers)
        if got != want:
            raise SystemExit(f"{label} request, {n} atoms: launches {got}, expected {want}")
        if not (np.isfinite(res["energy"]) and np.isfinite(res["forces"]).all()
                and np.isfinite(res["stress"]).all()):
            raise SystemExit(f"{n} atoms: non-finite results")
        if res["forces"].shape != (n, 3) or res["stress"].shape != (6,):
            raise SystemExit(f"{n} atoms: forces {res['forces'].shape}, "
                             f"stress {res['stress'].shape}")
        drift = float(np.abs(res["forces"].sum(0)).max())
        line = (f"{label} request {n} atoms: E={res['energy']:.6f} eV, "
                f"|sum F|={drift:.2e}, launches {got[fwd]} {fwd} + {got[bwd]} {bwd}")
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
        for _ in range(REPS if graph_times else 1):
            t0 = time.perf_counter()
            graph = calc.graph(at)
            torch.cuda.synchronize()
            graph_walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        model_ms = cuda_median(lambda: model_compute(spec, calc.params, graph, True, device=dev),
                               REPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        host = (f"host graph median {statistics.median(graph_walls):.1f} ms (wall), "
                if graph_times else "")
        log(f"  {label} {n} atoms: K={graph.dense_k} edges={int(graph.edge_mask.sum())} "
            f"request median {statistics.median(walls):.1f} ms (wall, {REPS} runs), {host}"
            f"model median {model_ms:.2f} ms (CUDA events, {REPS} runs), "
            f"model peak mem {peak:.2f} GiB")
    return read_launches()


def training_set(spec, params_teacher, dev, seed: int, path: str):
    """TRAIN_BOXES water boxes of 192 atoms, jittered from ``seed``, labelled
    (energy, forces, stress) by a teacher of the same architecture through
    the port's calculator; written as extxyz to ``path``."""
    import numpy as np

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.data.extxyz import write_extxyz

    teacher = SevenNetCalculator(spec, params_teacher, device=str(dev))
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(TRAIN_BOXES):
        pos, Z, cell = water_box(64, seed=seed * 1000 + i)
        pos = pos + rng.normal(scale=0.05, size=pos.shape)
        r = teacher.calculate(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
        # ASE Voigt (xx,yy,zz,yz,xz,xy) -> the label: -stress, (xx,yy,zz,xy,yz,zx)
        label = -np.asarray(r["stress"])[[0, 1, 2, 5, 3, 4]]
        frames.append(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True,
                                energy=r["energy"], forces=r["forces"], stress=label))
    write_extxyz(path, frames)
    return frames


def step_breakdown(spec, trainer, batch):
    """Parts of a train step at the batch's shapes, ms, CUDA events: the
    energy and forces with the graph kept (``model_compute(...,
    create_graph=True)``, median of 5), and per step the kernels (5 B1 and
    2 x 5 B2' launches) and the conv's plain second-order rule (5 calls),
    each layer on the batch's edge vectors with random x, cotangent and
    second-order cotangents (mean of 5)."""
    import torch

    from sevennet_tpu_torch.model.model import edge_embed_spec, model_compute
    from sevennet_tpu_torch.ops import fused_conv as fc

    N, K = batch.n_atoms_cap, batch.dense_k
    sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=batch.device)
    vec = torch.where(batch.edge_mask[None], batch.edge_vectors().T, sentinel[:, None]).contiguous()
    src = batch.edge_src.view(N, K).to(torch.int32).contiguous()
    coef = trainer.params["edge_embedding"]["bessel_coeffs"].detach()
    gen = torch.Generator(device="cpu").manual_seed(2)
    out = {"fwd_forces": cuda_median(lambda: model_compute(
        spec, trainer.params, batch, device=batch.device, create_graph=True), REPS),
        "b1": 0.0, "b2pg": 0.0, "second_order": 0.0}
    for layer in spec.layers:
        op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        ws = [w.detach() for w in trainer.params[f"{layer.t}_convolution"]["weight_nn"]["w"]]

        def rnd(*shape):
            return torch.randn(*shape, generator=gen).to(batch.device)

        x, ybar = rnd(N, op.dim_x), rnd(N, op.dim_mid)
        cots = (rnd(N * K, op.dim_x), rnd(3, N * K))
        out["b1"] += cuda_time(lambda: fc.fused_conv_fwd(op, x, src, vec, coef, ws), 5)
        out["b2pg"] += 2 * cuda_time(lambda: fc.fused_conv_bwd(
            op, x, src, vec, coef, ws, ybar, param_grads=True), 5)
        out["second_order"] += cuda_time(lambda: fc.fused_conv_bwd_vjp_plain(
            op, x, src, vec, coef, ws, ybar, cots), 5)
    return out


def compare_steps(label, kern, plain, batches, want, card):
    """TRAIN_CMP_STEPS train steps of ``kern`` (the kernel path), each held
    against the plain path's loss and gradients at the same weights and
    batch, each launching exactly ``want``. Returns the launches summed over
    the steps."""
    import numpy as np
    import torch

    total = dict.fromkeys(want, 0)
    for step in range(TRAIN_CMP_STEPS):
        b = batches[step % len(batches)]
        torch.cuda.reset_peak_memory_stats()
        total_p, _, _ = plain._loss_and_metrics(kern.params, b)
        g_plain = torch.autograd.grad(total_p, kern.trainable)
        loss_p = total_p.item()
        del total_p
        peak_plain = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, _ = kern.train_step(b)
        counts = read_launches()
        peak_kern = torch.cuda.max_memory_allocated() / 2**30
        loss_k = losses["total"].item()
        rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
        worst = 0.0
        for p, gp in zip(kern.trainable, g_plain):
            err = float((p.grad - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
            worst = max(worst, err)
            if not (bool(torch.isfinite(p.grad).all()) and err <= GRAD_REL_TOL):
                raise SystemExit(f"{label} train step {step + 1}: gradient leaf {tuple(p.shape)} "
                                 f"differs from the plain path by {err:.3e} of its max")
        log(f"  {label} step {step + 1}: loss kernel {loss_k:.8e} plain {loss_p:.8e} rel "
            f"{rel:.3e} (tol {LOSS_REL_TOL:g}); worst gradient leaf {worst:.3e} of its max "
            f"(tol {GRAD_REL_TOL:g}); launches {counts}; peak GiB kernel {peak_kern:.2f} "
            f"plain {peak_plain:.2f} | {card}")
        if not (np.isfinite(loss_k) and rel <= LOSS_REL_TOL):
            raise SystemExit(f"{label} train step {step + 1}: loss {loss_k} vs plain {loss_p}")
        if counts != want:
            raise SystemExit(f"{label} train step {step + 1}: launches {counts}, expected {want}")
        total = {k: total[k] + counts[k] for k in total}
        del g_plain
    return total


def training_phase(dev, seed: int, card: str):
    """SevenNet-0 training on the card: the kernel path against the plain
    path for TRAIN_CMP_STEPS steps, step timing, the same for the legacy
    config (unnormalized spherical harmonics: B4 and B4'), then
    ``train_run`` (the main path). Returns the launches of the ``train_run``
    run and of the legacy config's compared steps."""
    import csv
    import os

    import numpy as np
    import torch

    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.data.dataset import GraphDataset
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.io.native_checkpoint import load_checkpoint
    from sevennet_tpu_torch.logger import Logger
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.scripts.train import dense_capacity, resolve_statistics, train_run
    from sevennet_tpu_torch.train import LossConfig, Trainer, TrainerConfig
    from sevennet_tpu_torch.train.trainer import tree_map

    spec0 = sevennet0_spec()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        path = os.path.join(tmp, "water.extxyz")
        teacher = params_from_numpy(spec0, random_params(spec0, seed + 1))
        training_set(spec0, teacher, dev, seed, path)
        model_cfg = dict(SEVENNET0, shift="per_atom_energy_mean", scale="force_rms",
                         conv_denominator="avg_num_neigh")
        train_cfg = {"epoch": TRAIN_EPOCHS, "optimizer": "adam", "optim_param": {"lr": TRAIN_LR},
                     "force_loss_weight": 0.1, "stress_loss_weight": 1e-6, "per_epoch": 1,
                     "random_seed": seed}
        data_cfg = {"batch_size": TRAIN_BATCH, "load_trainset_path": [path], "ratio": 0.25}

        # train_run's set-up, to hold its first steps against the plain path:
        # split, statistics, spec, weights from the seed, K, batch order
        trainset, validset = GraphDataset.from_files(path, SEVENNET0["cutoff"]).split(0.25)
        cfg = dict(model_cfg)
        resolve_statistics(cfg, data_cfg, trainset, Logger(None, screen=False))
        spec = build_model_spec(cfg)
        params = params_from_numpy(spec, random_params(spec, seed))
        trainset.build(spec.z_to_type)
        validset.build(spec.z_to_type)
        K = dense_capacity(max(trainset.max_neighbors(), validset.max_neighbors()))
        batches = [b.to(dev) for b in
                   trainset.batches(TRAIN_BATCH, shuffle=True, seed=1, dense_k=K)]
        tcfg = TrainerConfig(loss=LossConfig(force_weight=0.1, stress_weight=1e-6),
                             optimizer="adam", lr=TRAIN_LR)
        kern = Trainer(spec, params, tcfg, device=str(dev))
        plain = Trainer(spec, params, tcfg, device=str(dev), plain=True)
        kern.set_epoch(0)
        n_layers = len(spec.layers)
        log(f"training: {len(trainset)} train / {len(validset)} valid structures of "
            f"{len(trainset.atoms_list[0])} atoms, batch {TRAIN_BATCH}, K={K}, "
            f"batch capacity {batches[0].n_atoms_cap} atoms, "
            f"{int(batches[0].edge_mask.sum())} edges")
        # each step: the plain path's loss and gradients at the kernel path's
        # current weights, then the kernel path's step (same weights, same batch)
        want = dict(dict.fromkeys(counters(), 0), fwd=n_layers, bwd_pg=2 * n_layers,
                    reduce=2 * n_layers)
        compare_steps("vec", kern, plain, batches, want, card)
        reset_launches()
        kern.eval_step(batches[0])
        log(f"  eval step launches: {read_launches()}")

        # step timing on one batch, CUDA events
        b = batches[0]
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_median(lambda: kern.train_step(b), REPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        plain_ms = cuda_median(lambda: plain.train_step(b), 2)
        parts = step_breakdown(spec, kern, b)
        n_struct = int(b.graph_mask.sum())
        kern_ms = parts["b1"] + parts["b2pg"]
        log(f"  train step: median {step_ms:.2f} ms ({REPS} runs, CUDA events), "
            f"{n_struct / step_ms * 1e3:.1f} structures/s, peak {peak:.2f} GiB; plain path "
            f"{plain_ms:.2f} ms (median of 2) | {card}")
        log(f"  step parts: energy + forces with the graph kept {parts['fwd_forces']:.2f} ms, "
            f"the rest (loss backward, optimizer) {step_ms - parts['fwd_forces']:.2f} ms; "
            f"kernels per step B1 {parts['b1']:.3f} ms + B2' {parts['b2pg']:.3f} ms = "
            f"{100 * kern_ms / step_ms:.1f} % of the step; the conv's plain second-order rule "
            f"{parts['second_order']:.2f} ms = "
            f"{100 * parts['second_order'] / step_ms:.1f} % | {card}")
        del kern, plain

        # the legacy config: the same data, B4 and B4' in place of B1 and B2'
        spec_l = build_model_spec(dict(cfg, _normalize_sph=False))
        params_l = params_from_numpy(spec_l, random_params(spec_l, seed))
        kern = Trainer(spec_l, params_l, tcfg, device=str(dev))
        plain = Trainer(spec_l, params_l, tcfg, device=str(dev), plain=True)
        kern.set_epoch(0)
        want = dict(dict.fromkeys(counters(), 0), fwd_embsh=n_layers, bwd_embsh_pg=2 * n_layers,
                    reduce=2 * n_layers)
        legacy = compare_steps("legacy", kern, plain, batches, want, card)
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_median(lambda: kern.train_step(b), REPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        plain_ms = cuda_median(lambda: plain.train_step(b), 2)
        log(f"  legacy train step: median {step_ms:.2f} ms ({REPS} runs, CUDA events), "
            f"{n_struct / step_ms * 1e3:.1f} structures/s, peak {peak:.2f} GiB; plain path "
            f"{plain_ms:.2f} ms (median of 2) | {card}")
        del kern, plain, batches
        torch.cuda.empty_cache()

        # the main path: train_run, counts from 0
        wd = os.path.join(tmp, "run")
        reset_launches()
        trainer = train_run(dict(model_cfg), dict(train_cfg), dict(data_cfg), working_dir=wd,
                            device=str(dev))
        counts = read_launches()
        n_train = TRAIN_EPOCHS * -(-len(trainset) // TRAIN_BATCH)
        n_eval = TRAIN_EPOCHS * -(-len(validset) // TRAIN_BATCH)
        want = dict(dict.fromkeys(counters(), 0), fwd=n_layers * (n_train + n_eval),
                    bwd=n_layers * n_eval, bwd_pg=2 * n_layers * n_train,
                    reduce=2 * n_layers * n_train)
        log(f"train_run: {n_train} train steps, {n_eval} eval steps, launches {counts}")
        if counts != want:
            raise SystemExit(f"train_run launches {counts}, expected {want}")
        with open(os.path.join(wd, "lc.csv")) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != TRAIN_EPOCHS:
            raise SystemExit(f"lc.csv has {len(rows)} rows, expected {TRAIN_EPOCHS}")
        for r in rows:
            vals = {k: float(v) for k, v in r.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                raise SystemExit(f"non-finite losses in lc.csv: {r}")
            log(f"  epoch {int(vals['epoch'])}: train loss {vals['train_loss_total']:.6e} "
                f"(E {vals['train_loss_energy']:.4e}, F {vals['train_loss_force']:.4e}, "
                f"S {vals['train_loss_stress']:.4e}), "
                f"valid loss {vals['valid_loss_total']:.6e} | {card}")
        spec_ck, params_ck, meta = load_checkpoint(os.path.join(wd, "checkpoint_last"))
        pos, Z, cell = water_box(64, seed=seed * 1000 + 999)
        at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
        e_loaded = SevenNetCalculator(spec_ck, params_ck, device=str(dev)).calculate(at)["energy"]
        e_trained = SevenNetCalculator(trainer.spec, tree_map(lambda p: p.detach(), trainer.params),
                                       device=str(dev)).calculate(at)["energy"]
        log(f"  checkpoint_last (epoch {meta['epoch']}) reloads: E {e_loaded:.8f} vs trained "
            f"{e_trained:.8f} eV")
        # not bit for bit: the per-graph energy sum (index_add_ on CUDA) adds in
        # no fixed order
        if spec_ck != trainer.spec or abs(e_loaded - e_trained) > 1e-6 * abs(e_trained):
            raise SystemExit("the reloaded checkpoint gives other energies")
        return counts, legacy


def unsorted(state, n, name):
    """Rows of ``state.<name>`` in the input order (``atom_index``), numpy."""
    import numpy as np

    a = getattr(state, name).cpu().numpy()
    idx = state.atom_index.cpu().numpy()
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    real = idx < n
    out[idx[real]] = a[real]
    return out


def slots_match_host(eng, st):
    """The slots of the engine's last device rebuild against a host build at
    the same positions: per row the same ``(src, shift)`` set, and every
    mirror pointing back (``src[mir[e]]`` is the row of ``e``, the shift
    negated, ``mir[mir[e]] == e``). Returns the number of edges."""
    import numpy as np

    n_cap, K = st.n_atoms_cap, eng.k_model
    host = eng._host_initial_edges(st.nl_positions[: int(st.atom_mask.sum())].cpu().numpy(),
                                   n_cap)
    if host is None:
        raise SystemExit("the host build at the rebuilt positions failed its capacity checks")
    rows = np.repeat(np.arange(n_cap), K)
    src, shift = st.edge_src.cpu().numpy(), st.edge_shift.cpu().numpy()
    mask, mir = st.edge_mask.cpu().numpy(), st.edge_mir.cpu().numpy()

    def edge_set(s_, sh_, m_):
        return set(zip(rows[m_].tolist(), s_[m_].tolist(),
                       *[np.rint(sh_[m_, i]).astype(int).tolist() for i in range(3)]))

    if edge_set(src, shift, mask) != edge_set(host["src"], host["shift"], host["mask"]):
        raise SystemExit("the device rebuild's slots differ from a host build")
    e = np.flatnonzero(mask)
    if not ((src[mir[e]] == rows[e]).all() and (shift[mir[e]] == -shift[e]).all()
            and (mir[mir[e]] == e).all()):
        raise SystemExit("the device rebuild's mirror map does not pair the edges")
    return len(e)


def record_evaluations(eng):
    """Wraps the engine's force evaluation to record, per evaluation, the
    ring's chunk count (0: no ring); returns the list it fills."""
    seen = []
    forces = eng._forces

    def counted(state, compute_stress=False):
        seen.append(eng._ring_nb)
        return forces(state, compute_stress)

    eng._forces = counted
    return seen


def md_compare_phase(spec, params, dev, seed: int, card: str):
    """NVE MD of a 3,000-atom water box: the kernel engine against an engine
    on the plain conv, from the same state, for MD_CMP_STEPS steps of MD_DT;
    positions within MD_POS_TOL, potential energy within ENERGY_REL_TOL
    relative at every step, 5 B1 + 5 B2 launches per force evaluation, at
    least one device rebuild (skin MD_CMP_SKIN), whose slots equal a host
    build. Returns the kernel engine's launches."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.md import MDEngine

    pos, Z, cell = water_box(1000)
    n = len(pos)
    engines = {k: MDEngine(spec, params, cell, skin=MD_CMP_SKIN, device=str(dev),
                           plain=(k == "plain")) for k in ("kernel", "plain")}
    out = {}
    for k, eng in engines.items():
        st = eng.make_state(pos, Z, temperature=MD_T, seed=seed)
        evals = record_evaluations(eng)
        reset_launches()
        t0 = time.perf_counter()
        st, (pe, ke) = eng.run(st, MD_CMP_STEPS, dt=MD_DT, chunk=MD_CMP_STEPS)
        torch.cuda.synchronize()
        out[k] = (st, pe.cpu().numpy(), ke.cpu().numpy(), read_launches(),
                  (time.perf_counter() - t0) / MD_CMP_STEPS * 1e3, len(evals))
    (st_k, pe_k, ke_k, counts, ms_k, n_evals), (st_p, pe_p, _, counts_p, ms_p, _) = (
        out["kernel"], out["plain"])
    dx = float(np.abs(unsorted(st_k, n, "positions") - unsorted(st_p, n, "positions")).max())
    de = float(np.abs(pe_k - pe_p).max() / np.abs(pe_p).max())
    want = dict(dict.fromkeys(counts, 0), fwd=5 * n_evals, bwd=5 * n_evals)
    rebuilds = engines["kernel"].n_rebuilds
    log(f"MD 3,000 atoms, {MD_CMP_STEPS} NVE steps of {MD_DT} fs, kernel vs plain conv: "
        f"max|dx|={dx:.3e} A (tol {MD_POS_TOL:g}), max rel dPE={de:.3e} (tol "
        f"{ENERGY_REL_TOL:g}), PE {pe_k[0]:.6f} -> {pe_k[-1]:.6f} eV, KE {ke_k[-1]:.4f} eV, "
        f"device rebuilds {rebuilds}, growths {engines['kernel'].n_growths}, K="
        f"{engines['kernel'].k_model}; {ms_k:.1f} ms/step kernel, {ms_p:.1f} plain (host "
        f"clock); {n_evals} force evaluations, launches {counts} | {card}")
    checks = ((dx <= MD_POS_TOL, f"max|dx| {dx}"), (de <= ENERGY_REL_TOL, f"rel dPE {de}"),
              (counts == want, f"launches {counts}, expected {want}"),
              (not any(counts_p.values()), f"plain engine launched {counts_p}"),
              (rebuilds > 0, "no device rebuild happened"),
              (bool(np.isfinite(pe_k).all()), "non-finite energies"))
    for ok, why in checks:
        if not ok:
            raise SystemExit(f"MD at 3,000 atoms: {why}")
    n_edges = slots_match_host(engines["kernel"], st_k)
    log(f"  the last device rebuild's {n_edges} edges equal a host build at its positions, "
        f"mirrors paired")
    return counts


def md_timed_phase(spec, params, dev, seed: int, card: str):
    """NVE MD of a 9,999-atom water box, unchunked: a warm-up chunk, then
    MD_TIMED_STEPS timed steps in chunks of MD_CHUNK (host clock around
    synchronized work): ms per step, atom-steps/s, peak memory, capacity
    growths (a growth retries its chunk, and its steps count in the time);
    exactly 5 B1 + 5 B2 per force evaluation. Returns the launches of the
    timed steps."""
    import numpy as np
    import torch

    from sevennet_tpu_torch.md import MDEngine

    pos, Z, cell = water_box(3333)
    n = len(pos)
    eng = MDEngine(spec, params, cell, device=str(dev))
    t0 = time.perf_counter()
    st = eng.make_state(pos, Z, temperature=MD_T, seed=seed)
    t_setup = time.perf_counter() - t0
    k0 = eng.k_model
    st, _ = eng.run(st, MD_WARMUP_STEPS, dt=MD_DT, chunk=MD_CHUNK)
    rebuilds, growths = eng.n_rebuilds, eng.n_growths
    evals = record_evaluations(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    st, (pe, ke) = eng.run(st, MD_TIMED_STEPS, dt=MD_DT, chunk=MD_CHUNK)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = dict(dict.fromkeys(counts, 0), fwd=5 * len(evals), bwd=5 * len(evals))
    etot = (pe + ke).cpu().numpy()
    log(f"MD 9,999 atoms (unchunked, K {k0} at make_state, {eng.k_model} timed; growths "
        f"{growths} in the {MD_WARMUP_STEPS} warm-up steps): make_state {t_setup:.1f} s; "
        f"{MD_TIMED_STEPS} timed NVE steps: {dt_s / MD_TIMED_STEPS * 1e3:.2f} ms/step, "
        f"{n * MD_TIMED_STEPS / dt_s:.4e} atom-steps/s (host clock), peak {peak:.2f} GiB, "
        f"device rebuilds {eng.n_rebuilds - rebuilds}, growths {eng.n_growths - growths}, "
        f"{len(evals)} force evaluations, E_tot drift {float(np.abs(etot - etot[0]).max()):.3e} "
        f"eV; launches {counts} | {card}")
    if counts != want:
        raise SystemExit(f"MD at 9,999 atoms: launches {counts}, expected {want}")
    if not np.isfinite(etot).all():
        raise SystemExit("MD at 9,999 atoms: non-finite energies")
    return counts


def md_ring_phase(params, dev, seed: int, card: str):
    """NVE MD of a 99,999-atom water box with full SevenNet-0 and the ring
    backward engaged in every layer (SEVENNET_TPU_CHUNK_THRESHOLD=1e9 and
    an edge chunk of 163,840 slots, as bench.py:139-141 and :349-358 run
    it; MD_RING_THRESHOLD, MD_RING_EDGE_CHUNK), against an unchunked engine (``_edge_chunk: 0``) at the same
    positions: initial forces within FORCE_TOL and FORCE_REL_TOL of max
    |F|, energy within ENERGY_REL_TOL; the peak memory of one step of each;
    then MD_RING_WARMUP + MD_RING_STEPS timed ring steps with 5 B1 + 5 nb B3
    launches per force evaluation and no B2 (nb as it stands at each
    evaluation: a capacity growth may re-size the ring). Before the
    reference engine, :func:`b3_check` at the ring's shape. Returns the
    launches of the timed steps and B3's kernels-line record."""
    import os

    import numpy as np
    import torch

    from sevennet_tpu_torch.md import MDEngine
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.ops.fused_conv import CHUNK_THRESHOLD_BYTES

    os.environ["SEVENNET_TPU_CHUNK_THRESHOLD"] = str(MD_RING_THRESHOLD)
    try:
        pos, Z, cell = water_box(33333)
        n = len(pos)
        ring = MDEngine(build_model_spec(dict(SEVENNET0, _edge_chunk=MD_RING_EDGE_CHUNK)),
                        params, cell, device=str(dev))
        dim_x = max(layer.conv.irreps_x.dim for layer in ring.spec.layers)
        t0 = time.perf_counter()
        reset_launches()
        st_r = ring.make_state(pos, Z, temperature=MD_T, seed=seed)
        torch.cuda.synchronize()
        t_ring = time.perf_counter() - t0
        counts = read_launches()
        RC, nb, W = ring.row_chunk, ring._ring_nb, ring._ring_w
        log(f"MD 99,999 atoms, ring: RC={RC} rows, nb={nb} chunks, W={W} (buffer of {4 * W + 1} "
            f"slots, {(4 * W + 1) * RC * ring.k_model * dim_x * 4 / 2**30:.2f} GiB at dim_x "
            f"{dim_x}), "
            f"K={ring.k_model}, atom capacity {st_r.n_atoms_cap}, host window "
            f"{ring._ring_window} rows; make_state {t_ring:.1f} s, launches {counts}")
        want = dict(dict.fromkeys(counts, 0), fwd=5, bwd_slot=5 * nb)
        if not nb or ring.spec.conv_ring != W or counts != want:
            raise SystemExit(f"the ring is not engaged at 99,999 atoms: nb={nb}, launches "
                             f"{counts}, expected {want}")
        b3 = b3_check(ring, st_r, dev, card)
        ref = MDEngine(build_model_spec(dict(SEVENNET0, _edge_chunk=0)), params, cell,
                       device=str(dev))
        t0 = time.perf_counter()
        st_u = ref.make_state(pos, Z, temperature=MD_T, seed=seed)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        f_r, f_u = unsorted(st_r, n, "forces"), unsorted(st_u, n, "forces")
        df, fmax = float(np.abs(f_r - f_u).max()), float(np.abs(f_u).max())
        e_r, e_u = float(st_r.potential_energy), float(st_u.potential_energy)
        de = abs(e_r - e_u) / abs(e_u)
        log(f"  ring vs unchunked forces at the same positions: max|dF|={df:.3e} eV/A "
            f"(max|F|={fmax:.3e}), E {e_r:.6f} vs {e_u:.6f} eV, rel dE={de:.3e}; unchunked "
            f"make_state {t_ref:.1f} s")
        for ok, why in ((df <= FORCE_TOL, f"max|dF| {df} > {FORCE_TOL}"),
                        (df <= FORCE_REL_TOL * fmax, f"max|dF| {df} > {FORCE_REL_TOL} * {fmax}"),
                        (de <= ENERGY_REL_TOL, f"rel dE {de}")):
            if not ok:
                raise SystemExit(f"MD at 99,999 atoms, ring vs unchunked: {why}")

        def one_step(eng, st):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            st, _ = eng.run(st, 1, dt=MD_DT, chunk=1)
            torch.cuda.synchronize()
            return st, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 2**30

        _, ms_u, peak_u = one_step(ref, st_u)
        gathered = st_u.n_atoms_cap * ref.k_model * dim_x * 4
        log(f"  unchunked step: {ms_u:.1f} ms (host clock, one step), peak {peak_u:.2f} GiB; "
            f"gathered edge tensor at dim_x {dim_x}: {gathered / 1e9:.2f} GB; peak / gathered = "
            f"{peak_u * 2**30 / gathered:.3f}, so a 60 GiB peak at "
            f"{60 * 2**30 / (peak_u * 2**30 / gathered) / 1e9:.1f} GB gathered (default "
            f"chunk_threshold {CHUNK_THRESHOLD_BYTES / 1e9:.1f} GB) | {card}")
        del ref, st_u
        torch.cuda.empty_cache()
        st_r, ms_r1, peak_r = one_step(ring, st_r)
        log(f"  ring step: {ms_r1:.1f} ms (host clock, one step), peak {peak_r:.2f} GiB | {card}")
        st_r, _ = ring.run(st_r, MD_RING_WARMUP, dt=MD_DT, chunk=MD_CHUNK)
        rebuilds, growths = ring.n_rebuilds, ring.n_growths
        evals = record_evaluations(ring)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        st_r, (pe, ke) = ring.run(st_r, MD_RING_STEPS, dt=MD_DT, chunk=MD_CHUNK)
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        counts = read_launches()
        want = dict(dict.fromkeys(counts, 0), fwd=5 * len(evals), bwd_slot=5 * sum(evals))
        etot = (pe + ke).cpu().numpy()
        log(f"  {MD_RING_STEPS} timed ring steps: {dt_s / MD_RING_STEPS * 1e3:.1f} ms/step, "
            f"{n * MD_RING_STEPS / dt_s:.4e} atom-steps/s (host clock), device rebuilds "
            f"{ring.n_rebuilds - rebuilds}, growths {ring.n_growths - growths} (before: "
            f"{growths}), {len(evals)} force evaluations, ring chunks now {ring._ring_nb} "
            f"(W {ring._ring_w}, K {ring.k_model}), E_tot drift "
            f"{float(np.abs(etot - etot[0]).max()):.3e} eV; launches {counts} | {card}")
        if not all(evals) or counts != want:
            raise SystemExit(f"MD at 99,999 atoms: launches {counts}, expected {want}")
        if not np.isfinite(etot).all():
            raise SystemExit("MD at 99,999 atoms: non-finite energies")
        return counts, b3
    finally:
        del os.environ["SEVENNET_TPU_CHUNK_THRESHOLD"]


FWD_CU = "sevennet_tpu_torch/csrc/fused_conv_fwd.cu"
BWD_CU = "sevennet_tpu_torch/csrc/fused_conv_bwd.cu"
# kernels line entry -> (name, source, TPU kernel replaced, record and launch key)
KERNEL_NAMES = {
    "fwd": ("fused_conv_fwd", FWD_CU, "sevennet_tpu/ops/fused_conv.py:678", "fwd"),
    "bwd": ("fused_conv_bwd", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1222", "bwd"),
    "bwd_slot": ("fused_conv_bwd_slot", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1208",
                 "bwd_slot"),
    "bwd_pg": ("fused_conv_bwd_pg", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1222", "bwd_pg"),
    "reduce": ("param_grad_reduce", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1064", "reduce"),
    "fwd_embsh": ("fused_conv_fwd_embsh", FWD_CU, "sevennet_tpu/ops/fused_conv.py:678",
                  "fwd_embsh"),
    "bwd_embsh": ("fused_conv_bwd_embsh", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1222",
                  "bwd_embsh"),
    "bwd_embsh_pg": ("fused_conv_bwd_embsh_pg", BWD_CU, "sevennet_tpu/ops/fused_conv.py:1222",
                     "bwd_embsh_pg"),
    # B5 (make_fused_conv_bwd) computes B4 bwd's function: the same kernel serves it
    "b5": ("fused_conv_bwd_embsh (serves B5)", BWD_CU, "sevennet_tpu/ops/fused_conv.py:875",
           "bwd_embsh"),
    # B6 (dense_conv_pallas) computes B4 fwd's function: the same kernel serves it
    "b6": ("fused_conv_fwd_embsh (serves B6 through dense_conv_pallas)", FWD_CU,
           "sevennet_tpu/ops/pallas_conv.py:194", "b6"),
}


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
        from sevennet_tpu_torch.model.build import build_model_spec
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
    for row in ptxas_table(libs):
        log("  ptxas {instance}: {registers} registers, {stack} B stack, {spill_stores} B spill "
            "stores, {spill_loads} B spill loads".format(**row))

    spec = sevennet0_spec()
    params = params_from_numpy(spec, random_params(spec, args.seed))
    spec_legacy = build_model_spec(dict(SEVENNET0, _normalize_sph=False))
    t0 = time.perf_counter()
    pos, Z, cell = water_box(1000)
    atoms = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
    records, (N, K, n_edges) = kernel_phase(spec, params, dev, atoms)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    b6 = b6_path(spec_legacy, params, dev, atoms)
    log(f"B6 path (dense_conv_pallas over 5 layers): launches {b6}")
    t0 = time.perf_counter()
    served = request_phase(spec, params, dev, "vec", "fwd", "bwd")
    log(f"request phase (main path: serving): launches {served}, "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    served_legacy = request_phase(spec_legacy, params, dev, "legacy", "fwd_embsh", "bwd_embsh",
                                  graph_times=False)
    log(f"legacy request phase (main path: serving a pre-0.10 config): launches "
        f"{served_legacy}, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained, trained_legacy = training_phase(dev, args.seed, card)
    log(f"training phase (main path: training; legacy steps): launches {trained}, "
        f"{trained_legacy}, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    md_small = md_compare_phase(spec, params, dev, args.seed, card)
    log(f"MD phase, 3,000 atoms (main path: MD, against the plain conv): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    md_mid = md_timed_phase(spec, params, dev, args.seed, card)
    log(f"MD phase, 9,999 atoms (main path: MD, unchunked): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    md_ring, records["bwd_slot"] = md_ring_phase(params, dev, args.seed, card)
    log(f"MD phase, 99,999 atoms (main path: MD, ring backward): "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {k: b6[k] + served[k] + served_legacy[k] + trained[k] + trained_legacy[k]
                + md_small[k] + md_mid[k] + md_ring[k] for k in counters()}
    if not all(launches[key] for *_, key in KERNEL_NAMES.values()):
        raise SystemExit(f"a kernel was never launched on the main paths: {launches}")

    kernels_line = []
    for name, source, replaces, key in KERNEL_NAMES.values():
        r = records[key]
        bnd, by = bound_ms(r["flops"], r["bytes"], r["tc_flops"])
        log(f"  bounds {name}: {bnd:.4f} ms ({r['tc_flops'] / max(r['flops'], 1):.1%} of the "
            f"operations as 3xTF32; fp32 {bound_ms(r['flops'], r['bytes'])[0]:.4f} ms), kernel "
            f"{r['ms']:.4f} ms | {card}")
        kernels_line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bnd, "bound_by": by, "library_ms": None,
        })
    log(f"kernel times are per pass of {N} atoms (K={K}, {n_edges} edges): "
        "layer 0 + 3 x layers 1-3 + layer 4 (fused_conv_bwd_slot: per force evaluation "
        "of the 99,999-atom ring, over its nb chunks); fused_conv_bwd_pg and fused_conv_bwd_embsh_pg include their "
        "param_grad_reduce; launches: the B6 path, serving (both configs), train_run, the "
        "legacy config's compared train steps, and MD (3,000 and 9,999 atoms, and the timed "
        "ring steps at 99,999)")
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
