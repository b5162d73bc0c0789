#!/usr/bin/env python3
"""Section breakdown of the fused-conv kernels on one NVIDIA GPU.

    python3 conv_breakdown.py [--seed S]

Builds the profile libraries of ``sevennet_tpu_torch/csrc`` (``-DFUSED_CONV_
PROFILE``: thread 0 of each CTA adds the ``clock64()`` cycles between
barriers to a section, ``csrc/fused_conv_common.cuh:Prof``) beside the
normal ones, and runs both on SevenNet-0's layer-1 shape (random weights
from ``--seed``):

- on the ~3,000-atom water box of ``chip_smoke.py`` (K from its neighbour
  list): B1 and B2 in vec mode, B4 fwd and B4 bwd in emb/sh mode on the
  legacy model's embedding and spherical harmonics;
- on the first ring chunk of the 99,999-atom box (RC 2,632 rows padded to
  K 63, as the MD engine's ring runs B3): B2.

For each kernel it prints the share of the CTAs' cycles in each section
and that share of the kernel's time (CUDA events on the normal build), and
the profile build's own time. Sections: 0 set-up and output, 1 (a)
geometry, Bessel embedding and spherical harmonics (emb/sh: reading their
rows), 2 (b) the ``x[src]`` gather, ``tmp`` and MLP layer 1, 10 (e) MLP
layer 2, 3 (f) the ``W3`` forward product, 4 the uvu product (forward), 8
``dtmp`` and 9 ``dxg`` and ``dw`` (backward), 5 the ``dz2`` product, 6
``dz1``/``dsh``/``demb``, 7 the chain to ``dvec`` (emb/sh: writing
``demb``/``dsh``). The profile build adds a barrier at each section's
end. The last line is one
JSON object with every number, also written to
``chiprun_out/conv_breakdown.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import sys

from chip_smoke import cuda_time, gpu_line, log, sevennet0_spec, water_box

SECTIONS = ("set-up/output", "(a) geometry, emb, sh", "(b) gather, tmp, MLP 1",
            "(f) W3 forward product", "uvu product (forward)", "dz2 product",
            "dz1, dsh, demb", "chain to dvec / demb, dsh out", "dtmp", "dxg, dw",
            "(e) MLP 2")
NSEC = len(SECTIONS)
RING_RC, RING_K = 2632, 63  # the 99,999-atom ring's chunk (PERF.md, MD)


def profile_call(lib_name, entry, args, grid, dev):
    """Runs C entry ``entry`` of the profile build of ``lib_name`` with
    ``args`` twice (the first a warm-up) and returns the section cycles
    summed over the ``grid`` CTAs of the second run."""
    import torch

    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops import kernels

    lib = kernels.library(lib_name, profile=True)
    fc.check_uvu_layout(lib)
    buf = torch.zeros((grid, NSEC), dtype=torch.int64, device=dev)
    lib.fused_conv_prof_set.argtypes = [ctypes.c_void_p]
    lib.fused_conv_prof_set.restype = ctypes.c_int
    if lib.fused_conv_prof_set(ctypes.c_void_p(buf.data_ptr())) != 0:
        raise RuntimeError("fused_conv_prof_set failed")
    fn = getattr(lib, entry)
    fn.argtypes = [type(a) for a in args]
    fn.restype = ctypes.c_int
    for _ in range(2):
        buf.zero_()
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{entry} (profile build): CUDA launch failed with error {rc}")
    torch.cuda.synchronize()
    return buf.sum(0).tolist()


def breakdown(name, op, x, src, a, b, ws, ybar, wrapper, plain, dev, card):
    """Prints and returns the breakdown of one kernel: its error against
    the plain version (max abs error over max |plain|, each output), its
    time through the wrapper (normal build), the profile build's time and
    cycles per section."""
    import torch

    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops import kernels

    lib, entry, args, _ = (fc.fwd_launch_args(op, x, src, a, b, ws) if ybar is None else
                           fc.bwd_launch_args(op, x, src, a, b, ws, ybar, records=False))
    N = src.shape[0]
    got, want = wrapper(), plain()
    got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    rel = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
              for g, w in zip(got, want))
    del got, want
    ms = cuda_time(wrapper, 10)
    cycles = profile_call(lib, entry, args, N, dev)
    fn = getattr(kernels.library(lib, profile=True), entry)
    prof_ms = cuda_time(lambda: fn(*args), 5)
    total = sum(cycles)
    rows = []
    log(f"{name}: kernel {ms:.4f} ms (profile build {prof_ms:.4f} ms), error vs plain "
        f"{rel:.3e} of max |plain| | {card}")
    for s, (label, c) in enumerate(zip(SECTIONS, cycles)):
        if c == 0:
            continue
        share = c / total
        rows.append(dict(section=s, label=label, cycles=c, share=share, ms=share * ms))
        log(f"  {s} {label:32s} {100 * share:6.2f} %  {share * ms:8.4f} ms")
    torch.cuda.synchronize()
    return dict(name=name, ms=ms, profile_ms=prof_ms, rel_err=rel, sections=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("conv_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.model.model import edge_emb_sh, edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} | {card}")
    kernels.build()
    kernels.build(profile=True)
    spec = sevennet0_spec()
    params = params_from_numpy(spec, random_params(spec, args.seed))
    legacy = dataclasses.replace(spec, normalize_sph=False)
    layer = spec.layers[1]
    op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
    op_e = fc.conv_op(layer.conv, layer.radial_mlp)
    calc = SevenNetCalculator(spec, params, device=str(dev))
    ws = calc.params["1_convolution"]["weight_nn"]["w"]
    coef = calc.params["edge_embedding"]["bessel_coeffs"]
    gen = torch.Generator(device="cpu").manual_seed(1)
    results = []

    def graph_inputs(n_molecules, rows, k_pad):
        pos, Z, cell = water_box(n_molecules)
        g = calc.graph(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
        N, K = g.n_atoms_cap, g.dense_k
        sentinel = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], device=dev)
        vec = torch.where(g.edge_mask[None], g.edge_vectors().T, sentinel[:, None])
        src = g.edge_src.view(N, K).to(torch.int32)
        rows = N if rows is None else rows
        k = max(K, k_pad)
        vec = vec.view(3, N, K)[:, :rows]
        src = src[:rows]
        mask = g.edge_mask.view(N, K)[:rows]
        if k > K:  # pad with sentinel slots, as the MD engine's capacity does
            vec = torch.cat([vec, sentinel[:, None, None].expand(3, rows, k - K)], 2)
            src = torch.cat([src, torch.zeros(rows, k - K, dtype=src.dtype, device=dev)], 1)
            mask = torch.cat([mask, torch.zeros(rows, k - K, dtype=mask.dtype, device=dev)], 1)
        return (N, src.contiguous(), vec.reshape(3, rows * k).contiguous(),
                mask.reshape(-1), int(mask.sum()))

    n_all, src, vec, mask, n_edges = graph_inputs(1000, None, 0)
    N, K = src.shape
    log(f"3,000-atom box: N={N} K={K} edges={n_edges}")
    x = torch.randn(n_all, op.dim_x, generator=gen).to(dev)
    ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
    emb, sh = (t.contiguous() for t in edge_emb_sh(legacy, coef, vec, mask))
    a = (op, x, src, vec, coef, ws)
    e = (op_e, x, src, emb, sh, ws)
    results.append(breakdown("B1 fwd, layer 1", *a, None, lambda: fc.fused_conv_fwd(*a),
                             lambda: fc.fused_conv_fwd_plain(*a), dev, card))
    results.append(breakdown("B2 bwd, layer 1", *a, ybar, lambda: fc.fused_conv_bwd(*a, ybar),
                             lambda: fc.fused_conv_bwd_plain(*a, ybar), dev, card))
    results.append(breakdown("B4 fwd, layer 1", *e, None, lambda: fc.fused_conv_fwd_embsh(*e),
                             lambda: fc.fused_conv_fwd_embsh_plain(*e), dev, card))
    results.append(breakdown("B4 bwd, layer 1", *e, ybar,
                             lambda: fc.fused_conv_bwd_embsh(*e, ybar),
                             lambda: fc.fused_conv_bwd_embsh_plain(*e, ybar), dev, card))
    del a, e, emb, sh
    n_all, src, vec, mask, n_edges = graph_inputs(33333, RING_RC, RING_K)
    log(f"ring chunk of the 99,999-atom box: rows {src.shape[0]} K={src.shape[1]} "
        f"edges={n_edges} (x over {n_all} atoms)")
    x = torch.randn(n_all, op.dim_x, generator=gen).to(dev)
    ybar = torch.randn(src.shape[0], op.dim_mid, generator=gen).to(dev)
    a = (op, x, src, vec, coef, ws)
    results.append(breakdown("B2 (B3's kernel) on the ring chunk, layer 1", *a, ybar,
                             lambda: fc.fused_conv_bwd(*a, ybar),
                             lambda: fc.fused_conv_bwd_plain(*a, ybar), dev, card))
    out = {"card": card, "breakdown": results}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "conv_breakdown.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
