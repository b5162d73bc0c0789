#!/usr/bin/env python3
"""Section breakdown of the fused-conv kernels on one NVIDIA GPU.

    python3 conv_breakdown.py [--seed S] [--only mf | --splits] [--tree DIR]

Builds the profile libraries of the fused conv in ``sevennet_tpu_torch/csrc``
(``-DFUSED_CONV_PROFILE``: thread 0 of each CTA adds the ``clock64()``
cycles between barriers to a section, ``csrc/fused_conv_common.cuh:Prof``)
beside the normal ones, and runs both (random weights from ``--seed``):

- at SevenNet-0's layer-1 shape on the ~3,000-atom water box of
  ``chip_smoke.py`` (K from its neighbour list): B1 and B2 in vec mode, B4
  fwd and B4 bwd in emb/sh mode on the legacy model's embedding and
  spherical harmonics; and on the first ring chunk of the 99,999-atom box
  (RC 2,632 rows padded to K 63, as the MD engine's ring runs B3): B2;
- at SevenNet-MF-ompa's layers 2 and 3 (conv denominator 81, as
  ``chip_smoke.py`` builds it) on the same 3,000-atom box: B1 and B2, with
  the layer's plan (passes or cluster ranks, column blocks) and the bytes of
  ``dxg`` that B2's accumulating tasks read back from device memory in one
  launch (``dxg_readback_bytes``); a cluster's sections are also given per
  rank. The plain versions are not run there (15,552 floats a message).

``--only mf`` runs the mf-ompa part alone. ``--splits`` times B1, B2 and
B2′ at mf-ompa's layers 2 and 3 (3,000 atoms, normal build, in turns)
under the planner's split of the x irreps over the cluster's ranks
(``ops/fused_conv.py:_rank_cost``) and under the split of the most even W3
columns alone (``TERM_COST`` and ``LEAD_COST`` 0), and prints nothing
else. ``--tree DIR`` profiles the
package and ``chip_smoke.py`` of another checkout (``ab_compare.py``'s
parent), the output still under ``./chiprun_out``.

For each kernel it prints the share of the CTAs' cycles in each section
and that share of the kernel's time (CUDA events on the normal build), and
the profile build's own time. Sections: 0 set-up and output, 1 (a)
geometry, Bessel embedding and spherical harmonics (emb/sh: reading their
rows), 2 (b) the ``x[src]`` gather, ``tmp`` and MLP layer 1, 10 (e) MLP
layer 2, 3 (f) the ``W3`` forward product, 4 the uvu product (forward), 8
``dtmp`` and 9 ``dxg`` and ``dw`` (backward), 5 the ``dz2`` product, 6
``dz1``/``dsh``/``demb``, 7 the chain to ``dvec`` (emb/sh: writing
``demb``/``dsh``), 11 (a cluster's backward) the ranks' sums and the waits
at the cluster barriers. The profile build adds a barrier at each
section's end; the number of sections is read from the profiled tree's
``csrc``. The last line is one
JSON object with every number, also written to
``chiprun_out/conv_breakdown.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import itertools
import json
import os
import re
import sys

SECTIONS = ("set-up/output", "(a) geometry, emb, sh", "(b) gather, tmp, MLP 1",
            "(f) W3 forward product", "uvu product (forward)", "dz2 product",
            "dz1, dsh, demb", "chain to dvec / demb, dsh out", "dtmp", "dxg, dw",
            "(e) MLP 2", "cluster sums, barrier waits")
RING_RC, RING_K = 2632, 63  # the 99,999-atom ring's chunk (PERF.md, MD)
MF_LAYERS = (2, 3)          # mf-ompa's widest layers
MF_ATOMS = 3000


def n_sections() -> int:
    """NSEC of the profiled package's csrc (the profile buffer's row)."""
    from sevennet_tpu_torch.ops import kernels

    src = (kernels.CSRC_DIR / "fused_conv_common.cuh").read_text()
    return int(re.search(r"#define NSEC (\d+)", src).group(1))


def plan_summary(op) -> dict:
    """The layer's plan as the profiled package has it: a cluster's ranks
    (x irreps, instructions, blocks) or the passes of the one-CTA form."""
    plan = op.plan
    out = dict(blocks=len(plan.blocks), widths=list(plan.widths))
    if hasattr(plan, "ranks"):
        starts = [0, *itertools.accumulate(plan.rank_blocks)]
        out.update(cluster=plan.cluster, rank_blocks=list(plan.rank_blocks),
                   rank_x_columns=[r.xw for r in plan.ranks],
                   rank_w_columns=[sum(plan.widths[a:b]) for a, b in zip(starts, starts[1:])])
    else:
        out.update(cluster=1, passes=len(plan.passes), pass_blocks=list(plan.pass_blocks))
    return out


def dxg_readback_bytes(op, n_edges: int) -> int:
    """Bytes of ``dxg`` that B2's accumulating tasks read back from device
    memory in one launch over ``n_edges`` edges inside the cutoff: every
    ``dxg`` task of a column block after the first, or of a later pass,
    reads the edge's ``d1`` x (up to 8) channels it adds to. A cluster's
    ranks add in shared memory and read nothing back."""
    from sevennet_tpu_torch.ops import fused_conv as fc

    if getattr(op.plan, "cluster", 1) > 1:
        return 0
    it = op.itab.astype("int64")
    starts = [0]
    while it[starts[-1] + fc.H_NEXT]:
        starts.append(int(it[starts[-1] + fc.H_NEXT]))
    per_edge = 0
    for p, po in enumerate(starts):
        tab = it[po:]
        off_dx, off_blk, n_blk = int(tab[4]), int(tab[8]), int(tab[9])
        for b in range(n_blk):
            if p == 0 and b == 0:
                continue
            r = int(tab[off_blk + b * fc.UVU_BLK + 5])
            for task in range(int(tab[r]), int(tab[r + fc.UVU_WARPS])):
                _, d1, mul, _, _, u0 = tab[off_dx + 8 * task: off_dx + 8 * task + 6]
                per_edge += int(d1) * min(8, int(mul) - int(u0)) * 4
    return per_edge * n_edges


def profile_call(lib_name, entry, args, grid, dev):
    """Runs C entry ``entry`` of the profile build of ``lib_name`` with
    ``args`` twice (the first a warm-up) and returns the section cycles
    summed over the ``grid`` CTAs of the second run."""
    import torch

    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops import kernels

    lib = kernels.library(lib_name, profile=True)
    fc.check_uvu_layout(lib)
    buf = torch.zeros((grid, n_sections()), dtype=torch.int64, device=dev)
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
    return buf


def breakdown(name, op, x, src, a, b, ws, ybar, wrapper, plain, dev, card):
    """Prints and returns the breakdown of one kernel: its error against
    the plain version (max abs error over max |plain|, each output; None
    without ``plain``), its time through the wrapper (normal build), the
    profile build's time and cycles per section, for a cluster also per
    rank (CTA ``i * cluster + rank``)."""
    import torch

    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops import kernels

    lib, entry, args, _ = (fc.fwd_launch_args(op, x, src, a, b, ws) if ybar is None else
                           fc.bwd_launch_args(op, x, src, a, b, ws, ybar, records=False))
    from chip_smoke import cuda_time, log

    N = src.shape[0]
    cl = getattr(op.plan, "cluster", 1)
    rel = None
    if plain is not None:
        got, want = wrapper(), plain()
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        rel = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                  for g, w in zip(got, want))
        del got, want
    ms = cuda_time(wrapper, 10)
    buf = profile_call(lib, entry, args, N * cl, dev)
    per_rank = buf.view(N, cl, -1).sum(0).tolist()
    cycles = buf.sum(0).tolist()
    fn = getattr(kernels.library(lib, profile=True), entry)
    prof_ms = cuda_time(lambda: fn(*args), 5)
    total = sum(cycles)
    rows = []
    err = "not compared" if rel is None else f"{rel:.3e} of max |plain|"
    log(f"{name}: kernel {ms:.4f} ms (profile build {prof_ms:.4f} ms), error vs plain {err} "
        f"| {card}")
    for s, (label, c) in enumerate(zip(SECTIONS, cycles)):
        if c == 0:
            continue
        share = c / total
        ranks = [rc[s] / total for rc in per_rank]
        rows.append(dict(section=s, label=label, cycles=c, share=share, ms=share * ms,
                         rank_shares=ranks))
        by_rank = ("  ranks " + " / ".join(f"{100 * v:5.2f} %" for v in ranks)) if cl > 1 else ""
        log(f"  {s} {label:32s} {100 * share:6.2f} %  {share * ms:8.4f} ms{by_rank}")
    torch.cuda.synchronize()
    return dict(name=name, ms=ms, profile_ms=prof_ms, rel_err=rel, sections=rows)


def mf_box(dev, seed: int):
    """mf-ompa (conv denominator 81, random weights from ``seed``) and its
    MF_ATOMS-atom water box: ``(spec, calc, graph, vec, src, coef)``."""
    from chip_smoke import MF_DENOMINATOR, box_edges, log, water_box
    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.model.build import build_model_spec
    from sevennet_tpu_torch.model.presets import MF_OMPA

    cfg = dict(MF_OMPA, chemical_species=["H", "O"], conv_denominator=MF_DENOMINATOR)
    spec = build_model_spec(cfg)
    params = params_from_numpy(spec, random_params(spec, seed))
    pos, Z, cell = water_box(MF_ATOMS // 3)
    calc, g, vec, src, coef = box_edges(spec, params, dev, AtomsLite(
        positions=pos, numbers=Z, cell=cell, pbc=True))
    log(f"mf-ompa {MF_ATOMS}-atom box: N={g.n_atoms_cap} K={g.dense_k} "
        f"edges={int(g.edge_mask.sum())}")
    return spec, calc, g, vec, src, coef


def split_times(dev, card, seed: int, reps: int = 2):
    """B1, B2 and B2′ (ms, CUDA events) at mf-ompa's layers MF_LAYERS under
    the planner's rank split and under the most even W3 columns alone,
    ``reps`` times in turns."""
    import torch

    from chip_smoke import cuda_time, log
    from sevennet_tpu_torch.model.model import edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc

    spec, calc, g, vec, src, coef = mf_box(dev, seed)
    gen = torch.Generator(device="cpu").manual_seed(2)
    costs = {"planner": (fc.TERM_COST, fc.LEAD_COST), "W3 columns": (0, 0)}
    rows = []
    for _ in range(reps):
        for name, (term, lead) in costs.items():
            fc.TERM_COST, fc.LEAD_COST = term, lead
            for t in MF_LAYERS:
                layer = spec.layers[t]
                op = fc.FusedConvOp(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
                ws = calc.params[f"{t}_convolution"]["weight_nn"]["w"]
                x = torch.randn(g.n_atoms_cap, op.dim_x, generator=gen).to(dev)
                ybar = torch.randn(g.n_atoms_cap, op.dim_mid, generator=gen).to(dev)
                a = (op, x, src, vec, coef, ws)
                ms = {"B1": cuda_time(lambda: fc.fused_conv_fwd(*a), 5),
                      "B2": cuda_time(lambda: fc.fused_conv_bwd(*a, ybar), 5),
                      "B2'": cuda_time(lambda: fc.fused_conv_bwd(*a, ybar, param_grads=True), 3)}
                ranks = [list(r.xi) for r in op.plan.ranks]
                log(f"split {name}, mf-ompa layer {t}: x irreps by rank {ranks}, blocks "
                    f"{list(op.plan.rank_blocks)}: " + ", ".join(f"{k} {v:.4f} ms"
                                                              for k, v in ms.items())
                    + f" | {card}")
                rows.append(dict(split=name, layer=t, ranks=ranks, ms=ms))
                del x, ybar, a
    fc.TERM_COST, fc.LEAD_COST = costs["planner"]
    return rows


def mf_ompa_breakdowns(dev, card, seed: int):
    """B1 and B2 at mf-ompa's layers MF_LAYERS on the MF_ATOMS-atom box."""
    import torch

    from chip_smoke import log
    from sevennet_tpu_torch.model.model import edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc

    spec, calc, g, vec, src, coef = mf_box(dev, seed)
    N, n_edges = g.n_atoms_cap, int(g.edge_mask.sum())
    gen = torch.Generator(device="cpu").manual_seed(2)
    results = []
    for t in MF_LAYERS:
        layer = spec.layers[t]
        op = fc.conv_op(layer.conv, layer.radial_mlp, edge_embed_spec(spec, layer))
        ws = calc.params[f"{t}_convolution"]["weight_nn"]["w"]
        x = torch.randn(N, op.dim_x, generator=gen).to(dev)
        ybar = torch.randn(N, op.dim_mid, generator=gen).to(dev)
        plan = plan_summary(op)
        readback = dxg_readback_bytes(op, n_edges)
        log(f"mf-ompa layer {t}: plan {plan}; B2 reads back {readback} bytes of dxg "
            f"({readback / 2**20:.1f} MiB; dxg itself {n_edges * op.dim_x * 4 / 2**20:.1f} MiB)")
        a = (op, x, src, vec, coef, ws)
        for kind, yb, fn in (("B1 fwd", None, lambda: fc.fused_conv_fwd(*a)),
                             ("B2 bwd", ybar, lambda: fc.fused_conv_bwd(*a, ybar))):
            r = breakdown(f"{kind}, mf-ompa layer {t}", *a, yb, fn, None, dev, card)
            r.update(plan=plan, dxg_readback_bytes=readback if yb is not None else 0)
            results.append(r)
        del x, ybar, a
        torch.cuda.empty_cache()
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("mf",), default=None)
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    out_dir = os.path.abspath("chiprun_out")
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("conv_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import gpu_line, log, sevennet0_spec, water_box
    from sevennet_tpu_torch.atoms import AtomsLite
    from sevennet_tpu_torch.calculator import SevenNetCalculator
    from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
    from sevennet_tpu_torch.model.model import edge_emb_sh, edge_embed_spec
    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | package "
        f"{os.path.dirname(kernels.CSRC_DIR)}")
    conv_libs = ("fused_conv_fwd", "fused_conv_bwd")
    kernels.build(conv_libs + ("pg_reduce",))
    kernels.build(conv_libs, profile=True)
    results = []
    if args.splits:
        return finish(out_dir, card, split_times(dev, card, args.seed))
    if args.only == "mf":
        results += mf_ompa_breakdowns(dev, card, args.seed)
        return finish(out_dir, card, results)
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
    del a, x, ybar
    torch.cuda.empty_cache()
    results += mf_ompa_breakdowns(dev, card, args.seed)
    return finish(out_dir, card, results)


def finish(out_dir, card, results) -> int:
    out = {"card": card, "breakdown": results}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "conv_breakdown.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
