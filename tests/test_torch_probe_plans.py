"""The launch plans of the matmul-rate probe's kernels (3xTF32; ffma; the
tensor-core kernel), of the column gather, of the conv fold and
of the breakdown template's per-edge uvu product, walked in numpy as the
kernels index their work, the 3xTF32
split with A split for every product emulated in numpy against float64,
the conv fold's order of sums emulated in numpy against its plain
version, bitwise, and the per-edge product's order of terms against the
plain messages. CPU only: the kernels themselves are held against their
plain versions on the card (``tests/test_torch_kernels.py``, ``gpu``).
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from sevennet_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_tpu_torch.ops import fused_conv as fc
from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec
from sevennet_tpu_torch.probes import breakdown as bd
from sevennet_tpu_torch.probes import fold_conv as fcv
from sevennet_tpu_torch.probes import gather as ga
from sevennet_tpu_torch.probes import mm_rate as mr

MM_CASES = ([(m, k, n, False) for m, k, n in mr.MM_SHAPES]
            + [(m, k, n, True) for m, k, n in mr.CHAIN_SHAPES]
            + [(100, 64, 70, False), (70, 130, 40, False), (70, 130, 40, True),
               (185, 9, 33, False), (1, 8, 1, False), (64, 16, 64, True)])


def mm_walk(m, k, n, plan):
    """What each output element of one copy receives from the 3xTF32 kernel
    (csrc/probe_mm.cu probe_mm3x_kernel), as its indices say: CTA b,
    warpgroup wg, warp w, lane (g, q), fragment (j, h, e). Returns (k-steps
    summed into each element, stores into each element)."""
    nks = -(-k // 8)
    per = -(-nks // plan.ks)
    tiles_n = -(-n // mr.BN)
    steps = np.zeros((m, n), dtype=np.int64)
    stores = np.zeros((m, n), dtype=np.int64)
    for b in range(plan.ctas):
        tm, col0 = b // tiles_n, (b % tiles_n) * mr.BN
        for wg in range(2):
            row0 = tm * 64 * plan.mw + (64 * wg if plan.mw == 2 else 0)
            s_lo = wg * per if plan.ks == 2 else 0
            s_hi = min(nks, s_lo + per)
            if plan.ks == 1 and row0 >= m:
                continue
            for w in range(4):
                for g in range(8):
                    for q in range(4):
                        for j in range(mr.BN // 8):
                            for h in range(2):
                                r = row0 + 16 * w + g + 8 * h
                                for e in range(2):
                                    c = col0 + 8 * j + 2 * q + e
                                    if r < m and c < n:
                                        steps[r, c] += s_hi - s_lo
                                        if plan.ks == 1 or wg == 0:
                                            stores[r, c] += 1
    return steps, stores


@pytest.mark.parametrize("m,k,n,carry", MM_CASES,
                         ids=[f"{m}x{k}x{n}{'_chain' if c else ''}" for m, k, n, c in MM_CASES])
def test_mm_plan_covers_every_output_once(m, k, n, carry):
    """Every output element is stored once and sums every k-step once (ks 2:
    the two warpgroups' halves, added before warpgroup 0 stores); the
    carried chain never splits k."""
    plan = mr.mm_plan(m, k, n, carry)
    assert (plan.mw, plan.ks) in ((2, 1), (1, 2)) and plan.ctas > 0
    if carry or -(-k // 8) < 2:
        assert plan.ks == 1
    assert plan.ctas == -(-m // (64 * plan.mw)) * -(-n // mr.BN)
    steps, stores = mm_walk(m, k, n, plan)
    assert (stores == 1).all()
    assert (steps == -(-k // 8)).all()


def test_mm_plan_fills_the_card():
    """One copy at the scripts' first shape is one wave of 120 CTAs; the k
    512 shapes split k to run 128 CTAs instead of 64. Every variant runs on
    the plan: two warpgroup tiles of 64 x 64 a CTA, or one; wgmma_tf32 one
    warpgroup a CTA on 64 x 128 tiles at the k-64 shapes (128 and 120 CTAs)
    and on 64 x 64 at the small ones, k split only at k 512."""
    assert mr.mm_plan(1024, 64, 960) == mr.MmPlan(2, 1, 120)
    assert mr.mm_plan(1024, 64, 960, carry=True) == mr.MmPlan(2, 1, 120)
    assert mr.mm_plan(480, 512, 1024) == mr.MmPlan(1, 2, 128)
    assert mr.mm_plan(1024, 512, 480) == mr.MmPlan(1, 2, 128)
    assert mr.mm_ctas(1024, 64, 960, "3xtf32") == 120
    assert mr.mm_ctas(1024, 64, 960, "tf32") == 120 and mr.mm_tiles(1024, 960) == 240
    # the scripts' shapes: the four large ones fill one wave on 132 SMs, or
    # (ffma, whose registers allow two CTAs an SM) two CTAs an SM
    assert mr.PER_SM == {"ffma": 2}
    for v in mr.VARIANTS:
        two = v == "ffma"
        assert [mr.mm_ctas(m, k, n, v) for m, k, n in mr.MM_SHAPES] == (
            [240 if two else 128 if v == "wgmma_tf32" else 120, 240 if two else 120
             if v == "wgmma_tf32" else 128, 48, 48, 128, 128])
        assert [mr.mm_ctas(m, k, n, v, carry=True) for m, k, n in mr.CHAIN_SHAPES] == (
            [128 if v == "wgmma_tf32" else 120, 24 if v in mr.WGMMA_3X else 96 if two else 48])
    assert mr.mm_plan(1024, 9, 185, True, variant="ffma") == mr.MmPlan(1, 1, 96, 32)
    wg = [mr.mm_plan(m, k, n, variant="wgmma_tf32") for m, k, n in mr.MM_SHAPES]
    assert wg == [mr.MmPlan(1, 1, 128, 64, 128), mr.MmPlan(1, 1, 120, 64, 128),
                  mr.MmPlan(1, 1, 48), mr.MmPlan(1, 1, 48), mr.MmPlan(1, 2, 128),
                  mr.MmPlan(1, 2, 128)]
    assert mr.mm_plan(1024, 64, 960, True, variant="wgmma_tf32") == mr.MmPlan(1, 1, 128, 64, 128)


MM1_VARIANTS = ("ffma", "tf32", "wgmma_tf32", "bf16")


def mm1_tile(variant, rows=64, bn=64):
    """Rows and columns, within its warpgroup's rows x bn tile, of each
    storing thread's accumulators as csrc/probe_mm.cu's probe_mm_ffma_kernel
    and probe_mm_tc_kernel store them: arrays (threads, accumulators). ffma:
    thread t = (ty, tx) of each half of the warpgroup (half 0 stores), TR =
    rows / 8 rows a thread, u[8 i + 4 hc + x] at row TR ty + i, column 32 hc
    + 4 tx + x; wgmma_tf32: u[4 j + 2 h + x] (bn / 2 of them) of thread wt
    at row 16 warp + g + 8 h, column 8 j + 2 q + x; tf32, bf16: warp (wm,
    wn)'s mma tile (mt, nt) = (j / 4, j % 4) at 32 wm + 16 mt, 32 wn + 8
    nt."""
    if variant == "ffma":
        tr = rows // 8
        t = np.arange(64)[:, None]
        e = np.arange(8 * tr)[None, :]
        ty, tx = t >> 3, t & 7
        return tr * ty + (e >> 3), 32 * ((e >> 2) & 1) + 4 * tx + (e & 3)
    assert rows == 64 and (bn == 64 or variant == "wgmma_tf32")
    wt = np.arange(128)[:, None]
    e = np.arange(bn // 2)[None, :]
    warp, lane = wt >> 5, wt & 31
    g, q = lane >> 2, lane & 3
    j, h, x = e >> 2, (e >> 1) & 1, e & 1
    if variant == "wgmma_tf32":
        return 16 * warp + g + 8 * h + 0 * j, 8 * j + 2 * q + x
    return (32 * (warp & 1) + 16 * (j >> 2) + g + 8 * h,
            32 * (warp >> 1) + 8 * (j & 3) + 2 * q + x)


def mm1_units(m, n, plan, copies):
    """The (CTA, unit, copy, tile) that compute each unit (a CTA tile of
    one copy), as the kernels index them: CTA (blockIdx.x, blockIdx.y) is
    tile blockIdx.x of copy blockIdx.y."""
    tiles = -(-m // (plan.rows * plan.mw)) * -(-n // plan.bn)
    assert tiles == plan.ctas
    return [((t, c), t + tiles * c, c, t) for c in range(copies) for t in range(tiles)]


def mm1_walk(m, k, n, plan, variant, copies=1):
    """What each output element of each copy receives from probe_mm_ffma_kernel
    or probe_mm_tc_kernel, as their indices say: each unit's (mm1_units)
    warpgroups wg, their chunks of 8 k-steps staged from 8 s0 up to k or the
    warpgroup's last k-step (zeros past), a warpgroup whose rows start past
    m skipping the unit (ks 1); ffma's two halves of a warpgroup each a
    half of a chunk's k, summed into the elements of half 0's threads.
    Returns (k values summed into each element, stores into each element),
    both (copies, m, n), and the units each CTA ran."""
    nks = -(-k // 8)
    per = -(-nks // plan.ks)
    tiles_n = -(-n // plan.bn)
    rr, cc = mm1_tile(variant, plan.rows, plan.bn)
    steps = np.zeros((copies, m, n), dtype=np.int64)
    stores = np.zeros((copies, m, n), dtype=np.int64)
    ran = {}
    for cta, unit, copy, tile in mm1_units(m, n, plan, copies):
        ran[cta] = ran.get(cta, 0) + 1
        tm, col0 = tile // tiles_n, (tile % tiles_n) * plan.bn
        for wg in range(plan.mw * plan.ks):
            row0 = tm * plan.rows * plan.mw + (plan.rows * wg if plan.mw == 2 else 0)
            s_lo = wg * per if plan.ks == 2 else 0
            s_hi = min(nks, s_lo + per)
            if plan.ks == 1 and row0 >= m:
                continue
            kk = 0
            for s0 in range(s_lo, s_hi, 8):
                kc = min(k, 8 * min(s0 + 8, s_hi)) - 8 * s0
                if variant == "ffma":  # half 0: k < (kc + 1) / 2, half 1 the rest
                    kh = (kc + 1) // 2
                    kk += kh + (kc - kh)
                else:
                    kk += kc
            r, c = row0 + rr, col0 + cc
            keep = (r < m) & (c < n)
            np.add.at(steps[copy], (r[keep], c[keep]), kk)
            if plan.ks == 1 or wg == 0:
                np.add.at(stores[copy], (r[keep], c[keep]), 1)
    return steps, stores, ran


@pytest.mark.parametrize("variant", MM1_VARIANTS)
@pytest.mark.parametrize("m,k,n,carry", MM_CASES,
                         ids=[f"{m}x{k}x{n}{'_chain' if c else ''}" for m, k, n, c in MM_CASES])
def test_mm_kernel_plan_covers_every_output_once(m, k, n, carry, variant):
    """probe_mm_ffma_kernel (ffma) and probe_mm_tc_kernel (tf32, wgmma_tf32,
    bf16) on their mm_plan (one warpgroup a CTA among the arrangements, and
    32-row tiles for ffma's chain), and wgmma_tf32 also at wgmma N 128 on
    every arrangement where a warpgroup's k-steps are one chunk: every
    output element of every copy is stored once and sums every k once, each
    variant's threads mapped onto the tile as the kernel stores them; at
    one copy on 132 SMs, and at 3 copies on 7 SMs; every CTA runs one unit
    (tile, copy)."""
    nks = -(-k // 8)
    plans = [(mr.mm_plan(m, k, n, carry, copies, n_sm, variant), copies, True)
             for copies, n_sm in ((1, mr.N_SM), (3, 7))]
    if variant == "wgmma_tf32":
        plans += [(mr.MmPlan(mw, ks, -(-m // (64 * mw)) * -(-n // 128), 64, 128), 2, False)
                  for mw, ks in ((2, 1), (1, 2), (1, 1))
                  if -(-nks // ks) <= 8 and not (ks == 2 and (carry or nks < 2))]
    for plan, copies, planned in plans:
        assert (plan.mw, plan.ks) in ((2, 1), (1, 2), (1, 1)) and plan.ctas > 0
        assert plan.rows == 64 or (variant == "ffma" and carry and plan.mw * plan.ks == 1)
        assert plan.bn == 64 or (variant == "wgmma_tf32" and -(-nks // plan.ks) <= 8)
        if carry or nks < (mr.KS_MIN_STEPS.get(variant, 2) if planned else 2):
            assert plan.ks == 1
        steps, stores, ran = mm1_walk(m, k, n, plan, variant, copies)
        assert (stores == 1).all()
        assert (steps == k).all()
        assert len(ran) == plan.ctas * copies and set(ran.values()) == {1}

def test_mm_breakdown_patch_applies():
    """mm_breakdown.py's builds patch csrc/probe_mm.cu as it stands: every
    hunk of mm_breakdown.patch matches once; the patched source defines the
    knock-outs (MM_KO) that the unpatched one, which the wrappers load,
    does not know, and guards the staging, products, acc update and store
    of both probe_mm_ffma_kernel and probe_mm_tc_kernel with them."""
    import importlib.util

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("mm_breakdown", root / "mm_breakdown.py")
    mb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mb)
    src = (root / "sevennet_tpu_torch" / "csrc" / "probe_mm.cu").read_text()
    text = mb.apply_patch(src, mb.PATCH.read_text())
    assert "MM_KO" not in src and "#define MM_KO 0" in text
    for guard in ("if (MM_KO_STAGE) mf_stage", "pc < 8 + TN / 8 && MM_KO_STAGE",
                  "V == V_WGMMA_TF32 && MM_KO_STAGE", "if (MM_KO_STAGE) tc_frags",
                  "mf_product<false, TR>", "tc_product<V, false, TN>",
                  "(MM_KO_STORE && p.rep >= 0)", "!CARRY && MM_KO != 3"):
        assert guard in text
    assert text.count("if (MM_KO_PRODUCTS)") == 2 and text.count("if (MM_KO != 3)") == 2
    assert set(mb.KO_BUILDS.values()) == {(f"MM_KO={i}",) for i in range(1, 6)}


def mm_weight(s, rep=mr.REP):
    """csrc/probe_mm.cu mm_weight in float32: W / S, the weight of the
    products in the rate contract (W = sum_i 0.5^(REP-1-i) (1 + s i), S the
    same with factors 1), 0 without products."""
    w = s_ = np.float32(0.0)
    for i in range(rep):
        w = np.float32(0.5) * w + (np.float32(1.0) + s * np.float32(i))
        s_ = np.float32(0.5) * s_ + np.float32(1.0)
    return w / s_ if rep > 0 else np.float32(0.0)


def rate_chunks_walk(a, b, s, plan):
    """probe_mm_tc_kernel's rate contract in numpy float32: each warpgroup's
    k-steps (``plan``'s ks halves) in chunks of 64; a chunk's REP products
    accumulate into u (u = 0.5 u + P a product); the chunks' sums added,
    then the halves, then multiplied by the weight (mm_weight). The order of
    the sums within a product aside, the kernel's arithmetic."""
    k = a.shape[1]
    nks = -(-k // 8)
    per = -(-nks // plan.ks)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for half in range(plan.ks):
        tot = np.zeros_like(total)
        for k0 in range(8 * half * per, min(k, 8 * (half + 1) * per), 64):
            k1 = min(k, k0 + 64, 8 * (half + 1) * per)
            pc = a[:, k0:k1] @ b[k0:k1]
            u = np.zeros_like(total)
            for i in range(mr.REP):
                u = u * np.float32(0.5) + pc
            tot = tot + u
        total = total + tot
    return total * mm_weight(s)


@pytest.mark.parametrize("variant", ["tf32", "ffma"])
def test_rate_chunks_walk_at_k512(variant):
    """The chunk-wise rate recurrence at 480 x 512 x 1024 (ks 2: two halves
    of 4 chunks, each chunk's 16 products, then the chunks summed), on
    operands rounded to TF32 as the kernel stages them for tf32 (as they
    are for ffma), stays within mm_rate.PROBE_TOL of the float64 loop (s =
    1e-3, so that the factor 1 + s i is checked)."""
    m, k, n = 480, 512, 1024
    plan = mr.mm_plan(m, k, n, variant=variant)
    assert (plan.mw, plan.ks) == (1, 2)
    rng = np.random.default_rng(8)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    s = np.float32(1e-3)
    got = rate_chunks_walk(tf32_rna(a) if variant == "tf32" else a,
                           tf32_rna(b) if variant == "tf32" else b, s, plan)
    p64 = a.astype(np.float64) @ b.astype(np.float64)
    ref = np.zeros((m, n))
    for i in range(mr.REP):
        ref = ref * 0.5 + (1.0 + float(s) * i) * p64
    err = float(np.abs(got - ref).max())
    assert err <= mr.PROBE_TOL[variant] * float(np.abs(ref).max())


@pytest.mark.parametrize("s", [-0.125, -1.0, -0.1, 1e-3])
def test_rate_weight_where_a_factor_is_zero(s):
    """The rate contract's weight (mm_weight, as the kernels compute it) is
    finite and within 1e-6 of the float64 sum where some factor 1 + s i is
    0 (s -0.125: i 8; -1: i 1) or negative, so that the output of the
    recurrence u = 0.5 u + P times it stays within 1e-5 of the float64
    loop acc = 0.5 acc + (1 + s i) P, and is 0 without products."""
    w = mm_weight(np.float32(s))
    ref = sum(0.5 ** (mr.REP - 1 - i) * (1.0 + float(np.float32(s)) * i) for i in range(mr.REP))
    ref /= sum(0.5 ** (mr.REP - 1 - i) for i in range(mr.REP))
    assert np.isfinite(w) and abs(float(w) - ref) <= 1e-6 * max(1.0, abs(ref))
    assert mm_weight(np.float32(s), 0) == 0.0
    rng = np.random.default_rng(9)
    a = rng.normal(size=(48, 64)).astype(np.float32)
    b = rng.normal(size=(64, 40)).astype(np.float32)
    got = rate_chunks_walk(a, b, np.float32(s), mr.MmPlan(2, 1, 1))
    p64 = a.astype(np.float64) @ b.astype(np.float64)
    acc = np.zeros_like(p64)
    for i in range(mr.REP):
        acc = acc * 0.5 + (1.0 + float(np.float32(s)) * i) * p64
    assert np.isfinite(got).all()
    assert float(np.abs(got - acc).max()) <= 1e-5 * float(np.abs(acc).max())


def cols_walk(d, t, copies, plan):
    """How often each output element of the column gather is written, as the
    kernel's indices say (csrc/probe_gather.cu probe_gather_cols_kernel):
    thread (quad, row lane) of CTA (x, y, copy) writes t 4 (x QB + quad) ..
    + 3 of rows y RG R + lane + RG r."""
    qb, rg, rows = ga.COLS_QB, ga.COLS_RG, plan.rows
    hits = np.zeros((copies, d, t), dtype=np.int64)
    gx, gy, gz = plan.grid
    for x in range(gx):
        for y in range(gy):
            for tid in range(qb * rg):
                t0 = 4 * (x * qb + tid % qb)
                d0 = y * rg * rows + tid // qb
                if t0 >= t:
                    continue
                for r in range(rows):
                    dd = d0 + rg * r
                    if dd < d:
                        hits[:, dd, t0:min(t0 + 4, t)] += 1
    assert gz == copies
    return hits


COLS_CASES = ((480, 1024, 1), (480, 1024, 3), (37, 1000, 1), (480, 33, 3), (5, 3, 2),
              (481, 1023, 1))


@pytest.mark.parametrize("d,t,copies", COLS_CASES,
                         ids=[f"{d}x{t}x{c}" for d, t, c in COLS_CASES])
def test_cols_plan_covers_every_output_once(d, t, copies):
    plan = ga.cols_plan(d, t, copies)
    assert plan.rows in ga.COLS_ROWS
    assert plan.ctas == plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert (cols_walk(d, t, copies, plan) == 1).all()


def test_cols_plan_fills_the_card():
    """p1's one call (480 rows, 1,024 indices) runs on more CTAs than the
    card has SMs; more copies take more rows a thread."""
    dx, _, t = ga.TABLE_SHAPE
    plan = ga.cols_plan(dx, t)
    assert plan.ctas >= 132 and plan == ga.ColsPlan(2, (4, 60, 1), 240)
    assert ga.cols_plan(dx, t, copies=3).rows == 4
    assert ga.cols_plan(8, 16).rows == 1


def tf32_rna(x):
    """cvt.rna.tf32.f32: the nearest value with 10 mantissa bits, ties away
    from zero, as float32."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


@pytest.mark.parametrize("m,k,n", [(1024, 64, 960), (1024, 9, 185)])
@pytest.mark.parametrize("carry", [False, True], ids=["rate", "chain"])
def test_3xtf32_per_product_split_is_fp32_accurate(m, k, n, carry):
    """The kernel's arithmetic in numpy: each product's A (plus the carry)
    split into TF32 hi and lo, B split once, lo hi + hi lo + hi hi in
    float32, acc = 0.5 acc + f P; within mm_rate.PROBE_TOL of the float64
    loop (s = 1e-3, so that the factor 1 + s i is checked)."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    s = np.float32(1e-3)
    bh, bl = split(b)
    acc = np.zeros((m, n), np.float32)
    ref = np.zeros((m, n))
    for i in range(mr.REP):
        if carry:
            ai = a + np.float32(acc[0, 0] * np.float32(1e-20))
            ai64 = a.astype(np.float64) + ref[0, 0] * 1e-20
            f, f64 = np.float32(1.0), 1.0
        else:
            ai, ai64 = a, a.astype(np.float64)
            f = np.float32(1.0) + s * np.float32(i)
            f64 = 1.0 + float(s) * i
        ah, al = split(ai)
        p = (al @ bh + ah @ bl) + ah @ bh
        acc = acc * np.float32(0.5) + f * p
        ref = ref * 0.5 + f64 * (ai64 @ b.astype(np.float64))
    err = float(np.abs(acc - ref).max())
    assert err <= mr.PROBE_TOL["3xtf32"] * float(np.abs(ref).max())


# the conv fold's layers: SevenNet-0's (the script's) and the GPU test's
# (tests/test_torch_kernels.py: 16x0e+8x1e+4x2e, MLP (8, 16, 16, numel), K 24)
def _fc_layer(name):
    if name == "sevennet0":
        conv, mlp = fcv.sevennet0_conv()
        return conv, mlp.dims
    x_ir, f_ir = Irreps(name), Irreps.spherical_harmonics(2, 1)
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    return conv, (8, 16, 16, conv.weight_numel)


FC_LAYERS = (("sevennet0", 72), ("16x0e+8x1e+4x2e", 24))


def fold_conv_walk(conv, dims, k, variant):
    """How often each output column of a receiver is stored, and the K
    slots each stored column sums, as the kernel's indices say
    (csrc/probe_fold_conv.cu): tile t, warp w's record, lane (g, q): its
    channels u0 + 2 g + h, its positions lane_slots[q]; lane q = 0 stores."""
    pl = fcv.plan(conv, dims, k, variant)
    dim_mid = fcv._tables(conv)[2]
    stores = np.zeros(dim_mid, np.int64)
    slots = [sorted(s for q in range(4) for s in pl.slots[q] if s >= 0)]
    for t in range(pl.n_tiles):
        for w in range(4):
            path, x0, mul, u0, obase, u_tot, roff, w0 = pl.gtab[(4 * t + w) * fcv.GREC:][:fcv.GREC]
            if path < 0:
                continue
            d3 = fcv.path_list()[path][1]
            for g in range(8):
                for h in range(2):
                    u = u0 + 2 * g + h
                    if u < mul:
                        for p in range(d3):
                            stores[obase + p * u_tot + u] += 1
    return stores, slots[0]


@pytest.mark.parametrize("variant", fcv.VARIANTS)
@pytest.mark.parametrize("layer,k", FC_LAYERS, ids=[n for n, _ in FC_LAYERS])
def test_fold_conv_plan_covers_every_column_once(layer, k, variant):
    """Every output column of a receiver is stored once, and the four lanes
    of a channel hold each of its K slots once."""
    conv, dims = _fc_layer(layer)
    stores, slots = fold_conv_walk(conv, dims, k, variant)
    assert (stores == 1).all()
    assert slots == list(range(k))


@pytest.mark.parametrize("layer,k", FC_LAYERS, ids=[n for n, _ in FC_LAYERS])
def test_fold_conv_plan_carve(layer, k):
    """A CTA's shared memory fits SMEM_LIMIT; at SevenNet-0's layer it
    leaves room for 2 CTAs (16 warps) an SM: two warpgroups' 53,632 bytes
    (the last hidden layer's hi and lo, 36,864; sh, 2,592; a 49-row tmp
    window, 14,112; rounded to 128 bytes)."""
    conv, dims = _fc_layer(layer)
    for v in fcv.VARIANTS:
        pl = fcv.plan(conv, dims, k, v)
        assert pl.smem <= fcv.SMEM_LIMIT
        assert pl.carve >= 2 * pl.np_ * pl.hk + pl.np_ * conv.irreps_filter.dim + max(
            pl.np_ * pl.tw_rows, 2 * pl.np_ * pl.nbk)
        ttab = pl.ttab.reshape(-1, 2)
        assert (ttab[:, 1] <= pl.tw_rows).all() and pl.tw_rows == ttab[:, 1].max()
    if layer == "sevennet0":
        assert pl.smem == 2 * 53632 and pl.ctas_per_sm >= 2 and pl.n_tiles == 15


def _emulate_fold_conv(conv, xg, emb, sh, ws, w3j, k, variant):
    """The kernel's sums in numpy float32, in its order (plan, lane_slots,
    the counter and stack of sliceadd, the shuffles' pairs), on the plain
    version's w and tmp."""
    f32 = np.float32
    dims = (ws[0].shape[0], *(w.shape[1] for w in ws))
    pl = fcv.plan(conv, dims, k, variant)
    h = torch.tensor(emb)
    for li, w in enumerate(ws):
        h = (h @ torch.tensor(w)) * (1.0 / math.sqrt(w.shape[0]))
        if li < len(ws) - 1:
            h = torch.nn.functional.silu(h) * fcv.NORMALIZE2MOM_CST["silu"]
    wv = h.numpy()
    tmp = (torch.tensor(sh) @ torch.tensor(w3j).t()).numpy()
    n = xg.shape[0] // k
    out = np.zeros((n, fcv._tables(conv)[2]), f32)
    a = fcv._ctz(k)
    c, t_leaves = k >> a, 1 << max(a - 2, 0)
    order, pops, _, _ = fcv._sa_top(c)
    rows = np.arange(n) * k
    for t in range(pl.n_tiles):
        r_lo = pl.ttab[2 * t]
        for w in range(4):
            path, x0, mul, u0, obase, u_tot, roff, w0 = pl.gtab[(4 * t + w) * fcv.GREC:][:fcv.GREC]
            if path < 0:
                continue
            d1, d3, mask = fcv.path_list()[path]
            pairs = [(m, p) for m in range(d1) for p in range(d3) if mask >> (m * d3 + p) & 1]
            for u in range(u0, min(u0 + fcv.UG, mul)):
                lanes = []  # per lane q: its per-row sums (sliceadd: per S_r)
                for q in range(4):
                    gs = [[f32(0)] * 2 for _ in range(d3)]  # [p][sum]
                    leaves = {}
                    for i, s in enumerate(pl.slots[q]):
                        if s < 0:
                            continue
                        xw = [(xg[rows + s, x0 + m * mul + u] * wv[rows + s, w0 + u]).astype(f32)
                              for m in range(d1)]
                        v = [np.zeros(n, f32) for _ in range(d3)]
                        for rk, (m, p) in enumerate(pairs):
                            term = (xw[m] * tmp[rows + s, r_lo + roff + rk]).astype(f32)
                            if variant == "sliceadd":
                                v[p] = (v[p] + term).astype(f32)
                            else:
                                ci = i % 2 if variant == "group8" else 0
                                gs[p][ci] = (gs[p][ci] + term).astype(f32)
                        if variant == "sliceadd":
                            leaves[i] = v
                    if variant == "sliceadd":
                        per_r = []
                        for rho in range(c):  # the binary counter over a subtree's leaves
                            part = {}
                            for tp in range(t_leaves):
                                x = leaves[rho * t_leaves + tp]
                                lvl = 0
                                while tp >> lvl & 1:
                                    x = [(part[lvl][p] + x[p]).astype(f32) for p in range(d3)]
                                    lvl += 1
                                part[lvl] = x
                            per_r.append(x)
                        lanes.append(per_r)
                    else:
                        lanes.append([gs[p][0] if variant == "group4" else
                                      (gs[p][0] + gs[p][1]).astype(f32) for p in range(d3)])

                def across(vals):  # q ^ 2, then q ^ 1: lane 0's value
                    x = [(vals[q] + vals[q ^ 2]).astype(f32) for q in range(4)]
                    return (x[0] + x[1]).astype(f32)

                for p in range(d3):
                    if variant == "sliceadd":
                        stk = []
                        for rho, r in enumerate(order):
                            stk.append(across([lanes[q][rho][p] for q in range(4)]))
                            for _ in range(pops[rho]):
                                b = stk.pop()
                                stk.append((stk.pop() + b).astype(f32))
                        res = stk[0]
                    else:
                        res = across([lanes[q][p] for q in range(4)])
                    out[:, obase + p * u_tot + u] = res
    return out


@pytest.mark.parametrize("variant", fcv.VARIANTS)
@pytest.mark.parametrize("k", fcv.KERNEL_K)
def test_fold_conv_kernel_order_is_plain_order(k, variant):
    """The kernel's walk and order of sums, emulated in numpy on the plain
    version's w and tmp, gives the plain version bitwise: the products are
    the same, so every sum must be in the same order. Also on the
    cancelling input, where another order is far off."""
    conv, dims = _fc_layer("8x0e+4x1e+2x2e")
    rng = np.random.default_rng(k)
    n = 3
    ws = [(rng.normal(size=(a, b))).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]
    w3j = fcv._tables(conv)[1]
    inputs = [[(rng.normal(size=(n * k, d)) * sc).astype(np.float32) for d, sc in
               ((conv.irreps_x.dim, 0.5), (dims[0], 0.3), (conv.irreps_filter.dim, 0.5))],
              [v.numpy() for v in fcv.cancelling_input(n, k, conv, 5, "cpu")]]
    for xg, emb, sh in inputs:
        want = fcv.fold_conv(conv, *(torch.tensor(v) for v in (xg, emb, sh)),
                             [torch.tensor(w) for w in ws], torch.tensor(w3j), k, variant,
                             plain=True).numpy()
        got = _emulate_fold_conv(conv, xg, emb, sh, ws, w3j, k, variant)
        assert np.array_equal(got, want)


def test_fold_conv_paths_header_is_current():
    """csrc/probe_fold_conv_paths.cuh is path_header()'s text: the kernel is
    compiled for the shapes the host maps instructions to."""
    path = Path(fcv.__file__).resolve().parent.parent / "csrc" / fcv.PATHS_HEADER
    assert path.read_text() == fcv.path_header()
    assert len(fcv.path_list()) == 15  # every (l1, l2, l3) path of l <= 2


def test_fold_conv_kernel_refuses_what_it_is_not_built_for():
    conv, dims = _fc_layer("sevennet0")
    fcv._check_kernel(conv, dims, 72)
    with pytest.raises(ValueError, match="compiled for K"):
        fcv._check_kernel(conv, dims, 48)
    with pytest.raises(ValueError, match="at most 64"):
        fcv._check_kernel(conv, (8, 128, 64, dims[-1]), 72)
    x3 = Irreps("8x0e+4x1e+2x2e+2x3e")
    f3 = Irreps.spherical_harmonics(3, 1)
    conv3 = ConvTPSpec(x3, f3, infer_irreps_out(x3, f3, 3, "full"))
    with pytest.raises(ValueError, match="l <= 2"):
        fcv._check_kernel(conv3, (8, 16, 16, conv3.weight_numel), 24)


def edge_walk(op, plan, xg, h, tmp):
    """The per-edge product as the kernel forms it
    (csrc/probe_breakdown.cuh:uvu_edges), walked in numpy over
    ``plan``'s tasks on the plain version's ``xg``, ``w`` (``h``) and
    ``tmp`` (float32 arrays, edge rows): each lane's channels of each task
    (edge-major: ``u0 + l vw .. + vw``; feature-major: ``u0 + 4 h + s``),
    ``xw = x w`` once per m, then ``fmaf`` from zero over the
    pairs in the table's (m, p) order (each as float64 and rounded to
    float32). Returns ``{(instruction, p): messages (edges, mul)}`` and the
    times each (instruction, channel) was formed."""
    instr = fc._instr_tables(op.conv)[0]
    msgs = {(k, p): np.zeros((xg.shape[0], ins["mul"]), np.float32)
            for k, ins in enumerate(instr) for p in range(ins["d3"])}
    formed = {k: np.zeros(ins["mul"], np.int64) for k, ins in enumerate(instr)}
    for k, u0, _, vw in plan.tasks:
        ins = instr[k]
        if vw:
            chans = [u0 + lane * vw + c for lane in range(32) for c in range(vw)]
        else:
            chans = [u0 + 4 * hh + s_ for s_ in range(4) for hh in range(2)]
        for u in chans:
            if u >= ins["mul"]:
                continue
            formed[k][u] += 1
            w = h[:, ins["w_start"] + u]
            xw = [np.float32(xg[:, ins["x_start"] + m * ins["mul"] + u] * w)
                  for m in range(ins["d1"])]
            acc = [np.zeros(xg.shape[0], np.float32) for _ in range(ins["d3"])]
            for m, p, r in ins["mp"]:
                acc[p] = (xw[m].astype(np.float64) * tmp[:, r].astype(np.float64)
                          + acc[p].astype(np.float64)).astype(np.float32)
            for p in range(ins["d3"]):
                msgs[(k, p)][:, u] = acc[p]
    return msgs, formed


EDGE_LAYERS = ("sevennet0", "8x0e+4x1e+2x2e", "16x0e+8x1e+4x2e")
EDGE_MAPS = {"lanes4": 4, "lanes2": 2, "lanes1": 1, "feat": 0}  # the kernel's mappings


def _edge_op(layer):
    if layer == "sevennet0":
        return fc.conv_op(*fcv.sevennet0_conv())
    x_ir, f_ir = Irreps(layer), Irreps.spherical_harmonics(2, 1)
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    return fc.conv_op(conv, ScalarMLPSpec((8, 16, 16, conv.weight_numel)))


@pytest.mark.parametrize("mapping", EDGE_MAPS)
@pytest.mark.parametrize("layer", EDGE_LAYERS)
def test_edge_plan_covers_each_channel_once_balanced(layer, mapping):
    """The per-edge product's task table (breakdown.edge_plan) as the kernel
    reads it (csrc/probe_breakdown.cuh:uvu_edges: the tasks' offset on 4
    ints, their count, per block NWARP + 1 run starts, a task 4 ints): each
    (instruction, channel) is formed once by the lanes' indices, the lane
    widths are the mapping's (edge-major: 4 a lane at mul 128, 2 at 64, 1
    at 32, at most the 0/1 sum's cap of 2), and the warps are balanced as
    the greedy order bounds them (the largest at most 4/3 of the larger of
    an even share and the costliest task); at SevenNet-0's widths within 15 %
    of an even share, so that no warp idles on an instruction of mul 32."""
    op, vw = _edge_op(layer), EDGE_MAPS[mapping]
    pl = bd.edge_plan(op, vw)
    tab = pl.table
    instr = fc._instr_tables(op.conv)[0]
    assert tab[0] % 4 == 0 and tab[1] == len(pl.tasks)
    tasks = tab[tab[0]:].reshape(-1, 4)
    assert [tuple(t) for t in tasks] == list(pl.tasks)
    nblk = len(op.plan.blocks)
    formed = {k: np.zeros(ins["mul"], np.int64) for k, ins in enumerate(instr)}
    for b, ks in enumerate(op.plan.blocks):
        runs = tab[bd.EDGE_RUNS + b * (bd.EDGE_WARPS + 1):bd.EDGE_RUNS + (b + 1) * (bd.EDGE_WARPS + 1)]
        assert tuple(runs) == pl.runs[b] and np.all(np.diff(runs) >= 0)
        for w in range(bd.EDGE_WARPS):
            for k, u0, path, v in tasks[runs[w]:runs[w + 1]]:
                assert k in ks and fcv.path_list()[path] == (
                    instr[k]["d1"], instr[k]["d3"], fcv._mask(instr[k]))
                if vw:
                    assert v <= vw and (instr[k]["mul"] < 32 * v or instr[k]["mul"] % (32 * v) == 0)
                    chans = u0 + v * np.arange(32)[:, None] + np.arange(v)[None, :]
                else:
                    assert v == 0
                    chans = np.asarray([u0 + 4 * h + s for s in range(4) for h in range(2)])
                chans = chans[chans < instr[k]["mul"]]
                np.add.at(formed[k], chans, 1)
        loads = [sum(pl.costs[a:b_]) for a, b_ in zip(pl.runs[b][:-1], pl.runs[b][1:])]
        costs = pl.costs[pl.runs[b][0]:pl.runs[b][-1]]
        assert max(loads) <= 4 / 3 * max(sum(costs) / bd.EDGE_WARPS, max(costs))
        if layer == "sevennet0":
            assert max(loads) <= 1.15 * sum(costs) / bd.EDGE_WARPS
    assert all(np.all(f == 1) for f in formed.values()), formed
    assert nblk == len(pl.runs)
    if layer == "sevennet0" and vw == 4:
        widest = {}
        for k, _, _, v in pl.tasks:
            widest[instr[k]["mul"]] = max(v, widest.get(instr[k]["mul"], 0))
        assert widest == {128: 4, 64: 2, 32: 1}


@pytest.mark.parametrize("mapping", EDGE_MAPS)
@pytest.mark.parametrize("layer", EDGE_LAYERS)
def test_edge_walk_gives_the_plain_messages(layer, mapping):
    """A numpy walk of the per-edge product in the kernel's order
    (edge_walk: each task's lanes, xw = x w once per m, fmaf from
    zero over the pairs in the table's (m, p) order) on the plain version's
    w and tmp gives terms_plain's messages of every (instruction, p) within
    fp32 rounding (the plain sums rounded products), zeros for a p with no
    pair, and forms every (instruction, channel) once."""
    op, vw = _edge_op(layer), EDGE_MAPS[mapping]
    rng = np.random.default_rng(len(layer) + vw)
    n = 40
    xg = rng.normal(size=(n, op.dim_x)).astype(np.float32) * 0.5
    emb = rng.normal(size=(n, op.n_basis)).astype(np.float32) * 0.3
    sh = rng.normal(size=(n, op.dim_f)).astype(np.float32) * 0.5
    ws = [rng.normal(size=(a, b)).astype(np.float32)
          for a, b in zip(op.mlp_spec.dims[:-1], op.mlp_spec.dims[1:])]
    h = bd.mlp_plain(torch.tensor(emb), [torch.tensor(w) for w in ws])
    tmp = torch.tensor(sh) @ torch.tensor(op.w3j_pack).t()
    msgs, formed = edge_walk(op, bd.edge_plan(op, vw), xg, h.numpy(), tmp.numpy())
    assert all(np.all(f == 1) for f in formed.values())
    for k, ins in enumerate(fc._instr_tables(op.conv)[0]):
        by_p = bd.terms_plain(ins, torch.tensor(xg), h, tmp)
        for p in range(ins["d3"]):
            got = msgs[(k, p)]
            if p not in by_p:
                assert not got.any()
                continue
            want = by_p[p].numpy()
            scale = sum(np.abs(xg[:, ins["x_start"] + m * ins["mul"]:][:, :ins["mul"]]
                               * h.numpy()[:, ins["w_start"]:ins["w_start"] + ins["mul"]]
                               * np.abs(tmp.numpy()[:, r:r + 1])) for m, q, r in ins["mp"] if q == p)
            # at most d1 roundings in the kernel's chain, 2 d1 - 1 in plain's
            assert np.all(np.abs(got - want) <= 3 * ins["d1"] * 2.0 ** -24 * scale), (k, p)


def test_edge_plan_refuses_paths_it_is_not_compiled_for():
    """An instruction of l 3 is not a path the per-edge product is compiled
    for (fold_conv.path_list): the plan raises, so the wrapper does before
    a launch."""
    x3 = Irreps("8x0e+4x1e+2x2e+2x3e")
    f3 = Irreps.spherical_harmonics(3, 1)
    conv3 = ConvTPSpec(x3, f3, infer_irreps_out(x3, f3, 3, "full"))
    op3 = fc.conv_op(conv3, ScalarMLPSpec((8, 16, 16, conv3.weight_numel)))
    with pytest.raises(ValueError, match="l <= 2"):
        bd.edge_plan(op3, 4)


def test_edge_lane_widths_are_the_kernels():
    """The lane widths the wrappers ask for (breakdown.EDGE_VW,
    knockout.EDGE_VW) are those the kernel instantiates for the variant's K
    sum (csrc/probe_breakdown.cuh:edge_path): 1, 2 or 4 channels a lane, at
    most 2 under the 0/1 sum and the halving chain, 0 (feature-major) for the
    feat variants; and every variant with the per-edge product has one."""
    from sevennet_tpu_torch.probes import knockout as ko

    ksum = {v: bd._KSUM.get(v) for v in bd.EDGE_VW}
    for v, vw in bd.EDGE_VW.items():
        if v.startswith("feat"):
            assert vw == 0, v
        elif ksum[v] in ("mm", "kred"):
            assert vw in (1, 2), v
        else:
            assert vw in (1, 2, 4), v
    assert set(bd.EDGE_VW) == {"tp", "tpred", "tpredk", "storek", "fullk", "tpredmm",
                               "tpredmm_amaj", "fullmm", "feat_full", "featroll_full"}
    assert set(ko.EDGE_VW) == {"nofold"} and ko.EDGE_VW["nofold"] in (1, 2, 4)
