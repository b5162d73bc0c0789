"""The launch plans of the matmul-rate probe's 3xTF32 kernel and of the
column gather, walked in numpy as the kernels index their work, and the
3xTF32 split with A split for every product emulated in numpy against
float64. CPU only: the kernels themselves are held against their plain
versions on the card (``tests/test_torch_kernels.py``, ``gpu``).
"""

import numpy as np
import pytest

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
    512 shapes split k to run 128 CTAs instead of 64."""
    assert mr.mm_plan(1024, 64, 960) == mr.MmPlan(2, 1, 120)
    assert mr.mm_plan(1024, 64, 960, carry=True) == mr.MmPlan(2, 1, 120)
    assert mr.mm_plan(480, 512, 1024) == mr.MmPlan(1, 2, 128)
    assert mr.mm_plan(1024, 512, 480) == mr.MmPlan(1, 2, 128)
    assert mr.mm_ctas(1024, 64, 960, "3xtf32") == 120
    assert mr.mm_ctas(1024, 64, 960, "tf32") == mr.mm_tiles(1024, 960) == 480


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
