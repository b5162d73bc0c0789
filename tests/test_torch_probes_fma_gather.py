"""The FMA-rate and gather probes' plain versions
(``sevennet_tpu_torch/probes/fma_rate.py``, ``probes/gather.py``) against the
TPU probe kernels they port, and their wrappers' checks.

The TPU kernels live in scripts that time them on a TPU when imported
(their module-level ``report(...)`` and ``timed()`` lines), so their kernel
bodies and calls are quoted here, each with its file and lines, and run
through ``pl.pallas_call(..., interpret=True)`` on the CPU at small shapes:
the FMA chains at T 64, mul 8 and 16, R 133, REP 4, both layouts; the
elementwise chain on a grid of 2 blocks of (8, 128), ITERS 64; the row
gather at N 64, D 24, T 32 in 3 blocks; the lane and sublane gathers at W
16, DX 8, T 32. The same inputs, made with numpy from a seed, go through
both. Limits: the chains within 1e-5 of the largest reference value
(``fma_rate.TOL``: float32 on both sides, multiply-adds contracted or not);
the gathers exactly (a gather copies bits). The CUDA kernels are held
against these plain versions on the card (tests/test_torch_kernels.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sevennet_tpu_torch.probes import fma_rate as fr
from sevennet_tpu_torch.probes import gather as ga

torch.set_num_threads(1)
T_FMA, REP_FMA = 64, 4


def pallas_fma(feat_major, mul, xv, tv, T=T_FMA, REP=REP_FMA, R=133):
    """``scripts_dev/r2_pallas_fma.py:45-78`` (``fma``'s kernels and call; the
    timing loop's ``1e-30 * acc`` term is 0 in one call)."""
    if feat_major:
        def kernel(x_ref, t_ref, out_ref):
            xv = x_ref[:]
            def rep(i, acc):
                xi = xv + acc  # carry-dependent
                for r in range(R):
                    acc = acc + xi * t_ref[r % 8, :][None, :]
                return acc * 1e-8
            out_ref[:] = jax.lax.fori_loop(
                0, REP, rep, jnp.zeros((mul, T), jnp.float32))
        xshape, tshape = (mul, T), (8, T)
    else:
        def kernel(x_ref, t_ref, out_ref):
            xv = x_ref[:]
            def rep(i, acc):
                xi = xv + acc
                for r in range(R):
                    acc = acc + xi * t_ref[:, r % 8][:, None]
                return acc * 1e-8
            out_ref[:] = jax.lax.fori_loop(
                0, REP, rep, jnp.zeros((T, mul), jnp.float32))
        xshape, tshape = (T, mul), (T, 8)

    x = jnp.asarray(xv, jnp.float32)
    tm = jnp.asarray(tv, jnp.float32)
    assert x.shape == xshape and tm.shape == tshape
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(xshape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(x, tm)


def pallas_fma_probe(feat_major, MUL, xv, tv, T=T_FMA, R=133):
    """``scripts_dev/r2_pallas_caps.py:103-133`` (``fma_probe``'s kernels and
    call)."""
    if feat_major:
        def kernel(x_ref, t_ref, out_ref):
            acc = jnp.zeros((MUL, T), jnp.float32)
            xv = x_ref[:]
            for r in range(R):
                row = t_ref[r % 8, :][None, :]
                acc = acc + xv * row
            out_ref[:] = acc
        xshape = (MUL, T)
    else:
        def kernel(x_ref, t_ref, out_ref):
            acc = jnp.zeros((T, MUL), jnp.float32)
            xv = x_ref[:]
            for r in range(R):
                col = t_ref[:, r % 8][:, None]
                acc = acc + xv * col
            out_ref[:] = acc
        xshape = (T, MUL)

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(xshape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(xv), jnp.asarray(tv))


def pallas_vpu(a, b, ROWS=8, COLS=128, NB=2, ITERS=64):
    """``scripts_dev/r4_vpu_roofline.py:18-38`` (the module's kernel and
    call)."""
    def kernel(a_ref, b_ref, o_ref):
        a = a_ref[:]
        b = b_ref[:]
        acc = jnp.zeros_like(a)
        for i in range(ITERS):
            acc = acc + a * b        # 2 ops/elem
            a = a + 1e-9             # prevent CSE
        o_ref[:] = acc

    f = pl.pallas_call(
        kernel,
        grid=(NB,),
        in_specs=[
            pl.BlockSpec((ROWS, COLS), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((ROWS, COLS), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((ROWS, COLS), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NB * ROWS, COLS), jnp.float32),
        interpret=True,
    )
    return f(jnp.asarray(a), jnp.asarray(b))


def pallas_take(x, idx, N=64, D=24, T=32, NB=3):
    """``scripts_dev/r3_gather_probe.py:23-38`` (``make_take``)."""
    def kernel(x_ref, idx_ref, out_ref):
        rows = jnp.take(x_ref[:], idx_ref[:], axis=0)
        out_ref[:] = rows
    return pl.pallas_call(
        kernel,
        grid=(NB,),
        in_specs=[
            pl.BlockSpec((N, D), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T,), lambda i: (i,), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((T, D), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NB * T, D), jnp.float32),
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=120*1024*1024),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(idx))


def p1_kernel(DX, T):
    """``scripts_dev/r2_pallas_caps.py:49-51`` (``p1``'s kernel)."""
    def kernel(tbl_ref, idx_ref, out_ref):
        idx = jnp.broadcast_to(idx_ref[0:1, :], (DX, T))
        out_ref[:] = jnp.take_along_axis(tbl_ref[:], idx, axis=1)
    return kernel


def pallas_p1(tbl, idx, DX=8, T=32):
    """``scripts_dev/r2_pallas_caps.py:55-61`` (``p1``'s call)."""
    return pl.pallas_call(
        p1_kernel(DX, T),
        out_shape=jax.ShapeDtypeStruct((DX, T), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(tbl), jnp.asarray(idx))


def pallas_p1_loop(tbl, idx, n, DX=8, T=32):
    """``scripts_dev/r2_pallas_caps.py:66-77`` (``p1``'s timed loop: the call
    n times, each on ``tbl + 1e-30 * acc``), returning each call's output."""
    kernel = p1_kernel(DX, T)

    def loop(tbl, idx, n):
        def body(acc, _):
            o = pl.pallas_call(
                kernel,
                out_shape=jax.ShapeDtypeStruct((DX, T), jnp.float32),
                in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                          pl.BlockSpec(memory_space=pltpu.VMEM)],
                out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                interpret=True,
            )(tbl + 1e-30 * acc, idx)
            return acc + o[0, 0] * 1e-30, o
        acc, outs = jax.lax.scan(body, jnp.float32(0), None, length=n)
        return outs
    return loop(jnp.asarray(tbl), jnp.asarray(idx), n)


def pallas_p2(tbl, idx, DX=8, T=32):
    """``scripts_dev/r2_pallas_caps.py:85-97`` (``p2``'s kernel and call)."""
    def kernel(tbl_ref, idx_ref, out_ref):
        idx = jnp.broadcast_to(idx_ref[:, 0:1], (T, DX))
        out_ref[:] = jnp.take_along_axis(tbl_ref[:], idx, axis=0)

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((T, DX), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(tbl), jnp.asarray(idx))


def _close(got, want):
    want = np.asarray(want, np.float64)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=fr.TOL * np.abs(want).max())


def _fma_inputs(layout, mul, seed):
    rng = np.random.default_rng(seed)
    xs, ts = fr.fma_shapes(layout, mul, T_FMA)
    return rng.normal(size=xs).astype(np.float32), rng.normal(size=ts).astype(np.float32)


@pytest.mark.parametrize("mul", [8, 16])
@pytest.mark.parametrize("layout", fr.LAYOUTS)
def test_fma_chain_plain_matches_pallas(layout, mul):
    x, t = _fma_inputs(layout, mul, mul)
    got = fr.fma_chain(torch.tensor(x), torch.tensor(t), layout, rep=REP_FMA, plain=True)
    _close(got.numpy(), pallas_fma(layout == "feat", mul, x, t))
    # copies are independent copies of the same output
    copies = fr.fma_chain(torch.tensor(x), torch.tensor(t), layout, rep=REP_FMA, copies=2,
                          plain=True)
    assert copies.shape == (2, *x.shape) and torch.equal(copies[1], got)


@pytest.mark.parametrize("mul", [8, 16])
@pytest.mark.parametrize("layout", fr.LAYOUTS)
def test_fma_pass_plain_matches_pallas(layout, mul):
    x, t = _fma_inputs(layout, mul, 100 + mul)
    got = fr.fma_pass(torch.tensor(x), torch.tensor(t), layout, plain=True)
    _close(got.numpy(), pallas_fma_probe(layout == "feat", mul, x, t))


def test_vpu_chain_plain_matches_pallas():
    rng = np.random.default_rng(5)
    # some |a| below 2^-5, where a + 1e-9 moves a
    a = (rng.normal(size=(16, 128)) * np.where(rng.random((16, 128)) < 0.3, 1e-3, 1.0)
         ).astype(np.float32)
    b = rng.normal(size=(16, 128)).astype(np.float32)
    got = fr.vpu_chain(torch.tensor(a), torch.tensor(b), plain=True)
    want = pallas_vpu(a, b)
    _close(got.numpy(), want)
    # the bump is not a no-op: without it the sum is 64 a b
    assert not np.array_equal(np.asarray(want), np.float32(64) * a * b)
    flops, nbytes = fr.vpu_work(a.size)
    assert flops == 4 * a.size * fr.VPU_ITERS and nbytes == 12 * a.size


def test_gather_rows_plain_matches_pallas():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(64, 24)).astype(np.float32)
    idx = rng.integers(0, 64, size=(3 * 32,), dtype=np.int32)
    want = np.asarray(pallas_take(x, idx))
    assert np.array_equal(want, x[idx])
    for variant in ga.VARIANTS:
        got = ga.gather_rows(torch.tensor(x), torch.tensor(idx), variant=variant, plain=True)
        assert np.array_equal(got.numpy(), want)
    out = torch.empty(2, 96, 24)
    got = ga.gather_rows(torch.tensor(x), torch.tensor(idx), copies=2, out=out, plain=True)
    assert got is out and np.array_equal(out[1].numpy(), want)


def test_gather_cols_plain_matches_pallas():
    rng = np.random.default_rng(7)
    tbl = rng.normal(size=(8, 16)).astype(np.float32)
    idx = rng.integers(0, 16, size=(1, 32), dtype=np.int32)
    want = np.asarray(pallas_p1(tbl, idx))
    assert np.array_equal(want, tbl[:, idx[0]])
    got = ga.gather_cols(torch.tensor(tbl), torch.tensor(idx), plain=True)
    assert np.array_equal(got.numpy(), want)


def test_gather_cols_plain_matches_pallas_loop():
    """p1's timed loop (G2′): each of its calls gathers the same columns."""
    rng = np.random.default_rng(8)
    tbl = rng.normal(size=(8, 16)).astype(np.float32)
    idx = rng.integers(0, 16, size=(1, 32), dtype=np.int32)
    outs = np.asarray(pallas_p1_loop(tbl, idx, 3))
    got = ga.gather_cols(torch.tensor(tbl), torch.tensor(idx), copies=3, plain=True)
    assert outs.shape == tuple(got.shape) and np.array_equal(got.numpy(), outs)


def test_gather_rows_plain_matches_pallas_sublane():
    rng = np.random.default_rng(9)
    tbl = rng.normal(size=(16, 8)).astype(np.float32)
    idx = rng.integers(0, 16, size=(32, 1), dtype=np.int32)
    want = np.asarray(pallas_p2(tbl, idx))
    assert np.array_equal(want, tbl[idx[:, 0]])
    for variant in ga.VARIANTS:
        got = ga.gather_rows(torch.tensor(tbl), torch.tensor(idx), variant=variant, plain=True)
        assert np.array_equal(got.numpy(), want)


def test_fma_gather_wrappers_check_their_inputs():
    """The wrappers raise on CPU tensors unless told to run the plain
    version (which does not count as a launch), and refuse misshapen or
    mistyped inputs, unknown layouts and variants and indices out of
    range."""
    x, t = (torch.tensor(v) for v in _fma_inputs("feat", 8, 0))
    a = torch.zeros(8, 128)
    tbl, idx = torch.zeros(16, 8), torch.zeros(32, dtype=torch.int32)
    counts = (fr.fma_chain.launches, fr.fma_pass.launches, fr.vpu_chain.launches,
              ga.gather_rows.launches, ga.gather_cols.launches)
    for call in (lambda: fr.fma_chain(x, t), lambda: fr.fma_pass(x, t),
                 lambda: fr.vpu_chain(a, a), lambda: ga.gather_rows(tbl, idx),
                 lambda: ga.gather_cols(tbl, idx)):
        with pytest.raises(ValueError, match="plain=True"):
            call()
    with pytest.raises(ValueError, match="layout"):
        fr.fma_chain(x, t, "lane", plain=True)
    with pytest.raises(ValueError, match="takes t"):
        fr.fma_pass(x, t, "edge", plain=True)
    with pytest.raises(ValueError, match="float32"):
        fr.fma_chain(x.double(), t, plain=True)
    with pytest.raises(ValueError, match="multiple of 4"):
        fr.fma_pass(torch.zeros(8, 6), torch.zeros(8, 6), plain=True)
    with pytest.raises(ValueError, match="one shape"):
        fr.vpu_chain(a, a.T.contiguous(), plain=True)
    with pytest.raises(ValueError, match="variant"):
        ga.gather_rows(tbl, idx, variant="tma", plain=True)
    with pytest.raises(ValueError, match="int32"):
        ga.gather_rows(tbl, idx.long(), plain=True)
    with pytest.raises(ValueError, match=r"idx in \[0, 16\)"):
        ga.gather_rows(tbl, idx + 16, plain=True)
    with pytest.raises(ValueError, match=r"idx in \[0, 8\)"):
        ga.gather_cols(tbl, idx + 8, plain=True)
    with pytest.raises(ValueError, match="out"):
        ga.gather_cols(tbl, idx, out=torch.empty(32, 16), plain=True)
    with pytest.raises(ValueError, match="multiple of 4"):
        ga.gather_rows(torch.zeros(16, 6), idx, plain=True)
    assert (fr.fma_chain.launches, fr.fma_pass.launches, fr.vpu_chain.launches,
            ga.gather_rows.launches, ga.gather_cols.launches) == counts


def test_probe_work_counts():
    """The operation and byte counts the bounds divide by, at the TPU
    scripts' shapes: 557.8 and 17.4 MFLOP for the chains, 1.407 GB for the
    row gather, 2.95 MB for the small gathers."""
    assert fr.fma_flops(128, rep=fr.REP) == 128 * 1024 * 133 * 16 * 2 == 557_842_432
    assert fr.fma_flops(fr.PASS_MUL) == 17_432_576
    assert fr.fma_bytes(64) == 4 * (2 * 64 * 1024 + 8 * 1024)
    n, d, t = ga.ROWS_SHAPE
    x, idx = torch.empty(n, d), torch.empty(t, dtype=torch.int32)
    assert ga.gather_bytes(x, idx, 0) == 4 * (n * d + t + t * d)
    assert abs(ga.gather_bytes(x, idx, 0) / 1e9 - 1.407) < 1e-3
    dx, w, t = ga.TABLE_SHAPE
    tbl, idx = torch.empty(dx, w), torch.empty(1, t, dtype=torch.int32)
    assert ga.gather_bytes(tbl, idx, 1) == ga.gather_bytes(tbl.T, idx.T, 0) == 4 * (
        dx * w + t + dx * t)
    assert ga.gather_bytes(tbl, idx, 1, copies=2) == 4 * (dx * w + t + 2 * dx * t)
