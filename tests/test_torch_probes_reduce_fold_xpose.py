"""The K-reduction, fold and transpose probes' plain versions
(``sevennet_tpu_torch/probes/reduce.py``, ``probes/xpose.py``,
``probes/fold.py``, ``probes/fold_conv.py``) against the TPU probe kernels
they port, and their wrappers' checks.

The TPU kernels live in scripts that time them on a TPU when imported
(module-level ``report(...)`` and loops; ``r4_fold_probe.py:45-49`` makes a
1.4 GB input at import, ``r5_xpose_probe.py`` runs the fused kernels), so
their kernel bodies and calls are quoted here, each with its file and
lines, and run through ``pl.pallas_call(..., interpret=True)`` on the CPU at
small shapes: the reductions at K 8 and 16; the transposes on 64 x 48
arrays, the streamed ones in 2 blocks of 32 rows; the fold at K 9 (an odd
count, peeled) and 8, A 16, in 2 blocks, tiles of 12, 8 and 4 rows; the
conv fold on ``8x0e+4x1e+2x2e`` against lmax-2 harmonics at K 24 (group4
and group8 both divide it), A 4, 2 blocks, the TPU's k-major rows permuted
to the port's receiver-major ones. The same inputs, made with numpy from a
seed, go through both. Limits: sums within 1e-5 of the largest reference
value (float32 on both sides, another order; the bf16 pieces of mxu2/mxu3
are the same on both sides), the conv fold 1e-4 (the conv's limit), the
streamed transposes exactly (a transpose copies bits), the carried one
within 1e-6. The CUDA kernels are held against these plain versions on the
card (tests/test_torch_kernels.py, chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sevennet_tpu.irreps import Irreps as JIrreps
from sevennet_tpu.irreps import infer_irreps_out as j_infer
from sevennet_tpu.ops.activations import NORMALIZE2MOM_CST as J_CST
from sevennet_tpu.ops.fused_conv import _DOT
from sevennet_tpu.ops.fused_conv import _instr_tables as j_instr_tables
from sevennet_tpu.ops.tensor_product import ConvTPSpec as JConvTPSpec
from sevennet_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_tpu_torch.probes import fold as fo
from sevennet_tpu_torch.probes import fold_conv as fcv
from sevennet_tpu_torch.probes import reduce as rd
from sevennet_tpu_torch.probes import xpose as xp
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec

torch.set_num_threads(1)
REP = 16


def _vmem_call(kernel, out_shape, n_in, n_smem=0):
    """A one-block pallas_call with ``n_in`` VMEM inputs and ``n_smem`` (1,
    1) SMEM scalars after them, as the r2 scripts call their kernels."""
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * n_in
        + [pl.BlockSpec((1, 1), memory_space=pltpu.SMEM)] * n_smem,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )


def pallas_kreduce(x, A):
    """``scripts_dev/r2_pallas_fma.py:84-99`` (``kreduce``'s kernel and call;
    the timing loop's ``1e-30 * acc`` term is 0 in one call)."""
    T, mul = x.shape
    K = T // A
    def kernel(x_ref, out_ref):
        xv = x_ref[:]
        def rep(i, acc):
            xi = xv + acc[0, 0]
            return acc + xi.reshape(A, K, mul).sum(axis=1) * 1e-8
        out_ref[:] = jax.lax.fori_loop(
            0, REP, rep, jnp.zeros((A, mul), jnp.float32))
    return _vmem_call(kernel, (A, mul), 1)(jnp.asarray(x))


def pallas_lanereduce(a, s, A):
    """``scripts_dev/r2_pallas_mm.py:87-104`` (``lanereduce``)."""
    rows, T = a.shape
    K = T // A
    def kernel(a_ref, s_ref, out_ref):
        def body(i, acc):
            ai = a_ref[:] * (1.0 + s_ref[0, 0] * i.astype(jnp.float32))
            return acc * 0.5 + ai.reshape(rows, A, K).sum(axis=2)
        out_ref[:] = jax.lax.fori_loop(
            0, REP, body, jnp.zeros((rows, A), jnp.float32))
    return _vmem_call(kernel, (rows, A), 1, 1)(jnp.asarray(a), jnp.asarray(s))


def pallas_subreduce(a, s, A):
    """``scripts_dev/r2_pallas_mm.py:109-126`` (``subreduce``)."""
    T, mul = a.shape
    K = T // A
    def kernel(a_ref, s_ref, out_ref):
        def body(i, acc):
            ai = a_ref[:] * (1.0 + s_ref[0, 0] * i.astype(jnp.float32))
            return acc * 0.5 + ai.reshape(A, K, mul).sum(axis=1)
        out_ref[:] = jax.lax.fori_loop(
            0, REP, body, jnp.zeros((A, mul), jnp.float32))
    return _vmem_call(kernel, (A, mul), 1, 1)(jnp.asarray(a), jnp.asarray(s))


def pallas_transpose(a, s):
    """``scripts_dev/r2_pallas_mm.py:67-82`` (``transpose``)."""
    m, n = a.shape
    def kernel(a_ref, s_ref, out_ref):
        def body(i, acc):
            ai = a_ref[:] * (1.0 + s_ref[0, 0] * i.astype(jnp.float32))
            return acc * 0.5 + ai.T
        out_ref[:] = jax.lax.fori_loop(
            0, REP, body, jnp.zeros((n, m), jnp.float32))
    return _vmem_call(kernel, (n, m), 1, 1)(jnp.asarray(a), jnp.asarray(s))


def pallas_xpose(arr, T_b):
    """``scripts_dev/r5_xpose_probe.py:90-104`` (``xpose``)."""
    NK, dim_x = arr.shape
    NB = NK // T_b
    def xpose_kernel(in_ref, out_ref):
        out_ref[:] = in_ref[:].T
    return pl.pallas_call(
        xpose_kernel,
        grid=(NB,),
        in_specs=[pl.BlockSpec((T_b, dim_x), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((dim_x, T_b), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((dim_x, NK), jnp.float32),
        interpret=True,
    )(jnp.asarray(arr))


def pallas_xpose2(arr, T_b):
    """``scripts_dev/r5_xpose_probe.py:107-122`` (``xpose2``)."""
    NK, dim_x = arr.shape
    NB = NK // T_b
    def k2(in_ref, out_ref):
        out_ref[:] = in_ref[:].T.T
    return pl.pallas_call(
        k2,
        grid=(NB,),
        in_specs=[pl.BlockSpec((T_b, dim_x), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((T_b, dim_x), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NK, dim_x), jnp.float32),
        interpret=True,
    )(jnp.asarray(arr))


def pallas_fold(x, variant, K, A, MULS):
    """``scripts_dev/r3_fold_probe.py:30-96`` (``make``'s kernel and call)
    for blocks of T = A K rows, DM = sum(MULS), without the
    ``vmem_limit_bytes`` of the TPU run."""
    T = A * K
    DM = sum(MULS)
    NB = x.shape[0] // T
    fold_np = np.zeros((T, A), np.float32)
    fold_np[np.arange(T), np.arange(T) % A] = 1.0
    fold_c = jnp.asarray(fold_np)
    DOT = dict(preferred_element_type=jnp.float32)

    def _kfold(acc):
        kcur = K
        while kcur > 1:
            w = kcur * A
            if kcur % 2 == 0:
                half = (kcur // 2) * A
                acc = acc[:, :half] + pltpu.roll(acc, w - half, 1)[:, :half]
                kcur //= 2
            else:
                head = acc[:, : (kcur - 1) * A]
                tail = pltpu.roll(acc, A, 1)[:, :A]
                acc = head + jnp.pad(tail, ((0, 0), (0, (kcur - 2) * A)))
                kcur -= 1
        return acc

    def kernel(in_ref, f_ref, out_ref, scr):
        base = in_ref[:].T  # (DM/8, T)
        start = 0
        for mul in MULS:
            # build a (mul, T) tile from the input (cheap repeat)
            tile = base[(start // 8) % (DM // 8) : , :][:mul, :]
            if tile.shape[0] < mul:
                tile = jnp.concatenate(
                    [tile, base[: mul - tile.shape[0], :]], 0
                )
            if variant == "roll":
                scr[start : start + mul, :] = _kfold(tile)
            elif variant == "mxu2":
                hi = tile.astype(jnp.bfloat16)
                lo = (tile - hi.astype(jnp.float32)).astype(jnp.bfloat16)
                r = jnp.dot(hi, f_ref[:].astype(jnp.bfloat16), **DOT) + \
                    jnp.dot(lo, f_ref[:].astype(jnp.bfloat16), **DOT)
                scr[start : start + mul, :] = r
            elif variant == "mxu3":
                a1 = tile.astype(jnp.bfloat16)
                r1 = tile - a1.astype(jnp.float32)
                a2 = r1.astype(jnp.bfloat16)
                a3 = (r1 - a2.astype(jnp.float32)).astype(jnp.bfloat16)
                fb = f_ref[:].astype(jnp.bfloat16)
                r = (jnp.dot(a1, fb, **DOT) + jnp.dot(a2, fb, **DOT)
                     + jnp.dot(a3, fb, **DOT))
                scr[start : start + mul, :] = r
            start += mul
        if variant == "bigroll":
            scr[:, :] = _kfold(
                jnp.concatenate([base] * 8, 0)
            )
        out_ref[:] = scr[:].T

    f = pl.pallas_call(
        kernel,
        grid=(NB,),
        in_specs=[
            pl.BlockSpec((T, DM // 8), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((T, A), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((A, DM), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NB * A, DM), jnp.float32),
        scratch_shapes=[pltpu.VMEM((DM, A), jnp.float32)],
        interpret=True,
    )
    return f(jnp.asarray(x), fold_c), fold_np


def _fold_sliceadd(acc, kcur, a):
    """``scripts_dev/r4_fold_probe.py:52-65``."""
    while kcur > 1:
        if kcur % 2 == 0:
            half = (kcur // 2) * a
            acc = acc[:, :half] + acc[:, half : 2 * half]
            kcur //= 2
        else:
            head = acc[:, : (kcur - 1) * a]
            tail = acc[:, (kcur - 1) * a :]
            acc = head + jnp.pad(tail, ((0, 0), (0, (kcur - 2) * a)))
            kcur -= 1
    return acc


def pallas_fold_conv(variant, conv, mlp_dims, N, K, A, xg, emb, sh, mlp_ws, w3j_pack_np):
    """``scripts_dev/r4_fold_probe.py:68-164`` (``make``'s kernel and call for
    the three fold variants), without the ``vmem_limit_bytes`` of the TPU
    run; inputs in the TPU's k-major rows."""
    T = A * K
    instr, _, dim_mid, numel = j_instr_tables(conv)
    dim_x, dim_f, n_basis = conv.irreps_x.dim, conv.irreps_filter.dim, mlp_dims[0]
    R = w3j_pack_np.shape[0]
    cst = J_CST["silu"]
    n_mlp = len(mlp_dims) - 1
    inv_sqrt = [1.0 / math.sqrt(d) for d in mlp_dims[:-1]]
    NB = N * K // T

    def kernel(xg_ref, emb_ref, sh_ref, *rest):
        mlp_refs = rest[:n_mlp]
        w3j_ref = rest[n_mlp]
        out_ref = rest[n_mlp + 1]
        scr = rest[n_mlp + 2]
        xgT = xg_ref[:].T
        embT = emb_ref[:].T
        shT = sh_ref[:].T
        h = embT
        for li, wref in enumerate(mlp_refs):
            h = jnp.dot(wref[:].T, h, **_DOT) * inv_sqrt[li]
            if li < n_mlp - 1:
                h = jax.nn.silu(h) * cst
        tmp = jnp.dot(w3j_ref[:], shT, **_DOT)

        if variant == "sliceadd":
            for ins in instr:
                d1, d3, mul = ins["d1"], ins["d3"], ins["mul"]
                x0, w0 = ins["x_start"], ins["w_start"]
                wb = h[w0 : w0 + mul, :]
                xw = [
                    xgT[x0 + m * mul : x0 + (m + 1) * mul, :] * wb
                    for m in range(d1)
                ]
                by_p = {}
                for m, p, r in ins["mp"]:
                    term = xw[m] * tmp[r : r + 1, :]
                    by_p[p] = term if p not in by_p else by_p[p] + term
                g0, u_off, u_tot = ins["g_start"], ins["u_off"], ins["u_tot"]
                for p in range(d3):
                    start = g0 + p * u_tot + u_off
                    if p in by_p:
                        scr[start : start + mul, :] = _fold_sliceadd(
                            by_p[p], K, A
                        )
                    else:
                        scr[start : start + mul, :] = jnp.zeros(
                            (mul, A), jnp.float32
                        )
        else:
            kg = 4 if variant == "group4" else 8
            ngroups = K // kg
            gw = kg * A
            for ins in instr:
                d1, d3, mul = ins["d1"], ins["d3"], ins["mul"]
                x0, w0 = ins["x_start"], ins["w_start"]
                g0, u_off, u_tot = ins["g_start"], ins["u_off"], ins["u_tot"]
                by_p = {}
                for g in range(ngroups):
                    lo = g * gw
                    wb = h[w0 : w0 + mul, lo : lo + gw]
                    xw = [
                        xgT[x0 + m * mul : x0 + (m + 1) * mul, lo : lo + gw]
                        * wb
                        for m in range(d1)
                    ]
                    for m, p, r in ins["mp"]:
                        term = xw[m] * tmp[r : r + 1, lo : lo + gw]
                        by_p[p] = term if p not in by_p else by_p[p] + term
                for p in range(d3):
                    start = g0 + p * u_tot + u_off
                    if p in by_p:
                        scr[start : start + mul, :] = _fold_sliceadd(
                            by_p[p], kg, A
                        )
                    else:
                        scr[start : start + mul, :] = jnp.zeros(
                            (mul, A), jnp.float32
                        )
        out_ref[:] = scr[:].T

    in_specs = [
        pl.BlockSpec((T, dim_x), lambda i: (i, 0), memory_space=pltpu.VMEM),
        pl.BlockSpec((T, n_basis), lambda i: (i, 0), memory_space=pltpu.VMEM),
        pl.BlockSpec((T, dim_f), lambda i: (i, 0), memory_space=pltpu.VMEM),
    ] + [
        pl.BlockSpec(w.shape, lambda i: (0, 0), memory_space=pltpu.VMEM)
        for w in mlp_ws
    ] + [
        pl.BlockSpec((R, dim_f), lambda i: (0, 0), memory_space=pltpu.VMEM),
    ]
    f = pl.pallas_call(
        kernel,
        grid=(NB,),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((A, dim_mid), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NB * A, dim_mid), jnp.float32),
        scratch_shapes=[pltpu.VMEM((dim_mid, A), jnp.float32)],
        interpret=True,
    )
    return f(jnp.asarray(xg), jnp.asarray(emb), jnp.asarray(sh), *map(jnp.asarray, mlp_ws),
             jnp.asarray(w3j_pack_np))


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * np.abs(want).max())


def _rng_f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


S_VAL = np.full((1, 1), 1e-3, np.float32)  # s != 0, so that the (1 + s i) factor is checked


def kreduce_input(rng, K, mul):
    """x for kreduce whose carry shows: group 0's column 0 at 1e8, so that
    acc[0, 0] grows by about K a rep and K acc[0, 0] outweighs the other
    columns' own sums."""
    x = _rng_f32(rng, rd.A * K, mul)
    x[:K, 0] = 1e8
    return x


@pytest.mark.parametrize("K", [8, 16])
def test_kreduce_plain_matches_pallas(K):
    rng = np.random.default_rng(K)
    x = kreduce_input(rng, K, 24)
    want = np.asarray(pallas_kreduce(x, rd.A))
    got = rd.kreduce(torch.tensor(x), plain=True).numpy()
    _close(got, want, rd.TOL)
    _close(got[:, 1:], want[:, 1:], rd.TOL)  # the columns that only the carry moves far
    no_carry = x.reshape(rd.A, K, 24).astype(np.float64).sum(1) * 1e-8 * REP
    assert np.abs(want[:, 1:] - no_carry[:, 1:]).max() > 10 * np.abs(no_carry[:, 1:]).max()


@pytest.mark.parametrize("K", [8, 16])
def test_subreduce_plain_matches_pallas(K):
    rng = np.random.default_rng(10 + K)
    a = _rng_f32(rng, rd.A * K, 20)
    got = rd.subreduce(torch.tensor(a), torch.tensor(S_VAL), plain=True)
    _close(got.numpy(), pallas_subreduce(a, S_VAL, rd.A), rd.TOL)


@pytest.mark.parametrize("K", [8, 16])
def test_lanereduce_plain_matches_pallas(K):
    rng = np.random.default_rng(20 + K)
    a = _rng_f32(rng, 12, rd.A * K)
    got = rd.lanereduce(torch.tensor(a), torch.tensor(S_VAL), plain=True)
    _close(got.numpy(), pallas_lanereduce(a, S_VAL, rd.A), rd.TOL)


def test_transpose_carry_plain_matches_pallas():
    rng = np.random.default_rng(30)
    a = _rng_f32(rng, 64, 48)
    for variant in xp.VARIANTS:
        got = xp.transpose_carry(torch.tensor(a), torch.tensor(S_VAL), variant, plain=True)
        _close(got.numpy(), pallas_transpose(a, S_VAL), xp.CARRY_TOL)


@pytest.mark.parametrize("which", ["xpose", "xpose2"])
def test_stream_xpose_plain_matches_pallas(which):
    rng = np.random.default_rng(31)
    x = _rng_f32(rng, 64, 48)
    want = np.asarray((pallas_xpose if which == "xpose" else pallas_xpose2)(x, 32))
    assert np.array_equal(want, x.T if which == "xpose" else x)
    fn = xp.xpose if which == "xpose" else xp.xpose2
    for variant in xp.VARIANTS:
        got = fn(torch.tensor(x), variant, plain=True)
        assert np.array_equal(got.numpy(), want)
        out = torch.full(want.shape, float("nan"))
        assert fn(torch.tensor(x), variant, out=out, plain=True) is out
        assert np.array_equal(out.numpy(), want)


FOLD_A = 16
# DM 96, DX 12: tiles no wider than DX, as the script's; the later ones wrap
FOLD_MULS = (12, 12, 8, 8, 8, 8, 8, 8, 4, 4, 4, 4, 4, 4)


@pytest.mark.parametrize("K", [9, 8])
@pytest.mark.parametrize("variant", fo.VARIANTS)
def test_fold_plain_matches_pallas(variant, K):
    rng = np.random.default_rng(40 + K)
    dx = sum(FOLD_MULS) // 8
    x = _rng_f32(rng, 2 * FOLD_A * K, dx, scale=0.5)
    want, fold_np = pallas_fold(x, variant, K, FOLD_A, FOLD_MULS)
    assert np.array_equal(fo.fold_matrix(K, FOLD_A).numpy(), fold_np)
    got = fo.fold(torch.tensor(x), torch.tensor(fold_np), K, FOLD_A, variant, FOLD_MULS,
                  plain=True)
    _close(got.numpy(), want, fo.TOL)
    if variant == "roll":  # the script's halving order, the same float32 adds
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fold_column_maps():
    """The tile map wraps around DX as the script's concatenation does, and
    bigroll's differs from it; both cover every input column."""
    tile, big = fo.column_map("roll", FOLD_MULS), fo.column_map("bigroll", FOLD_MULS)
    assert np.array_equal(tile, fo.column_map("mxu3", FOLD_MULS))
    assert list(tile[:24]) == list(range(12)) + list(range(1, 12)) + [0]
    assert list(tile[-4:]) == [11, 0, 1, 2]
    assert list(big) == [r % 12 for r in range(96)] and not np.array_equal(tile, big)
    full = fo.column_map("roll")
    assert full.shape == (fo.DM,) and set(full.tolist()) == set(range(fo.DM // 8))


# (DX, DM, A) the mxu kernel's plan is held to: the script's, the card
# tests' ragged shapes, a DM past one cluster's span, the widest DX that
# still fits two stages
MMA_SHAPES = ((392, 3136, 32), (12, 96, 16), (100, 800, 16), (100, 800, 32), (48, 384, 32),
              (4, 32, 16), (1764, 14112, 32), (500, 4000, 16))


@pytest.mark.parametrize("dx,dm,a", MMA_SHAPES)
def test_mma_plan_matches_its_statement(dx, dm, a):
    """mma_plan against a numpy statement of the mxu kernel's plan: every
    m64 tile of DM in exactly one CTA, at most MMA_TPW a CTA, whole clusters
    of at most MMA_CLMAX CTAs and none fewer than the tiles need; boxes of
    4 mod 8 columns, at most MMA_BOXW, that cover DX with no box to spare;
    the deepest even ring that fits the shared memory."""
    plan = fo.mma_plan(dx, dm, a)
    tiles = int(np.ceil(dm / 64))
    assert plan.tiles == tiles
    owner = np.concatenate([np.full(len(plan.cta_tiles(q)), q) for q in range(plan.ctas)])
    got = np.concatenate([np.asarray(plan.cta_tiles(q)) for q in range(plan.ctas)])
    assert np.array_equal(got, np.arange(tiles))
    assert np.bincount(owner, minlength=plan.ctas).max() <= fo.MMA_TPW
    assert 1 <= plan.cl <= fo.MMA_CLMAX and plan.ctas % plan.cl == 0
    assert plan.cl == fo.MMA_CLMAX or (plan.cl - 1) * fo.MMA_TPW < tiles
    assert (plan.ctas // plan.cl - 1) * plan.cl * fo.MMA_TPW < tiles
    assert plan.W % 8 == 4 and plan.W <= fo.MMA_BOXW
    assert plan.nbox * plan.W >= dx > (plan.nbox - 1) * plan.W
    assert plan.W - 8 < -(-dx // plan.nbox)

    def smem(ns):  # the ring (x and twice as many B stages) or the sums, then 2 ns barriers
        ring = ns * (plan.nbox * fo.MMA_R * plan.W * 4 + 2 * fo.MMA_BBYTES)
        return max(ring, fo.MMA_TPW * 16 * 128 * 4) + 16 * ns

    fits = [n for n in range(2, fo.MMA_NSMAX + 1, 2) if smem(n) <= fo.SMEM_LIMIT]
    assert plan.ns == (max(fits) if fits else 0)
    assert plan.smem == smem(max(plan.ns, 2))


@pytest.mark.parametrize("k,a,muls", [(72, 32, fo.MULS), (9, 16, (100,) * 8),
                                      (8, 32, (100,) * 8)])
def test_cancelling_input_needs_the_third_piece(k, a, muls):
    """cancelling_input: the plain mxu3 and roll folds are both the exact
    sum (float64) of x, and the plain mxu2 fold misses it by more than 10
    fold.TOL of max |plain|: a kernel without its third piece fails there."""
    dx = sum(muls) // 8
    x = fo.cancelling_input(3, k, a, dx, seed=5)
    fm = fo.fold_matrix(k, a)
    cmap = torch.as_tensor(fo.column_map("mxu3", muls, dx), dtype=torch.long)
    exact = x.double().view(3, k, a, dx).sum(1)[:, :, cmap].reshape(3 * a, -1)
    mxu3 = fo.fold_plain(x, fm, k, a, "mxu3", muls)
    assert torch.equal(mxu3.double(), exact)
    assert torch.equal(fo.fold_plain(x, fm, k, a, "roll", muls).double(), exact)
    gap = (fo.fold_plain(x, fm, k, a, "mxu2", muls) - mxu3).abs().max() / mxu3.abs().max()
    assert gap > 10 * fo.TOL
    # the kernel's order: slot by slot, each slot's pieces in turn, in fp32
    acc = torch.zeros(3, a, dx)
    for slot in range(k):
        for piece in fo._pieces(x.view(3, k, a, dx)[:, slot], 3):
            acc = acc + piece
    assert torch.equal(acc.double(), x.double().view(3, k, a, dx).sum(1))


def test_mma_pairs_matches_its_statement():
    """mma_pairs: every even output column 2i reads an even input column
    and column 2i + 1 the next one (the kernel's 8-byte loads); the
    script's map does, the card tests' maps with odd tile starts do not."""
    maps = {"script": fo.column_map("mxu2"), "test": fo.column_map("mxu2", FOLD_MULS),
            "paired": fo.column_map("mxu3", (64,) * 12 + (32,)),
            "wide": fo.column_map("mxu3", (100,) * 8), "bigroll": fo.column_map("bigroll")}
    want = {name: all(m[c] % 2 == 0 and m[c + 1] == m[c] + 1 for c in range(0, len(m), 2))
            for name, m in maps.items()}
    assert want == {"script": True, "test": False, "paired": True, "wide": False,
                    "bigroll": True}
    assert {name: fo.mma_pairs(m) for name, m in maps.items()} == want


# (tiles of mul rows, DX) the roll kernel's plan is held to: the script's,
# the card's ragged ones (DX 100: a partial last slice; the first map's runs
# off the 4-column grid), the card tests' odd tiles
ROLL_MAPS = ((fo.MULS, 392), ((100,) * 8, 100), ((64,) * 12 + (32,), 100), (FOLD_MULS, 12))


@pytest.mark.parametrize("k", fo.FOLD_KS)
@pytest.mark.parametrize("muls,dx", ROLL_MAPS, ids=["script", "wide", "paired", "odd"])
@pytest.mark.parametrize("variant", ["roll", "bigroll"])
def test_roll_plan_covers_every_output_column_once(variant, muls, dx, k):
    """roll_plan against a numpy statement of the roll kernel's plan: its
    units, expanded to their columns (4 from each when vec, else 1), cover
    every output column exactly once; each reads the map's input columns,
    inside its own slice (slices of ROLL_SW columns, the last narrower);
    vec exactly when every aligned run of 4 output columns reads an aligned
    run of 4 input columns; within a slice the input columns ascend; the
    deepest ring up to ROLL_NSMAX stages of K x ROLL_SW floats (each
    rounded up to 128 bytes, a TMA box's alignment) that fits the shared
    memory, at least 2."""
    cmap = fo.column_map(variant, muls, dx)
    rp = fo.roll_plan(cmap, dx, k)
    runs = cmap.reshape(-1, 4)
    assert rp.vec == bool(np.all(runs[:, 0] % 4 == 0) and np.all(np.diff(runs, axis=1) == 1))
    width = 4 if rp.vec else 1
    assert rp.nsl == int(np.ceil(dx / fo.ROLL_SW)) and rp.sw == fo.ROLL_SW
    assert rp.uoff[0] == 0 and rp.uoff[-1] == len(rp.units) and np.all(np.diff(rp.uoff) >= 0)
    cols = []
    for s in range(rp.nsl):
        lo, hi = s * rp.sw, min(dx, (s + 1) * rp.sw)
        units = rp.units[rp.uoff[s]:rp.uoff[s + 1]]
        assert np.all(np.diff(units[:, 1]) >= 0)
        for c, local in units:
            assert lo <= lo + local and lo + local + width <= hi
            assert list(cmap[c:c + width]) == list(range(lo + local, lo + local + width))
            cols.extend(range(c, c + width))
    assert sorted(cols) == list(range(len(cmap)))
    stage = 4 * int(np.ceil(k * fo.ROLL_SW / 32)) * 32 + 16  # 128-byte aligned, 2 mbarriers
    assert rp.ns == min(fo.ROLL_NSMAX, (fo.SMEM_LIMIT - fo.ROLL_ALIGN) // stage) and rp.ns >= 2
    assert rp.smem == rp.ns * stage + fo.ROLL_ALIGN <= fo.SMEM_LIMIT
    if (muls, dx) == (fo.MULS, 392):  # the script's maps fold by 4-column runs
        assert rp.vec


def test_mma_kernel_checks_its_shapes():
    """The mxu kernel's host checks refuse what it does not take: A other
    than 16 or 32, a DX whose two stages do not fit, unaligned tensors, more
    than 65,535 blocks; roll keeps its K."""
    t = torch.zeros(8, 4)
    assert fo._check_kernel(9, 16, 12, 96, "mxu2", 3, (t,)).tiles == 2
    assert fo._check_kernel(8, 32, 12, 96, "roll", 3, (t,)) is None
    with pytest.raises(ValueError, match="A 16 or 32"):
        fo._check_kernel(9, 8, 12, 96, "mxu3", 3, (t,))
    with pytest.raises(ValueError, match="shared memory"):
        fo._check_kernel(8, 32, 1800, 14400, "mxu2", 3, (t,))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fo._check_kernel(8, 32, 12, 96, "mxu2", 3, (t.view(-1)[1:],))
    with pytest.raises(ValueError, match="65,535"):
        fo._check_kernel(8, 32, 12, 96, "mxu2", 65536, (t,))
    with pytest.raises(ValueError, match="roll kernel"):
        fo._check_kernel(7, 32, 12, 96, "bigroll", 3, (t,))


def _fold_conv_setup(seed):
    x_ir_s, hidden = "8x0e+4x1e+2x2e", (16, 16)
    j_x, j_f = JIrreps(x_ir_s), JIrreps.spherical_harmonics(2, 1)
    jconv = JConvTPSpec(j_x, j_f, j_infer(j_x, j_f, 2, "full"))
    p_x, p_f = Irreps(x_ir_s), Irreps.spherical_harmonics(2, 1)
    conv = ConvTPSpec(p_x, p_f, infer_irreps_out(p_x, p_f, 2, "full"))
    mlp_dims = (8, *hidden, conv.weight_numel)
    rng = np.random.default_rng(seed)
    N, K = 8, 24
    xg = _rng_f32(rng, N * K, conv.irreps_x.dim, scale=0.5)
    emb = _rng_f32(rng, N * K, 8, scale=0.3)
    sh = _rng_f32(rng, N * K, 9, scale=0.5)
    ws = [_rng_f32(rng, a, b) for a, b in zip(mlp_dims[:-1], mlp_dims[1:])]
    w3j = j_instr_tables(jconv)[1]
    return jconv, conv, mlp_dims, N, K, xg, emb, sh, ws, w3j


@pytest.mark.parametrize("variant", fcv.VARIANTS)
def test_fold_conv_plain_matches_pallas(variant):
    jconv, conv, mlp_dims, N, K, xg, emb, sh, ws, w3j = _fold_conv_setup(50)
    A = 4
    assert np.array_equal(w3j, fcv._tables(conv)[1])  # the port's own copy of the tables
    # receiver i = b A + a, slot k: row i K + k here, b T + k A + a on the TPU
    i = np.arange(N)
    k = np.arange(K)
    km = ((i[:, None] // A) * A * K + k[None, :] * A + i[:, None] % A).reshape(-1)
    perm = np.empty(N * K, np.int64)
    perm[km] = np.arange(N * K)  # TPU row -> receiver-major row
    want = pallas_fold_conv(variant, jconv, mlp_dims, N, K, A, xg[perm], emb[perm], sh[perm],
                            ws, w3j)
    got = fcv.fold_conv(conv, *(torch.tensor(v) for v in (xg, emb, sh)),
                        [torch.tensor(w) for w in ws], torch.tensor(w3j), K, variant, plain=True)
    _close(got.numpy(), want, fcv.TOL)


def test_fold_conv_tables_walk():
    """The kernel's int table, walked in numpy as the kernel walks it, gives
    back each instruction's (m, p, r) terms, each output row's in the
    table's order."""
    conv, _ = fcv.sevennet0_conv()
    instr, _, _, itab = fcv._tables(conv)
    for i, ins in enumerate(instr):
        rec = itab[fcv.REC * i: fcv.REC * (i + 1)]
        assert list(rec[:8]) == [ins[f] for f in ("x_start", "d1", "d3", "mul", "w_start",
                                                   "g_start", "u_off", "u_tot")]
        assert rec[9] == min(r for _, _, r in ins["mp"])  # the first of consecutive rows
        starts = itab[rec[8]: rec[8] + ins["d3"] + 1]
        walked = [(int(itab[t]), p, int(itab[t + 1])) for p in range(ins["d3"])
                  for t in range(starts[p], starts[p + 1], 2)]
        assert walked == sorted(ins["mp"], key=lambda mpr: mpr[1])  # stable: table order per row


def test_fold_conv_plain_is_b4_fwd():
    """The probe's function is B4 fwd's: on xg = x[src] it matches the
    port's plain emb/sh conv forward."""
    from sevennet_tpu_torch.ops import fused_conv as fc
    from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec

    _, conv, mlp_dims, N, K, _, emb, sh, ws, w3j = _fold_conv_setup(51)
    rng = np.random.default_rng(52)
    x = torch.tensor(_rng_f32(rng, 20, conv.irreps_x.dim, scale=0.5))
    src = torch.tensor(rng.integers(0, 20, size=(N, K)), dtype=torch.int32)
    op = fc.conv_op(conv, ScalarMLPSpec(mlp_dims), None)
    ws_t = [torch.tensor(w) for w in ws]
    want = fc.fused_conv_fwd_embsh(op, x, src, torch.tensor(emb), torch.tensor(sh), ws_t)
    xg = x[src.reshape(-1).long()].contiguous()
    for variant in fcv.VARIANTS:
        got = fcv.fold_conv(conv, xg, torch.tensor(emb), torch.tensor(sh), ws_t,
                            torch.tensor(w3j), K, variant, plain=True)
        _close(got.numpy(), want.numpy(), fcv.TOL)


@pytest.mark.parametrize("k", [24, 72])
def test_fold_conv_cancelling_input_separates_the_orders(k):
    """On fold_conv.cancelling_input the three plain variants differ from
    each other by more than 10 TOL of max |plain| (each keeps another set
    of the small terms), so that a kernel held within TOL of its own
    variant's plain version there sums in that variant's order."""
    _, conv, mlp_dims, _, _, _, _, _, ws, w3j = _fold_conv_setup(54)
    xg, emb, sh = fcv.cancelling_input(4, k, conv, 11, "cpu")
    assert torch.equal(emb.view(4, k, -1), emb.view(4, k, -1)[:, :1].expand(4, k, -1))
    outs = {v: fcv.fold_conv(conv, xg, emb, sh, [torch.tensor(w) for w in ws],
                             torch.tensor(w3j), k, v, plain=True) for v in fcv.VARIANTS}
    for i, a in enumerate(fcv.VARIANTS):
        assert bool(torch.isfinite(outs[a]).all())
        for b in fcv.VARIANTS[i + 1:]:
            gap = float((outs[a] - outs[b]).abs().max())
            assert gap > 10 * fcv.TOL * float(outs[a].abs().max()), (a, b, gap)


def test_reduce_fold_xpose_wrappers_check_their_inputs():
    """The wrappers raise on CPU tensors unless told to run the plain
    version (which does not count as a launch), and refuse misshapen or
    mistyped inputs, unknown variants and shapes their kernels do not take."""
    x, s = torch.zeros(64, 16), torch.zeros(1, 1)
    jconv, conv, mlp_dims, N, K, xg, emb, sh, ws, w3j = _fold_conv_setup(53)
    fc_args = (conv, *(torch.tensor(v) for v in (xg, emb, sh)), [torch.tensor(w) for w in ws],
               torch.tensor(w3j), K)
    fx, fm = torch.zeros(2 * 16 * 9, 12), fo.fold_matrix(9, 16)
    fns = (rd.kreduce, rd.subreduce, rd.lanereduce, xp.transpose_carry, xp.xpose, xp.xpose2,
           fo.fold, fcv.fold_conv)
    counts = [fn.launches for fn in fns]
    for call in (lambda: rd.kreduce(x), lambda: rd.subreduce(x, s), lambda: rd.lanereduce(x, s),
                 lambda: xp.transpose_carry(x, s), lambda: xp.xpose(x), lambda: xp.xpose2(x),
                 lambda: fo.fold(fx, fm, 9, 16, muls=FOLD_MULS),
                 lambda: fcv.fold_conv(*fc_args)):
        with pytest.raises(ValueError, match="plain=True"):
            call()
    with pytest.raises(ValueError, match="float32"):
        rd.kreduce(x.double(), plain=True)
    with pytest.raises(ValueError, match="groups"):
        rd.subreduce(torch.zeros(60, 16), s, plain=True)
    with pytest.raises(ValueError, match="at most 128"):
        rd.kreduce(torch.zeros(8 * 129, 4), plain=True)
    with pytest.raises(ValueError, match="lane kernel"):
        rd.lanereduce(torch.zeros(4, 8 * 24), s, plain=True)
    with pytest.raises(ValueError, match=r"\(1, 1\)"):
        rd.lanereduce(x, torch.zeros(1), plain=True)
    with pytest.raises(ValueError, match="variant"):
        xp.xpose(x, "pad2", plain=True)
    with pytest.raises(ValueError, match="out"):
        xp.xpose(x, out=torch.empty(64, 16), plain=True)
    with pytest.raises(ValueError, match="variant"):
        fo.fold(fx, fm, 9, 16, "mxu4", FOLD_MULS, plain=True)
    with pytest.raises(ValueError, match="fold"):
        fo.fold(fx, fo.fold_matrix(9, 8), 9, 16, muls=FOLD_MULS, plain=True)
    with pytest.raises(ValueError, match="8 times"):
        fo.fold(fx, fm, 9, 16, muls=FOLD_MULS[:-1], plain=True)
    with pytest.raises(ValueError, match="blocks"):
        fo.fold(fx[:-1], fm, 9, 16, muls=FOLD_MULS, plain=True)
    with pytest.raises(ValueError, match="variant"):
        fcv.fold_conv(*fc_args, variant="group3", plain=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        fcv.fold_conv(conv, *(torch.tensor(v[: 2 * 12]) for v in (xg, emb, sh)), fc_args[4],
                      fc_args[5], 12, "group8", plain=True)
    with pytest.raises(ValueError, match="sh"):
        fcv.fold_conv(conv, torch.tensor(xg), torch.tensor(emb), torch.tensor(sh[:, :4]),
                      fc_args[4], fc_args[5], K, plain=True)
    with pytest.raises(ValueError, match="radial MLP"):
        fcv.fold_conv(*fc_args[:4], fc_args[4][:-1], *fc_args[5:], plain=True)
    assert [fn.launches for fn in fns] == counts


def test_probe_work_counts():
    """The operation and byte counts the bounds divide by, at the TPU
    scripts' shapes: the conv fold about 147 kFLOP and 2.16 kB a slot (1.56
    GB), the fold 1.257 GB, the streamed transpose 629 MB."""
    conv, mlp = fcv.sevennet0_conv()
    flops, nbytes = fcv.fold_conv_work(conv, mlp.dims, fcv.N, fcv.K)
    assert abs(flops / (fcv.N * fcv.K) / 1e3 - 147.2) < 0.1
    assert abs(nbytes / 1e9 - 1.5596) < 1e-3
    nb = fo.N // fo.A
    fl, nb_bytes = fo.fold_work(nb)
    assert fl == fo.N * fo.DM * (fo.K - 1)
    assert nb_bytes == 4 * (nb * fo.A * fo.K * fo.DM // 8 + fo.A * fo.K * fo.A + fo.N * fo.DM)
    assert abs(nb_bytes / 3.35e12 * 1e3 - 0.3751) < 1e-4  # the bound of every variant, ms
    assert xp.xpose_work(xp.STREAM_SHAPE[0] * xp.STREAM_SHAPE[1]) == (0, 8 * 163840 * 480)
    assert xp.xpose_work(1024 * 480, carried=True) == (3 * 16 * 1024 * 480, 8 * 1024 * 480)
    assert rd.reduce_work(1024 * 128, 8 * 128) == (16 * 2 * (1024 * 128 + 8 * 128),
                                                   4 * (1024 * 128 + 8 * 128))
