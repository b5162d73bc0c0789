"""The Hopper probes' plain versions (``sevennet_tpu_torch/probes``) against
the TPU probe kernels they port, and their wrappers' checks.

The TPU kernels live in scripts that time them on a TPU when imported
(their module-level ``report(...)`` lines, ``scripts_dev/r2_pallas_mm.py:
131-144``; ``r4_batched_dot_probe.py`` allocates about 1.9 GB of inputs at
import), so their kernel bodies are quoted here, each with its file and
lines, and run through ``pl.pallas_call(..., interpret=True)`` on the CPU at
small shapes: 32 x 16 x 24 for the products, N 64 atoms in blocks of A 32
for the batched one. The same inputs, made with numpy from a seed, go
through both. Limit: 1e-5 of the largest reference value (float32 on both
sides, sums in another order; bf16 operands give exact float32 products).
The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_kernels.py, chip_smoke.py), at the limits of
``mm_rate.PROBE_TOL``; the one for a single TF32 pass is checked here
against a numpy emulation at the TPU scripts' shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sevennet_tpu_torch.probes import batched_dot as bd
from sevennet_tpu_torch.probes import mm_rate as mr

from .test_torch_split_tf32 import tf32_rna

torch.set_num_threads(1)
M, K, N = 32, 16, 24
REP = mr.REP


def pallas_mm(a, b, s, rep=REP):
    """``scripts_dev/r2_pallas_mm.py:43-61`` (``mm``'s kernel and call)."""
    m, n = a.shape[0], b.shape[1]

    def kernel(a_ref, b_ref, s_ref, out_ref):
        b = b_ref[:]

        def body(i, acc):
            ai = a_ref[:] * (1.0 + s_ref[0, 0] * i.astype(jnp.float32)
                             ).astype(a_ref.dtype)
            return acc * 0.5 + jnp.dot(ai, b, preferred_element_type=jnp.float32)
        out_ref[:] = jax.lax.fori_loop(
            0, rep, body, jnp.zeros((m, n), jnp.float32))

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 1), memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(a, b, s)


def pallas_mm_chain(a, b, rep=REP):
    """``scripts_dev/r2_pallas_fma.py:104-120`` (``mm``'s kernel and call)."""
    m, n = a.shape[0], b.shape[1]

    def kernel(a_ref, b_ref, out_ref):
        a = a_ref[:]; b = b_ref[:]  # noqa: E702

        def body(i, acc):
            ai = a + acc[0:1, 0:1].astype(a.dtype) * 1e-20
            return acc * 0.5 + jnp.dot(
                ai, b, preferred_element_type=jnp.float32)
        out_ref[:] = jax.lax.fori_loop(
            0, rep, body, jnp.zeros((m, n), jnp.float32))

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(a, b)


def pallas_batched(Ss, XWs, A):
    """``scripts_dev/r4_batched_dot_probe.py:69-105`` (``make_pallas``), N
    atoms in blocks of A."""
    n_atoms = Ss[0].shape[0]
    groups = [(S.shape[1], S.shape[2], XW.shape[2]) for S, XW in zip(Ss, XWs)]
    hi = dict(precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32)

    def kernel(*refs):
        ins = refs[: 2 * len(groups)]
        outs = refs[2 * len(groups):]
        for gi, (d3, kk, mul) in enumerate(groups):
            S = ins[gi][:]           # (A, d3, kk)
            XW = ins[len(groups) + gi][:]  # (A, kk, mul)
            Y = jax.lax.dot_general(
                S, XW, (((2,), (1,)), ((0,), (0,))), **hi
            )
            outs[gi][:] = Y

    in_specs = []
    for d3, kk, mul in groups:
        in_specs.append(pl.BlockSpec((A, d3, kk), lambda i: (i, 0, 0),
                                     memory_space=pltpu.VMEM))
    for d3, kk, mul in groups:
        in_specs.append(pl.BlockSpec((A, kk, mul), lambda i: (i, 0, 0),
                                     memory_space=pltpu.VMEM))
    out_specs = [
        pl.BlockSpec((A, d3, mul), lambda i: (i, 0, 0),
                     memory_space=pltpu.VMEM)
        for d3, kk, mul in groups
    ]
    return pl.pallas_call(
        kernel,
        grid=(n_atoms // A,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=[jax.ShapeDtypeStruct((n_atoms, d3, mul), jnp.float32)
                   for d3, kk, mul in groups],
        interpret=True,
    )(*Ss, *XWs)


def _inputs(dtype, seed):
    """a (M, K), b (K, N) as torch tensors of ``dtype`` and the same values
    as JAX arrays."""
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.normal(size=(M, K)), dtype=torch.float32).to(dtype)
    b = torch.tensor(rng.normal(size=(K, N)), dtype=torch.float32).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return a, b, jnp.asarray(a.float().numpy(), jdt), jnp.asarray(b.float().numpy(), jdt)


def _close(got, want):
    want = np.asarray(want, np.float64)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype,s", [(torch.float32, 0.0), (torch.float32, 0.01),
                                     (torch.bfloat16, 0.0), (torch.bfloat16, 0.01)],
                         ids=["f32", "f32_s", "bf16", "bf16_s"])
def test_mm_rate_plain_matches_pallas(dtype, s):
    a, b, ja, jb = _inputs(dtype, 1)
    st = torch.full((1, 1), s)
    variant = "bf16" if dtype == torch.bfloat16 else "3xtf32"
    got = mr.mm_rate(a, b, st, variant=variant, plain=True)
    _close(got.numpy(), pallas_mm(ja, jb, jnp.full((1, 1), s, jnp.float32)))
    # copies are independent copies of the same product
    assert torch.equal(mr.mm_rate(a, b, st, variant=variant, copies=3, plain=True)[2], got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mm_chain_plain_matches_pallas(dtype):
    a, b, ja, jb = _inputs(dtype, 2)
    variant = "bf16" if dtype == torch.bfloat16 else "ffma"
    _close(mr.mm_chain(a, b, variant=variant, plain=True).numpy(), pallas_mm_chain(ja, jb))


def test_batched_dot_plain_matches_pallas():
    rng = np.random.default_rng(3)
    n_atoms = 64
    Ss = [(rng.normal(size=(n_atoms, d3, kk)) * 0.1).astype(np.float32) for d3, kk, _ in bd.GROUPS]
    XWs = [(rng.normal(size=(n_atoms, kk, mul)) * 0.1).astype(np.float32)
           for _, kk, mul in bd.GROUPS]
    got = bd.batched_dot([torch.tensor(S) for S in Ss], [torch.tensor(X) for X in XWs],
                         plain=True)
    want = pallas_batched([jnp.asarray(S) for S in Ss], [jnp.asarray(X) for X in XWs], 32)
    for y, w in zip(got, want):
        _close(y.numpy(), w)
    flops, nbytes = bd.batched_dot_work([torch.tensor(S) for S in Ss],
                                        [torch.tensor(X) for X in XWs])
    assert flops == 2 * n_atoms * sum(d3 * kk * mul for d3, kk, mul in bd.GROUPS)
    assert nbytes == 4 * n_atoms * sum(d3 * kk + kk * mul + d3 * mul for d3, kk, mul in bd.GROUPS)


# the batched dot's group sets its plan is held to: the script's, the card's
# ragged ones (K d1 short of a chunk and past one, d3 5, mul 8 and 24), and
# the widest the kernel takes
BD_PLAN_GROUPS = (bd.GROUPS, ((5, 8, 8), (5, 40, 24), (22, 152, 24)),
                  ((9, 40, 8), (5, 8, 24), (20, 80, 64)), ((24, 1000, 128), (1, 8, 8), (8, 16, 128)))


@pytest.mark.parametrize("groups", BD_PLAN_GROUPS, ids=["script", "ragged1", "ragged2", "widest"])
def test_batched_dot_plan_covers_and_fits(groups):
    """bd_plan against a numpy statement of the kernel's plan: the chunks of
    each group cover its K d1 contraction rows exactly once, in order, each
    at most BD_KS k8 steps; a stage holds any group's chunk (XW as TMA
    boxes of BD_CB columns x ch rows, then S, d3 rows of ch floats), in
    whole swizzle atoms of BD_ALIGN bytes; each warpgroup's B buffer holds
    a chunk's hi and lo core matrices (2 x 2 x NT8 of 32 floats a step);
    the deepest ring up to BD_NSMAX, an equal share for each of the BD_CWG
    warpgroups, that fits SMEM_LIMIT with an mbarrier a stage and the
    alignment's slack, at least 2 stages a warpgroup."""
    plan = bd.bd_plan(groups)
    for _, kk, _ in groups:
        rows = np.zeros(kk, int)
        for k0 in range(0, kk, plan.ch):  # the kernel's chunks of an item, in order
            n = min(plan.ch, kk - k0)
            assert n > 0 and n % 8 == 0 and n <= plan.ch == 8 * bd.BD_KS
            rows[k0:k0 + n] += 1
        assert np.all(rows == 1)
    need = max(plan.ch * (int(np.ceil(mul / bd.BD_CB)) * bd.BD_CB + d3) for d3, _, mul in groups)
    atom = bd.BD_ALIGN // 4
    assert plan.stage % atom == 0 and need <= plan.stage < need + atom
    assert plan.bbuf == bd.BD_KS * 2 * 2 * max(int(np.ceil(d3 / 8)) for d3, _, _ in groups) * 32

    def smem(ns):
        return 4 * (ns * plan.stage + bd.BD_CWG * plan.bbuf) + 8 * ns + bd.BD_ALIGN

    assert plan.ns == max(n for n in range(2 * bd.BD_CWG, bd.BD_NSMAX + 1, bd.BD_CWG)
                          if smem(n) <= bd.SMEM_LIMIT)
    assert plan.smem == smem(plan.ns) <= bd.SMEM_LIMIT
    if groups == bd.GROUPS:  # the script's groups: chunks of 40 rows, 2 stages a warpgroup
        assert (plan.ch, plan.ns) == (40, 2 * bd.BD_CWG)


def test_batched_dot_kernel_checks_its_shapes():
    """The kernel's host checks refuse what it does not take: d3 above 24,
    mul above 128, unaligned tensors, rep below 1."""
    t = torch.zeros(8)
    assert bd._check_kernel(bd.GROUPS, 4, (t,)).ch == 8 * bd.BD_KS
    with pytest.raises(ValueError, match="d3 up to 24"):
        bd._check_kernel(((25, 8, 8),) * 3, 1, (t,))
    with pytest.raises(ValueError, match="mul up to 128"):
        bd._check_kernel(((8, 8, 136),) * 3, 1, (t,))
    with pytest.raises(ValueError, match="16-byte aligned"):
        bd._check_kernel(bd.GROUPS, 1, (t[1:],))
    with pytest.raises(ValueError, match="rep"):
        bd._check_kernel(bd.GROUPS, 0, (t,))


def test_probe_wrappers_check_their_inputs():
    """The wrappers raise on CPU tensors unless told to run the plain
    version (which does not count as a launch), and refuse misshapen or
    mistyped inputs and unknown variants."""
    a, b, _, _ = _inputs(torch.float32, 4)
    s = torch.zeros((1, 1))
    counts = (mr.mm_rate.launches, mr.mm_chain.launches, bd.batched_dot.launches)
    with pytest.raises(ValueError, match="plain=True"):
        mr.mm_rate(a, b, s)
    with pytest.raises(ValueError, match="plain=True"):
        mr.mm_chain(a, b)
    with pytest.raises(ValueError, match="variant"):
        mr.mm_rate(a, b, s, variant="fp8", plain=True)
    with pytest.raises(ValueError, match="bfloat16"):
        mr.mm_rate(a, b, s, variant="bf16", plain=True)
    with pytest.raises(ValueError, match=r"a \(m, k\)"):
        mr.mm_chain(a, b.T.contiguous(), plain=True)
    with pytest.raises(ValueError, match="scalar"):
        mr.mm_rate(a, b, torch.zeros(1), plain=True)
    Ss = [torch.zeros(4, d3, kk) for d3, kk, _ in bd.GROUPS]
    XWs = [torch.zeros(4, kk, mul) for _, kk, mul in bd.GROUPS]
    with pytest.raises(ValueError, match="plain=True"):
        bd.batched_dot(Ss, XWs)
    with pytest.raises(ValueError, match="K d1"):
        bd.batched_dot(Ss, XWs[::-1], plain=True)
    assert (mr.mm_rate.launches, mr.mm_chain.launches, bd.batched_dot.launches) == counts
    assert mr.mm_flops(*mr.MM_SHAPES[0]) == 2 * 1024 * 64 * 960 * REP
    assert mr.mm_tiles(1024, 960) == 16 * 15 and mr.mm_tiles(185, 33) == 3 * 1


@pytest.mark.parametrize("m,k,n", mr.MM_SHAPES, ids=[f"{m}x{k}x{n}" for m, k, n in mr.MM_SHAPES])
def test_one_tf32_pass_needs_its_own_limit(m, k, n):
    """``mm_rate.PROBE_TOL``'s limit for one TF32 pass (tf32, wgmma_tf32),
    from a numpy emulation of the kernel at every TPU-script shape (s =
    1e-3, as the card checks run): operands rounded to TF32 (to nearest,
    ties away, as ``cvt.rna``), products and sums exact. The error against
    the float64 loop stays within the limit, and above the 1e-5 of the
    fp32-accuracy variants, which therefore could not take it."""
    rng = np.random.default_rng(m + k + n)
    a, b = rng.normal(size=(m, k)).astype(np.float32), rng.normal(size=(k, n)).astype(np.float32)
    s = np.float32(1e-3)
    exact, one_pass = np.zeros((m, n)), np.zeros((m, n))
    bt = tf32_rna(b).astype(np.float64)
    for i in range(REP):
        ai = a * (np.float32(1.0) + s * np.float32(i))
        exact = exact * 0.5 + ai.astype(np.float64) @ b.astype(np.float64)
        one_pass = one_pass * 0.5 + tf32_rna(ai).astype(np.float64) @ bt
    err = np.abs(one_pass - exact).max() / np.abs(exact).max()
    assert 1e-5 < err <= mr.PROBE_TOL["tf32"] == mr.PROBE_TOL["wgmma_tf32"]
    assert set(mr.PROBE_TOL) == set(mr.VARIANTS)
