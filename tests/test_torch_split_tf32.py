"""Accuracy of the 3xTF32 split that the fused-conv kernels use for their
W3 products (``sevennet_tpu_torch/csrc/fused_conv_common.cuh``), emulated
in numpy on the CPU.

TF32 keeps 10 mantissa bits. The kernels split each fp32 operand as
``hi = rna(a)``, ``lo = rna(a - hi)`` (``cvt.rna.tf32.f32``: round to
nearest, ties away from zero) and accumulate ``hi*hi + hi*lo + lo*hi`` in
fp32 with ``mma.m16n8k8`` (8 products per step). The emulation here rounds
the same way and accumulates each 8-deep step's exact sum into an fp32
accumulator. At SevenNet-0's shapes (the forward ``w = h2 W3 / sqrt(h2)``,
16 x 64 by 64 x 960, and the backward ``dh2 = dw W3^T``, 16 x 960 by
960 x 64), with the model's scaling, it holds 3xTF32 within 1e-6 of the
largest exact value (a plain fp32 product is about 3e-7), and shows that
one TF32 product misses the kernel-vs-plain limit of 1e-4.
"""

import numpy as np
import pytest

KERNEL_VS_PLAIN = 1e-4   # chip_smoke.py's limit, of max |plain|
SPLIT_LIMIT = 1e-6


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 (still stored as fp32): round the 13 low mantissa bits
    to nearest, ties away from zero (finite inputs)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray):
    hi = tf32_rna(a)
    return hi, tf32_rna(np.asarray(a, np.float32) - hi)


def mma_chain(pairs, k_step: int = 8) -> np.ndarray:
    """sum over ``pairs`` of a @ b, each a (M, K) and b (K, N) fp32 array of
    TF32 values, as chained mma steps: the exact product of each 8-deep
    slice (tf32 x tf32 is exact in fp64) added to an fp32 accumulator."""
    m, n = pairs[0][0].shape[0], pairs[0][1].shape[1]
    acc = np.zeros((m, n), np.float32)
    k = pairs[0][0].shape[1]
    for k0 in range(0, k, k_step):
        for a, b in pairs:
            part = a[:, k0:k0 + k_step].astype(np.float64) @ b[k0:k0 + k_step].astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def products(a: np.ndarray, b: np.ndarray):
    """(exact, 3xTF32, one TF32 pass, plain fp32) of a @ b."""
    exact = a.astype(np.float64) @ b.astype(np.float64)
    ah, al = split(a)
    bh, bl = split(b)
    three = mma_chain([(al, bh), (ah, bl), (ah, bh)])
    one = mma_chain([(tf32_rna(a), tf32_rna(b))])
    return exact, three, one, a @ b


def silu_cst(z):
    # the radial MLP's activation, normalized as the model normalizes it
    # (about 1.68 for silu)
    return z / (1.0 + np.exp(-z)) * 1.679176792398942


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_split_tf32_is_as_accurate_as_fp32(direction, seed):
    rng = np.random.default_rng(seed)
    h2, numel = 64, 960
    w3 = rng.normal(size=(h2, numel)).astype(np.float32)
    if direction == "forward":
        # w = h2 W3 / sqrt(h2), h2 the last hidden layer's activations
        a = silu_cst(rng.normal(size=(16, h2))).astype(np.float32)
        b = w3
    else:
        # dh2 = dw W3^T, dw a weight cotangent of the model's size
        a = (rng.normal(size=(16, numel)) / np.sqrt(h2)).astype(np.float32)
        b = np.ascontiguousarray(w3.T)
    exact, three, one, fp32 = products(a, b)
    scale = np.abs(exact).max()
    err3 = np.abs(three - exact).max() / scale
    err1 = np.abs(one - exact).max() / scale
    err32 = np.abs(fp32 - exact).max() / scale
    assert err3 <= SPLIT_LIMIT, (err3, err32)
    assert err3 <= 4 * err32 + 1e-7, (err3, err32)
    assert err1 > KERNEL_VS_PLAIN, err1


def test_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32 spacing at 1
    vals = np.array([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23, -(1.0 + 2.0 ** -11),
                     1.0 + 3 * 2.0 ** -12], np.float32)
    got = tf32_rna(vals)
    np.testing.assert_array_equal(got, np.array([one + ulp, one, -(one + ulp), one + ulp],
                                                np.float32))
    hi, lo = split(np.float32(np.pi))
    assert hi + lo == np.float32(np.pi) or abs(float(hi) + float(lo) - np.pi) < 2.0 ** -21
