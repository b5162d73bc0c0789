"""The port's ``dense_conv_pallas`` (``sevennet_tpu_torch/ops/pallas_conv.py``)
against the JAX package's (``sevennet_tpu/ops/pallas_conv.py``, kernel B6
in interpret mode on the CPU), at the shapes of tests/test_pallas_conv.py:
``16x0e+8x1o+4x2e`` (or ``8x1e``), spherical harmonics to l = 2, N = 16,
K = 8, a one-hidden-layer radial MLP. On the CPU the port runs the plain
version of the emb/sh forward kernel that serves it on the card.

Tolerance atol 1e-5: fp32 on both sides, sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_tpu.irreps import Irreps as JIrreps
from sevennet_tpu.irreps import infer_irreps_out as j_infer
from sevennet_tpu.ops.mlp import ScalarMLPSpec as JMLPSpec
from sevennet_tpu.ops.mlp import scalar_mlp_init
from sevennet_tpu.ops.pallas_conv import dense_conv_pallas as j_dense_conv_pallas
from sevennet_tpu.ops.tensor_product import ConvTPSpec as JConvTPSpec
from sevennet_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_tpu_torch.ops import fused_conv as fc
from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec
from sevennet_tpu_torch.ops.pallas_conv import dense_conv_pallas
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec

torch.set_num_threads(1)
N, K = 16, 8


@pytest.mark.parametrize("parity", [False, True])
def test_dense_conv_pallas_matches_jax(parity):
    x_str = "16x0e+8x1o+4x2e" if parity else "16x0e+8x1e+4x2e"
    jf_ir = JIrreps.spherical_harmonics(2, -1 if parity else 1)
    jconv = JConvTPSpec(JIrreps(x_str), jf_ir, j_infer(JIrreps(x_str), jf_ir, 2, "full"))
    f_ir = Irreps.spherical_harmonics(2, -1 if parity else 1)
    conv = ConvTPSpec(Irreps(x_str), f_ir, infer_irreps_out(Irreps(x_str), f_ir, 2, "full"))
    dims = (8, 16, conv.weight_numel)
    rng = np.random.default_rng(int(parity))
    x = rng.normal(size=(N, conv.irreps_x.dim)).astype(np.float32)
    emb = (rng.normal(size=(N, K, 8)) * 0.3).astype(np.float32)
    sh = rng.normal(size=(N, K, f_ir.dim)).astype(np.float32)
    src = rng.integers(0, N, (N, K)).astype(np.int32)
    ws = [np.asarray(w) for w in scalar_mlp_init(jax.random.PRNGKey(4), JMLPSpec(dims))["w"]]

    want = np.asarray(j_dense_conv_pallas(
        jconv, JMLPSpec(dims), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(sh),
        jnp.asarray(src), [jnp.asarray(w) for w in ws], a_block=4, interpret=True))
    launches = dense_conv_pallas.launches
    args = (torch.tensor(x), torch.tensor(emb), torch.tensor(sh), torch.tensor(src),
            [torch.tensor(w) for w in ws])
    got = dense_conv_pallas(conv, ScalarMLPSpec(dims), *args)
    assert dense_conv_pallas.launches == launches  # the CPU runs the plain version
    assert got.shape == want.shape == (N, conv.irreps_mid.dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the same function as the emb/sh forward on flattened edge rows
    op = fc.conv_op(conv, ScalarMLPSpec(dims))
    flat = fc.fused_conv_fwd_embsh(op, args[0], args[3], args[1].reshape(N * K, -1),
                                   args[2].reshape(N * K, -1), args[4])
    np.testing.assert_array_equal(got.numpy(), flat.numpy())
