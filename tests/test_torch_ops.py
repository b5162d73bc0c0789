"""The PyTorch port's elementwise and small dense ops against the JAX
package on the same inputs (numpy, seeded): radial basis and envelopes,
activations, scalar MLP, equivariant linear, gate, spherical harmonics.

Tolerance rtol = atol = 1e-6: both sides run fp32 on the CPU; only the
order of a few sums differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_tpu import irreps as j_irreps
from sevennet_tpu.ops import activations as j_act
from sevennet_tpu.ops import gate as j_gate
from sevennet_tpu.ops import linear as j_linear
from sevennet_tpu.ops import mlp as j_mlp
from sevennet_tpu.ops import radial as j_radial
from sevennet_tpu.so3 import spherical as j_sph
from sevennet_tpu_torch import irreps as t_irreps
from sevennet_tpu_torch.ops import activations as t_act
from sevennet_tpu_torch.ops import gate as t_gate
from sevennet_tpu_torch.ops import linear as t_linear
from sevennet_tpu_torch.ops import mlp as t_mlp
from sevennet_tpu_torch.ops import radial as t_radial
from sevennet_tpu_torch.so3 import spherical as t_sph

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_radial_basis_and_envelopes():
    rng = np.random.default_rng(0)
    # includes radii past the cutoff (padded slots must give exactly 0)
    r = rng.uniform(0.3, 6.5, 200).astype(np.float32)
    coef = j_radial.bessel_coeffs_init(5.0, 8)
    np.testing.assert_array_equal(coef, t_radial.bessel_coeffs_init(5.0, 8))
    close(t_radial.bessel_basis(torch.tensor(r), torch.tensor(coef), 5.0),
          j_radial.bessel_basis(jnp.asarray(r), jnp.asarray(coef), 5.0))
    close(t_radial.poly_cutoff(torch.tensor(r), 5.0, 6),
          j_radial.poly_cutoff(jnp.asarray(r), 5.0, 6))
    close(t_radial.xplor_cutoff(torch.tensor(r), 5.0, 4.5),
          j_radial.xplor_cutoff(jnp.asarray(r), 5.0, 4.5))
    assert (t_radial.xplor_cutoff(torch.tensor([5.0, 6.0]), 5.0, 4.5) == 0).all()


@pytest.mark.parametrize("name", sorted(j_act.ACTIVATION))
def test_normalized_activations(name):
    assert t_act.NORMALIZE2MOM_CST == j_act.NORMALIZE2MOM_CST
    assert t_act.ACT_PARITY == j_act.ACT_PARITY
    z = np.random.default_rng(1).normal(size=256).astype(np.float32) * 3
    close(t_act.NORMALIZED_ACTIVATION[name](torch.tensor(z)),
          j_act.NORMALIZED_ACTIVATION[name](jnp.asarray(z)))


def test_scalar_mlp():
    rng = np.random.default_rng(2)
    dims = (8, 16, 16, 40)
    ws = [rng.normal(size=(a, b)).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]
    x = rng.normal(size=(30, 8)).astype(np.float32)
    out_t = t_mlp.scalar_mlp_apply(t_mlp.ScalarMLPSpec(dims), {"w": [torch.tensor(w) for w in ws]},
                                   torch.tensor(x))
    out_j = j_mlp.scalar_mlp_apply(j_mlp.ScalarMLPSpec(dims), {"w": [jnp.asarray(w) for w in ws]},
                                   jnp.asarray(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("ir_in,ir_out,biases", [
    ("8x0e+4x1e+2x2e", "6x0e+3x1e+2x2e", False),
    ("8x0e+4x1o+4x1e", "5x0e+3x1o", True),
])
def test_linear(ir_in, ir_out, biases):
    js = j_linear.LinearSpec(j_irreps.Irreps(ir_in), j_irreps.Irreps(ir_out), biases)
    ts = t_linear.LinearSpec(t_irreps.Irreps(ir_in), t_irreps.Irreps(ir_out), biases)
    assert js.instructions == ts.instructions and js.weight_shapes == ts.weight_shapes
    jp = j_linear.linear_init(jax.random.PRNGKey(0), js)
    if biases:
        jp["b"] = jnp.arange(js.bias_numel, dtype=jnp.float32) * 0.1
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), jp)
    x = np.random.default_rng(3).normal(size=(7, js.irreps_in.dim)).astype(np.float32)
    close(t_linear.linear_apply(ts, tp, torch.tensor(x)), j_linear.linear_apply(js, jp, jnp.asarray(x)))


def test_gate():
    ir = "8x0e+4x1e+2x2e"
    act = (("e", "silu"), ("o", "tanh"))
    js = j_gate.GateSpec(j_irreps.Irreps(ir), act, act)
    ts = t_gate.GateSpec(t_irreps.Irreps(ir), act, act)
    assert str(js.irreps_in) == str(ts.irreps_in) and js.sc_entries == ts.sc_entries
    x = np.random.default_rng(4).normal(size=(9, js.irreps_in.dim)).astype(np.float32)
    close(t_gate.gate_apply(ts, torch.tensor(x)), j_gate.gate_apply(js, jnp.asarray(x)))


@pytest.mark.parametrize("lmax", [1, 2, 3])
def test_spherical_harmonics(lmax):
    for l in range(lmax + 1):
        np.testing.assert_array_equal(t_sph.sh_coefficients(l), j_sph.sh_coefficients(l))
        if l:
            np.testing.assert_array_equal(t_sph.sh_deriv_tables(l), j_sph.sh_deriv_tables(l))
    v = np.random.default_rng(5).normal(size=(64, 3)).astype(np.float32) * 2
    close(t_sph.spherical_harmonics(lmax, torch.tensor(v)),
          j_sph.spherical_harmonics(lmax, jnp.asarray(v)))
