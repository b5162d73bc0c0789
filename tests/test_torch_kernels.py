"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: without a CUDA card every test here skips. This file imports
nothing of JAX, so it also runs where only PyTorch is installed
(``--noconftest`` skips the repo's conftest files, which import JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu

chip_smoke.py runs the same comparison at SevenNet-0 shapes. Tolerance:
1e-5 of the largest plain value, fp32 on both sides with sums in another
order (``dvec`` reaches tens and sums hundreds of products per edge).
"""

import numpy as np
import pytest
import torch

from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.data.graph import dense_graph_from_arrays
from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy
from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
from sevennet_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.ops import fused_conv as fc
from sevennet_tpu_torch.ops.mlp import ScalarMLPSpec
from sevennet_tpu_torch.ops.tensor_product import ConvTPSpec

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("kind,arg", [("XPLOR", 2.5), ("poly_cut", 6.0)])
def test_kernels_match_plain(cuda, kind, arg):
    x_ir, f_ir = Irreps("8x0e+8x1e+8x2e"), Irreps("1x0e+1x1e+1x2e")
    conv = ConvTPSpec(x_ir, f_ir, infer_irreps_out(x_ir, f_ir, 2, "full"))
    mlp = ScalarMLPSpec((8, 16, 16, conv.weight_numel))
    op = fc.conv_op(conv, mlp, fc.EdgeEmbedSpec(8, 3.0, kind, arg, 2))
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, 7.0, (40, 3))
    dst, src, shift = neighbor_list_numpy(pos, 3.0)
    g = dense_graph_from_arrays(pos, np.zeros(40), src, dst, shift, device=cuda)
    N, K = g.n_atoms_cap, g.dense_k
    vec = torch.where(g.edge_mask[None], g.edge_vectors().T,
                      torch.tensor([[6.0], [0.0], [0.0]], device=cuda)).contiguous()
    ws = [torch.tensor(rng.normal(size=(a, b)), dtype=torch.float32, device=cuda)
          for a, b in zip(mlp.dims[:-1], mlp.dims[1:])]
    args = (op, torch.tensor(rng.normal(size=(N, op.dim_x)), dtype=torch.float32, device=cuda),
            g.edge_src.view(N, K).to(torch.int32), vec,
            torch.linspace(1.0, 8.0, 8, device=cuda), ws)
    ybar = torch.tensor(rng.normal(size=(N, op.dim_mid)), dtype=torch.float32, device=cuda)
    n0, b0 = fc.fused_conv_fwd.launches, fc.fused_conv_bwd.launches
    out = fc.fused_conv_fwd(*args)
    dxg, dvec = fc.fused_conv_bwd(*args, ybar)
    torch.cuda.synchronize()
    assert (fc.fused_conv_fwd.launches, fc.fused_conv_bwd.launches) == (n0 + 1, b0 + 1)
    dxg_p, dvec_p = fc.fused_conv_bwd_plain(*args, ybar)
    for got, want in ((out, fc.fused_conv_fwd_plain(*args)), (dxg, dxg_p), (dvec, dvec_p)):
        scale = float(want.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-5 * scale)
    # slots past the cutoff get exact zeros
    pad = ~g.edge_mask
    assert (dxg[pad] == 0).all() and (dvec[:, pad] == 0).all()


def test_calculator_kernels_match_plain(cuda):
    spec = build_model_spec({"channel": 8, "lmax": 2, "num_convolution_layer": 3,
                             "cutoff": 4.0, "chemical_species": ["Hf", "O"]})
    params = params_from_numpy(spec, random_params(spec, 3))
    rng = np.random.default_rng(1)
    cell = np.eye(3) * 6.0
    at = AtomsLite(positions=rng.uniform(0, 6.0, (24, 3)), numbers=[72] * 8 + [8] * 16,
                   cell=cell, pbc=True)
    n0 = fc.fused_conv_fwd.launches
    res = SevenNetCalculator(spec, params).calculate(at)
    assert fc.fused_conv_fwd.launches == n0 + len(spec.layers)
    ref = SevenNetCalculator(spec, params, plain=True).calculate(at)
    assert abs(res["energy"] - ref["energy"]) <= 1e-5 * abs(ref["energy"])
    np.testing.assert_allclose(res["forces"], ref["forces"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(res["stress"], ref["stress"], atol=1e-6, rtol=0)
