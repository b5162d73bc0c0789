"""The port's D3 dispersion (``sevennet_tpu_torch/d3.py``) against the JAX
package's (``sevennet_tpu/d3.py``), on the CPU: the same numpy inputs (edge
lists, vectors and atomic numbers made from a seed) through the JAX
``d3_compute`` under ``jit`` and the port's ``d3_compute``.

Tolerances: energy 1e-5 relative, forces and virial 1e-5 of their largest
entry (fp32 on both sides, sums in another order); the reference CUDA
goldens at the JAX tests' own limits (tests/test_d3.py:98-146); the chunked
walk against one chunk at 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_tpu import d3 as jd3
from sevennet_tpu_torch import d3
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy

torch.set_num_threads(1)
REL = 1e-5
CHUNK_REL = 1e-6


def _edges(pos, Z, cutoff, cell=None):
    """Numpy inputs of ``d3_compute``: numbers, dst, src, vectors, mask."""
    pbc = cell is not None
    dst, src, S = neighbor_list_numpy(pos, cutoff, cell, (pbc,) * 3)
    ev = pos[src] - pos[dst] + (S @ cell if pbc else 0.0)
    return (np.asarray(Z, np.int64), dst.astype(np.int64), src.astype(np.int64),
            ev.astype(np.float32), np.ones(len(dst), bool))


def _jax(params, numbers, dst, src, ev, mask):
    fn = jax.jit(lambda *a: jd3.d3_compute(params, *a))
    e, f, v = fn(jnp.asarray(numbers, jnp.int32), jnp.asarray(dst, jnp.int32),
                 jnp.asarray(src, jnp.int32), jnp.asarray(ev), jnp.asarray(mask))
    return float(e), np.asarray(f), np.asarray(v)


def _port(params, numbers, dst, src, ev, mask, chunk=None, dtype=torch.float32):
    e, f, v = d3.d3_compute(params, torch.as_tensor(numbers), torch.as_tensor(dst),
                            torch.as_tensor(src), torch.as_tensor(ev).to(dtype),
                            torch.as_tensor(mask), chunk=chunk)
    return float(e), f.numpy(), v.numpy()


def _close(got, want, rel=REL):
    (e, f, v), (ej, fj, vj) = got, want
    assert np.isfinite(f).all() and np.isfinite(v).all() and np.isfinite(e)
    assert abs(e - ej) <= rel * abs(ej), (e, ej)
    np.testing.assert_allclose(f, fj, atol=rel * max(np.abs(fj).max(), 1e-30))
    np.testing.assert_allclose(v, vj, atol=rel * max(np.abs(vj).max(), 1e-30))


def _params(functional, damping, cutoff=None):
    p, jp = d3.D3Params.from_functional(functional, damping), jd3.D3Params.from_functional(
        functional, damping)
    if cutoff is not None:
        p = d3.D3Params(**dict(vars(p), cutoff=cutoff, cn_cutoff=min(p.cn_cutoff, cutoff)))
        jp = jd3.D3Params(**dict(vars(jp), cutoff=cutoff, cn_cutoff=min(jp.cn_cutoff, cutoff)))
    assert vars(p) == vars(jp)
    return p, jp


def hfo_box(seed=3):
    """The 16-atom Hf/O box of tests/test_d3.py:149-195 (L = 9.6 A)."""
    rng = np.random.default_rng(seed)
    L = 9.6
    pts, Zs = [], []
    for i in range(4):
        for j in range(2):
            for k in range(2):
                pts.append([i * L / 4 + 0.9, j * L / 2 + 0.9, k * L / 2 + 0.9])
                Zs.append(72 if (i + j) % 2 == 0 else 8)
    pos = np.asarray(pts) + rng.normal(scale=0.05, size=(len(pts), 3))
    return pos, np.asarray(Zs), np.eye(3) * L


def test_tables_are_the_jax_packages():
    """The port's copy of the tables equals the JAX package's, and so do its
    parameter sets."""
    got, want = d3._load_tables(), jd3._load_tables()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert d3.FUNCTIONAL_PARAMS_BJ == jd3.FUNCTIONAL_PARAMS_BJ
    assert d3.FUNCTIONAL_PARAMS_ZERO == jd3.FUNCTIONAL_PARAMS_ZERO


@pytest.mark.parametrize("damping", ["bj", "zero"])
@pytest.mark.parametrize("r", [3.8, 5.0, 8.0, 15.0])
def test_argon_dimer_matches_jax(r, damping):
    p, jp = _params("pbe", damping)
    args = (np.array([18, 18]), np.array([0, 1]), np.array([1, 0]),
            np.array([[r, 0, 0], [-r, 0, 0]], np.float32), np.ones(2, bool))
    got, want = _port(p, *args), _jax(jp, *args)
    assert want[0] < 0
    _close(got, want)


@pytest.mark.parametrize("damping", ["bj", "zero"])
def test_mixed_cluster_matches_jax(damping):
    """The 6-atom cluster of tests/test_d3.py:35 (O, H, H, C, N, Ar)."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 5, (6, 3))
    args = _edges(pos, [8, 1, 1, 6, 7, 18], 50.0)
    p, jp = _params("pbe", damping)
    _close(_port(p, *args), _jax(jp, *args))


@pytest.mark.parametrize("functional,damping,cutoff", [
    ("pbe", "bj", 9.0), ("r2scan", "bj", 10.5), ("b3-lyp", "zero", 12.0)])
def test_periodic_hfo_box_matches_jax(functional, damping, cutoff):
    pos, Z, cell = hfo_box()
    args = _edges(pos, Z, cutoff, cell)
    p, jp = _params(functional, damping, cutoff)
    _close(_port(p, *args), _jax(jp, *args))


def test_isolated_atoms_match_jax():
    """An atom alone (one masked edge: energy 0), and a carbon 25 A from an
    H2 molecule: beyond the CN cutoff its CN is 0, inside the pair cutoff
    its pair terms count."""
    p, jp = _params("pbe", "bj")
    alone = (np.array([6]), np.zeros(1, np.int64), np.zeros(1, np.int64),
             np.ones((1, 3), np.float32), np.zeros(1, bool))
    got = _port(p, *alone)
    assert got[0] == 0.0 and not got[1].any() and not got[2].any()
    assert _jax(jp, *alone)[0] == 0.0
    pos = np.array([[0.0, 0, 0], [0.74, 0, 0], [25.0, 0.3, 0.1]])
    args = _edges(pos, [1, 1, 6], 50.0)
    z, dst, src, ev, m = (torch.as_tensor(a) for a in args)
    zi, zj, r, em = d3._edge_inputs(z, dst, src, ev, m)
    assert float(d3.d3_cn(p, zi, zj, r, em, dst, 3)[2]) == 0.0
    _close(_port(p, *args), _jax(jp, *args))


def test_compressed_hydrogen_takes_the_fallback():
    """Thirteen H atoms within 0.4 A: CN near 12, far from both H
    references (CN 0 and 0.91), so every Gaussian weight underflows and the
    closest-reference fallback gives C6. Forces finite and equal to JAX's."""
    rng = np.random.default_rng(5)
    pos = rng.normal(scale=0.2, size=(13, 3))
    args = _edges(pos, [1] * 13, 50.0)
    p, jp = _params("pbe", "bj")
    z, dst, src, ev, m = (torch.as_tensor(a) for a in args)
    zi, zj, r, em = d3._edge_inputs(z, dst, src, ev, m)
    cn = d3.d3_cn(p, zi, zj, r, em, dst, 13)
    assert float(cn.min()) > 8.0
    refs = d3._tables("cpu", torch.float32)
    d2 = ((refs["c6ab_cn1"][1, 1] - cn.min()) ** 2 + (refs["c6ab_cn2"][1, 1] - cn.min()) ** 2)
    assert float(torch.exp(d3.K3 * d2).max()) < 1e-15  # all weights underflow
    got = _port(p, *args)
    _close(got, _jax(jp, *args))


def test_reference_cuda_golden_h2o():
    """The reference CUDA-D3 golden for a distorted H2O molecule
    (tests/test_d3.py:98-118)."""
    at = AtomsLite(positions=np.array([[0.0, 0.2, 0.12], [0.0, 0.76, -0.48],
                                       [0.0, -0.76, -0.48]]),
                   numbers=np.array([8, 1, 1]), cell=None, pbc=False)
    res = d3.D3Calculator(device="cpu").calculate(at)
    assert abs(res["energy"] - (-0.009889134535170716)) < 2e-6
    ref_f = np.array([
        [0.0, 2.04263840e-03, 1.27477674e-03],
        [0.0, -9.90038901e-05, 1.18046682e-06],
        [0.0, -1.94363451e-03, -1.27595721e-03],
    ])
    np.testing.assert_allclose(res["forces"], ref_f, atol=5e-6)
    assert "stress" not in res


def test_reference_cuda_golden_nacl_pbc():
    """The reference CUDA-D3 golden for strained rocksalt NaCl with the full
    ~50 A lattice sum (tests/test_d3.py:121-146): energy, forces, stress."""
    cell = np.array([[1.0, 2.815, 2.815], [2.815, 0.0, 2.815], [2.815, 2.815, 0.0]])
    at = AtomsLite(positions=np.array([[0.0, 0.0, 0.0], [2.815, 0.0, 0.0]]),
                   numbers=np.array([11, 17]), cell=cell, pbc=True)
    res = d3.D3Calculator(device="cpu").calculate(at)
    assert abs(res["energy"] - (-0.531393751583389)) < 5e-5
    ref_f = np.array([[-0.00570205, 0.00107457, 0.00107459],
                      [0.00570205, -0.00107457, -0.00107459]])
    np.testing.assert_allclose(res["forces"], ref_f, atol=2e-5)
    ref_s = np.array([1.52403705e-02, 1.50417333e-02, 1.50417321e-02,
                      -3.22684163e-05, -5.05532863e-05, -5.05586994e-05])
    np.testing.assert_allclose(res["stress"], ref_s, atol=2e-5)


@pytest.mark.parametrize("damping", ["bj", "zero"])
def test_chunks_give_the_unchunked_result(damping):
    """Three or more chunks against one: 1e-6 relative; and against
    autograd of the one-pass ``d3_energy`` (whose per-atom sums stay in
    fp32, as the JAX package's): 1e-5."""
    pos, Z, cell = hfo_box()
    args = _edges(pos, Z, 12.0, cell)
    n_edges = len(args[1])
    p, _ = _params("pbe", damping, 12.0)
    one = _port(p, *args)
    assert d3.chunk_edges(torch.float32) > n_edges  # the default walk is one chunk
    for chunk in (n_edges // 3 + 1, 257):
        assert -(-n_edges // chunk) >= 3
        _close(_port(p, *args, chunk=chunk), one, rel=CHUNK_REL)
    z, dst, src, ev, m = (torch.as_tensor(a) for a in args)
    ev = ev.clone().requires_grad_(True)
    e = d3.d3_energy(p, z, dst, src, ev, m)
    (g,) = torch.autograd.grad(e, ev)
    forces = torch.zeros(len(Z), 3).index_add_(0, dst, g).index_add_(0, src, -g)
    v6 = torch.cat([ev * g, ev[:, [0, 1, 2]] * g[:, [1, 2, 0]]], 1).sum(0)
    _close((float(e.detach()), forces.numpy(), -v6.detach().numpy()), one)


def test_padded_slot_grid_gives_the_unpadded_result():
    """The edges of the Hf/O box scattered into a dense (N_cap, K) slot grid
    as the MD engine holds them: empty slots (sender 0, zero or random
    vectors) and three padded atoms with Z = 0 whose rows are all empty.
    Energy, forces and virial equal the compact list's, with no NaN in the
    energy or in the gradient; the JAX formula multiplies the NaN of such
    slots by 0 and returns NaN."""
    pos, Z, cell = hfo_box()
    numbers, dst, src, ev, _ = _edges(pos, Z, 9.0, cell)
    order = np.argsort(dst, kind="stable")
    dst, src, ev = dst[order], src[order], ev[order]
    n, n_cap = len(Z), len(Z) + 3
    K = int(np.bincount(dst).max()) + 5
    slot = np.arange(len(dst)) - np.searchsorted(dst, dst)  # rank within the receiver's run
    g_src = np.zeros((n_cap, K), np.int64)
    g_ev = np.random.default_rng(1).normal(size=(n_cap, K, 3)).astype(np.float32)
    g_ev[::2, -1] = 0.0
    g_mask = np.zeros((n_cap, K), bool)
    g_src[dst, slot], g_ev[dst, slot], g_mask[dst, slot] = src, ev, True
    grid = (np.concatenate([numbers, np.zeros(3, np.int64)]), np.repeat(np.arange(n_cap), K),
            g_src.ravel(), g_ev.reshape(-1, 3), g_mask.ravel())
    p, jp = _params("pbe", "bj", 9.0)
    want = _port(p, numbers, dst, src, ev, np.ones(len(dst), bool))
    e, f, v = _port(p, *grid)
    assert not f[n:].any()
    _close((e, f[:n], v), want, rel=CHUNK_REL)
    e, f, v = _port(p, *grid, chunk=K * 4 + 3)
    _close((e, f[:n], v), want, rel=CHUNK_REL)
    z, d, s, vec, m = (torch.as_tensor(a) for a in grid)
    vec = vec.clone().requires_grad_(True)
    energy = d3.d3_energy(p, z, d, s, vec, m)
    (g,) = torch.autograd.grad(energy, vec)
    assert torch.isfinite(energy) and torch.isfinite(g).all()
    assert not g[~m].any()
    assert np.isnan(_jax(jp, *grid)[0])


def test_bounded_cutoff_semantics():
    """Opt-in box bound: full cutoff for molecules and large boxes, three
    heights (never below the CN cutoff) for small periodic cells; the same
    value as the JAX package's on a triclinic cell too."""
    p = d3.D3Params.from_functional("pbe", "bj")
    jp = jd3.D3Params.from_functional("pbe", "bj")
    assert d3.bounded_cutoff(p, None, False) == p.cutoff
    assert d3.bounded_cutoff(p, np.eye(3) * 5.0, False) == p.cutoff
    assert d3.bounded_cutoff(p, np.eye(3) * 100.0, (True,) * 3) == p.cutoff
    small = d3.bounded_cutoff(p, np.eye(3) * 5.0, (True,) * 3)
    assert abs(small - max(15.0, p.cn_cutoff)) < 1e-9 and small < p.cutoff
    tri = np.array([[9.0, 0.0, 0.0], [3.0, 8.0, 0.0], [1.0, 2.0, 12.0]])
    for cell in (np.eye(3) * 5.0, np.eye(3) * 9.6, tri, np.eye(3) * 100.0):
        assert d3.bounded_cutoff(p, cell, (True,) * 3) == jd3.bounded_cutoff(jp, cell, True)


@pytest.fixture(scope="module")
def small_model():
    """A narrow Hf/O model (8 channels, lmax 1, 2 layers, cutoff 4 A) with
    the JAX ``model_init`` weights carried across."""
    from sevennet_tpu.model import build_model_spec as j_build
    from sevennet_tpu.model.model import model_init
    from sevennet_tpu_torch.io.convert import params_from_numpy
    from sevennet_tpu_torch.model.build import build_model_spec

    cfg = {"cutoff": 4.0, "channel": 8, "lmax": 1, "is_parity": False,
           "num_convolution_layer": 2, "self_connection_type": "linear",
           "conv_denominator": 20.0, "chemical_species": ["Hf", "O"], "_remat": False}
    jspec = j_build(cfg)
    jparams = model_init(jax.random.PRNGKey(1), jspec)
    spec = build_model_spec(cfg)
    return jspec, jparams, spec, params_from_numpy(spec, jax.tree_util.tree_map(np.asarray,
                                                                               jparams))


@pytest.mark.parametrize("entry", ["with_d3", "d3_calculator"])
def test_model_with_d3_matches_jax(small_model, entry):
    """``SevenNetCalculator.with_d3`` and ``SevenNetD3Calculator`` against
    the JAX ``SevenNetD3Calculator`` at the same weights on the Hf/O box
    (D3 at a 12 A cutoff): energy, forces and stress; the sum is the model's
    plus the D3 calculator's."""
    from sevennet_tpu.calculator import SevenNetD3Calculator as JD3Calc
    from sevennet_tpu.calculator import SevenNetTPUCalculator
    from sevennet_tpu_torch import D3Calculator, SevenNetD3Calculator
    from sevennet_tpu_torch.calculator import SevenNetCalculator

    jspec, jparams, spec, params = small_model
    pos, Z, cell = hfo_box()
    at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
    jcalc = SevenNetTPUCalculator(jspec, jparams, fused=False, matmul_precision="highest")
    want = JD3Calc(jcalc, "pbe", "damp_bj", cutoff_ang=12.0).calculate(at)
    base = SevenNetCalculator(spec, params, device="cpu")
    if entry == "with_d3":
        calc = base.with_d3("pbe", "damp_bj", cutoff_ang=12.0)
    else:
        calc = SevenNetD3Calculator(spec, "pbe", "damp_bj", params=params, device="cpu",
                                    cutoff_ang=12.0)
    assert calc.d3.device == calc.base.device == torch.device("cpu")
    got = calc.calculate(at)
    assert abs(got["energy"] - want["energy"]) <= REL * abs(want["energy"])
    assert got["free_energy"] == got["energy"]
    np.testing.assert_allclose(got["forces"], want["forces"],
                               atol=REL * np.abs(want["forces"]).max())
    np.testing.assert_allclose(got["stress"], want["stress"],
                               atol=REL * np.abs(want["stress"]).max())
    parts = base.calculate(at), D3Calculator(cutoff_ang=12.0, device="cpu").calculate(at)
    assert abs(got["energy"] - sum(r["energy"] for r in parts)) < 1e-9
    np.testing.assert_allclose(got["stress"], parts[0]["stress"] + parts[1]["stress"],
                               atol=1e-12)


def test_d3_runs_on_cuda_unless_asked(small_model, monkeypatch):
    """``D3Calculator`` and ``SevenNetD3Calculator`` default to ``cuda``
    and, without a card, raise rather than drift to the CPU."""
    from sevennet_tpu_torch import SevenNetD3Calculator

    _, _, spec, params = small_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        d3.D3Calculator()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SevenNetD3Calculator(spec, params=params)
    assert d3.D3Calculator(device="cpu").device == torch.device("cpu")
