"""The port's ``BatchedCalculator`` (one dense batch, ``sevennet_tpu_torch/
batched.py``) against the JAX package's (the flat edge list): water boxes
of 24, 36 and 48 atoms and a 9-atom cluster without a cell in one call,
energies 1e-5 relative, forces 1e-4 eV/A, atomic energies 1e-5 eV and
stress 1e-6 eV/A^3 (the tolerances of tests/test_torch_model.py). The
model comes from a checkpoint directory of the JAX package, which both
calculators load by path; the port's batch equals single requests of
``SevenNetCalculator``."""

import jax
import numpy as np
import pytest

from bench import water_box
from sevennet_tpu.atoms import AtomsLite as JAtomsLite
from sevennet_tpu.batched import BatchedCalculator as JBatchedCalculator
from sevennet_tpu.io.native_checkpoint import save_checkpoint as j_save_checkpoint
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.batched import BatchedCalculator
from sevennet_tpu_torch.calculator import SevenNetCalculator

MODEL = {"cutoff": 3.0, "channel": 8, "lmax": 1, "is_parity": False,
         "num_convolution_layer": 2, "self_connection_type": "linear",
         "conv_denominator": 8.0, "chemical_species": ["H", "O"]}


def _structures():
    out = []
    for n_mol, seed in ((8, 0), (12, 1), (16, 2)):
        pos, Z, cell = water_box(n_mol, seed=seed)
        out.append((pos, Z, cell))
    rng = np.random.default_rng(3)
    out.append((rng.uniform(0, 4.0, (9, 3)), np.array([8, 1, 1] * 3), None))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "model")
    jspec = j_build(MODEL)
    j_save_checkpoint(path, MODEL, model_init(jax.random.PRNGKey(0), jspec))
    structs = _structures()
    jres = JBatchedCalculator(path).calculate(
        [JAtomsLite(positions=p, numbers=z, cell=c, pbc=c is not None) for p, z, c in structs])
    calc = BatchedCalculator(path, device="cpu")
    ats = [AtomsLite(positions=p, numbers=z, cell=c, pbc=c is not None) for p, z, c in structs]
    return calc, ats, calc.calculate(ats), jres


def test_batched_matches_jax(both):
    _, ats, res, jres = both
    assert len(res) == len(jres) == 4
    for r, j, at in zip(res, jres, ats):
        assert abs(r["energy"] - j["energy"]) <= 1e-5 * abs(j["energy"])
        assert r["forces"].shape == (len(at), 3)
        np.testing.assert_allclose(r["forces"], j["forces"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["energies"], j["energies"], rtol=0, atol=1e-5)
        assert ("stress" in r) == ("stress" in j) == (at.cell is not None)
        if "stress" in r:
            np.testing.assert_allclose(r["stress"], j["stress"], rtol=0, atol=1e-6)


def test_batched_equals_single_requests(both):
    calc, ats, res, _ = both
    single = SevenNetCalculator(calc.spec, calc.params, device="cpu")
    for r, at in zip(res, ats):
        s = single.calculate(at)
        assert abs(r["energy"] - s["energy"]) <= 1e-5 * abs(s["energy"])
        np.testing.assert_allclose(r["forces"], s["forces"], rtol=0, atol=1e-4)
        if "stress" in r:
            np.testing.assert_allclose(r["stress"], s["stress"], rtol=0, atol=1e-6)


def test_batched_pads_like_jax(both):
    """Atoms padded to a multiple of 64 (one more atom at least), one
    padding graph."""
    calc, ats, _, _ = both
    _, gb = calc.batch(ats)
    n = sum(len(a) for a in ats)
    assert gb.n_atoms_cap == -(-(n + 1) // 64) * 64
    assert gb.n_graphs_cap == len(ats) + 1
    assert int(gb.atom_mask.sum()) == n and not bool(gb.graph_mask[-1])


def test_batched_refuses_the_cpu_without_asking(both, monkeypatch):
    import torch

    calc = both[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedCalculator(calc.spec, calc.params)
