"""The port's model spec, weight carry-over and single-point calculator
against the JAX package.

The calculator parity runs at full SevenNet-0 width (5 layers,
128x0e+64x1e+32x2e, lmax 2, XPLOR 5.0/4.5) with random weights from
``model_init``, carried across with ``params_from_numpy``, on a small water
box and the HfO2 cell; the reference is ``SevenNetTPUCalculator(fused=False,
matmul_precision="highest")``. The ``_legacy`` models have unnormalized
spherical harmonics (``_normalize_sph: False``, as every checkpoint before
SevenNet 0.10 loads), so the port runs its emb/sh conv; ``sevennet0_vec0``
runs SevenNet-0 through the emb/sh conv under ``SEVENNET_TPU_VEC=0``. Tolerances: energy 1e-5 relative, forces
1e-4 eV/A, stress 1e-6 eV/A^3, atomic virial 1e-4 eV: fp32 on both sides,
sums in a different order (dense mirror sums here, segment sums there).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from sevennet_tpu.atoms import AtomsLite as JAtomsLite
from sevennet_tpu.calculator import SevenNetTPUCalculator
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.io.convert import params_from_numpy, params_to_numpy
from sevennet_tpu_torch.model.build import build_model_spec as t_build
from sevennet_tpu_torch.model.model import _vec_mode

torch.set_num_threads(1)

MID = "128x0e+64x1e+32x2e"
SEVENNET0 = {  # bench.py:110-146, with a species list that covers HfO2
    "lmax": 2,
    "irreps_manual": ["128x0e", MID, MID, MID, MID, "128x0e"],
    "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 4.5},
    "self_connection_type": "linear",
    "cutoff": 5.0,
    "channel": 128,
    "is_parity": False,
    "num_convolution_layer": 5,
    "weight_nn_hidden_neurons": [64, 64],
    "radial_basis": {"radial_basis_name": "bessel", "bessel_basis_num": 8},
    "conv_denominator": 35.0,
    "chemical_species": ["H", "O", "Hf"],
}
# the reference's default model (nequip self-connection, polynomial cutoff,
# parity), narrow
SMALL = {"channel": 8, "lmax": 1, "num_convolution_layer": 3, "cutoff": 4.0,
         "chemical_species": ["Hf", "O"], "shift": [-1.0, -2.0], "scale": [1.5, 0.7]}


def _plain(obj):
    """Specs of both packages as plain Python values (irreps as strings)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if type(obj).__name__ in ("Irreps", "MulIrrep", "Irrep"):
        return str(obj)
    if isinstance(obj, (tuple, list)):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


@pytest.mark.parametrize("cfg", [SEVENNET0, SMALL], ids=["sevennet0", "small"])
def test_build_model_spec_matches_jax(cfg):
    j, t = _plain(j_build(cfg)), _plain(t_build(cfg))
    assert j.keys() == t.keys()
    for name in j:
        assert j[name] == t[name], name


def test_params_from_numpy_round_trip():
    spec = t_build(SEVENNET0)
    tree = jax.tree_util.tree_map(np.asarray, model_init(jax.random.PRNGKey(0), j_build(SEVENNET0)))
    params = params_from_numpy(spec, tree)
    assert params["3_convolution"]["weight_nn"]["w"][2].dtype == torch.float32
    back = params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    tree["1_convolution"]["weight_nn"]["w"][2] = tree["1_convolution"]["weight_nn"]["w"][2][:, :5]
    with pytest.raises(ValueError, match="1_convolution/weight_nn/w"):
        params_from_numpy(spec, tree)


def _water(n_molecules=24, seed=0):
    """bench.py's simple-cubic water box at 1 g/cm^3."""
    box = (n_molecules * 18.015 / (6.02214076e23 * 1.0)) ** (1 / 3) * 1e8
    n_side = int(np.ceil(n_molecules ** (1 / 3)))
    a = box / n_side
    pos, Z = [], []
    for idx in range(n_molecules):
        i, j, k = np.unravel_index(idx, (n_side,) * 3)
        o = (np.array([i, j, k]) + 0.5) * a
        pos += [o, o + [0.757, 0.586, 0.0], o + [-0.757, 0.586, 0.0]]
        Z += [8, 1, 1]
    pos = np.asarray(pos) + np.random.default_rng(seed).normal(scale=0.01, size=(len(pos), 3))
    return pos, np.asarray(Z), np.eye(3) * box


CONFIGS = {"sevennet0": SEVENNET0, "small": SMALL,
           "sevennet0_legacy": dict(SEVENNET0, _normalize_sph=False),
           "small_legacy": dict(SMALL, _normalize_sph=False)}


@functools.lru_cache(maxsize=None)
def _calculators(name):
    cfg = CONFIGS[name]
    jspec = j_build(cfg)
    jparams = model_init(jax.random.PRNGKey(7), jspec)
    # nontrivial shift/scale so the rescale path is exercised
    rs = jparams["rescale_atomic_energy"]
    rs["shift"], rs["scale"] = rs["shift"] - 2.5, rs["scale"] * 1.7
    ref = SevenNetTPUCalculator(jspec, jparams, fused=False, matmul_precision="highest")
    port = SevenNetCalculator(
        t_build(cfg), params_from_numpy(t_build(cfg), jax.tree_util.tree_map(np.asarray, jparams)),
        device="cpu",
    )
    return ref, port


@pytest.mark.parametrize("name,system", [
    ("sevennet0", "water"), ("sevennet0", "hfo2"), ("small", "hfo2"),
    ("sevennet0_legacy", "water"), ("small_legacy", "hfo2"), ("sevennet0_vec0", "water"),
])
def test_calculator_matches_jax(name, system, hfo2_structure, monkeypatch):
    vec0 = name.endswith("_vec0")
    if vec0:
        monkeypatch.setenv("SEVENNET_TPU_VEC", "0")
        name = name[: -len("_vec0")]
    ref, port = _calculators(name)
    assert _vec_mode(port.spec) == (not vec0 and not name.endswith("_legacy"))
    if system == "water":
        pos, Z, cell = _water()
    else:
        pos, Z, cell = hfo2_structure
    r = ref.calculate(JAtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    p = port.calculate(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    assert abs(p["energy"] - r["energy"]) <= 1e-5 * abs(r["energy"])
    np.testing.assert_allclose(p["energies"], r["energies"], atol=1e-5 * abs(r["energy"]))
    np.testing.assert_allclose(p["forces"], r["forces"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(p["stress"], r["stress"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(p["atomic_virial"], r["atomic_virial"], atol=1e-4, rtol=0)
    # the forces are not trivially small, and sum to zero under PBC
    assert np.abs(r["forces"]).max() > 1e-3
    assert np.abs(p["forces"].sum(0)).max() < 1e-4


@pytest.mark.parametrize("name", ["sevennet0", "small"])
def test_molecule_has_no_stress(name):
    ref, port = _calculators(name)
    Z = [8, 8] if name == "small" else [8, 1]
    at = AtomsLite(positions=[[0, 0, 0], [1.1, 0.2, 0.0]], numbers=Z)
    p = port.calculate(at)
    r = ref.calculate(JAtomsLite(positions=at.positions, numbers=Z))
    assert "stress" not in p
    np.testing.assert_allclose(p["forces"], r["forces"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(p["forces"][0], -p["forces"][1], atol=1e-6)
