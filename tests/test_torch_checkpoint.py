"""The port's reader of stock SevenNet ``.pth`` checkpoints
(``sevennet_tpu_torch/io/torch_checkpoint.py``) against the JAX package's
(``sevennet_tpu/io/torch_checkpoint.py``).

The checkpoint is made here: a small model initialised by the JAX package,
exported with its ``state_dict_from_params``, renamed to the pre-2024
module names (``"0 convolution"``, ``denumerator``, ...), with a config of
version 0.9.5 that names no ``_normalize_sph`` (so it loads with
unnormalized spherical harmonics and pre-0.11 weight order) and a stored
Wigner 3j of the other sign. Both packages load it; the specs must agree
field by field, the parameters exactly, and the calculators to the
tolerances of tests/test_torch_model.py (energy 1e-5 relative, forces 1e-4
eV/A, stress 1e-6 eV/A^3).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sevennet_tpu.atoms import AtomsLite as JAtomsLite
from sevennet_tpu.calculator import SevenNetTPUCalculator
from sevennet_tpu.io import torch_checkpoint as jtc
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu.so3.wigner import real_wigner_3j
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.io import torch_checkpoint as tc
from sevennet_tpu_torch.io.convert import params_to_numpy
from sevennet_tpu_torch.io.native_checkpoint import load_checkpoint

torch.set_num_threads(1)

MODEL = {"channel": 4, "lmax": 2, "num_convolution_layer": 3, "cutoff": 4.0,
         "chemical_species": ["Hf", "O"], "is_parity": True, "shift": [-1.0, -2.0],
         "scale": [1.5, 0.7], "conv_denominator": 8.0}
LEGACY = {"EdgeEmbedding": "edge_embedding",
          "reducing nn input to hidden": "reduce_input_to_hidden",
          "reducing nn hidden to energy": "reduce_hidden_to_energy",
          "rescale atomic energy": "rescale_atomic_energy"}
for _t in range(MODEL["num_convolution_layer"]):
    for _name in ("self connection intro", "self interaction 1", "convolution",
                  "self interaction 2"):
        LEGACY[f"{_t} {_name}"] = f"{_t}_{_name.replace(' ', '_')}"


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


@pytest.fixture(scope="module")
def legacy_pth(tmp_path_factory):
    jparams = model_init(jax.random.PRNGKey(11), j_build(dict(MODEL, _normalize_sph=False)))
    sd = jtc.state_dict_from_params(j_build(MODEL), jparams)
    new_to_old = {v: k for k, v in LEGACY.items()}
    legacy = {}
    for k, v in sd.items():
        head, _, tail = k.partition(".")
        legacy[new_to_old.get(head, head) + "." + tail.replace("denominator", "denumerator")] = (
            torch.tensor(np.asarray(v)))
    # a Wigner 3j stored with the other sign: the loaders flip its weight block
    legacy["1 convolution.convolution._compiled_main_left_right._w3j_1_1_1"] = torch.tensor(
        -np.asarray(real_wigner_3j(1, 1, 1)))
    config = {k: v for k, v in MODEL.items() if k not in ("shift", "scale", "conv_denominator")}
    config.update(version="0.9.5", shift="per_atom_energy_mean", scale="force_rms",
                  conv_denominator="avg_num_neigh", train_avg_num_neigh=False)
    path = tmp_path_factory.mktemp("cp") / "checkpoint_legacy.pth"
    torch.save({"model_state_dict": legacy, "config": config}, str(path))
    return str(path)


def test_legacy_pth_loads_like_jax(legacy_pth, hfo2_structure):
    jspec, jparams = jtc.load_sevennet_checkpoint(legacy_pth)
    spec, params = tc.load_sevennet_checkpoint(legacy_pth)
    assert spec.normalize_sph is False
    # the pre-0.11 weight order differs from the sorted one: the permutation runs
    assert any(tuple(i[:3] for i in layer.conv.instructions) != layer.conv.instructions_enum
               for layer in spec.layers)
    j, t = _plain(jspec), _plain(spec)
    assert j.keys() == t.keys()
    for name in j:
        assert j[name] == t[name], name
    jtree = jax.tree_util.tree_map(np.asarray, jparams)
    ttree = params_to_numpy(params)
    assert jax.tree_util.tree_structure(jtree) == jax.tree_util.tree_structure(ttree)
    for a, b in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(ttree)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # the same through the port's universal loader
    spec2, params2, meta = load_checkpoint(legacy_pth)
    assert spec2 == spec and meta["format"] == "sevenn_torch"
    # and back: the port's export equals the JAX package's
    want = jtc.state_dict_from_params(jspec, jparams)
    got = tc.state_dict_from_params(spec, params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)

    pos, Z, cell = hfo2_structure
    r = SevenNetTPUCalculator(jspec, jparams, fused=False, matmul_precision="highest").calculate(
        JAtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    p = SevenNetCalculator(spec, params, device="cpu").calculate(
        AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    assert abs(p["energy"] - r["energy"]) <= 1e-5 * abs(r["energy"])
    np.testing.assert_allclose(p["forces"], r["forces"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(p["stress"], r["stress"], atol=1e-6, rtol=0)
    assert np.abs(r["forces"]).max() > 1e-3


def test_legacy_patches_match_jax():
    """The legacy renames and config patches give what the JAX package's
    give (the inputs of ``tests/test_checkpoint.py``)."""
    sd = {
        "EdgeEmbedding.basis_function.coeffs": np.zeros(8),
        "0 self interaction 1.linear.weight": np.zeros(4),
        "0 convolution.denumerator": np.asarray([12.0]),
        "rescale atomic energy.shift": np.asarray([0.1]),
        "onehot_to_feature_x.linear.weight": np.zeros(2),
    }
    assert tc.patch_old_state_dict(sd).keys() == jtc.patch_old_state_dict(sd).keys()
    for cfg in ({"version": "0.9.3", "train_avg_num_neigh": True,
                 "cutoff_function": {"cutoff_function_name": "XPLOR", "poly_cut_p_value": 6,
                                     "cutoff_on": 4.5}},
                {"version": "0.11.0", "conv_denominator": 35.0}):
        assert tc.patch_old_config(cfg) == jtc.patch_old_config(cfg)
    assert tc.patch_old_config({"version": "0.9.3"})["_normalize_sph"] is False
    with pytest.raises(ValueError, match="optimize_by_reduce"):
        tc.patch_old_config({"version": "0.9.3", "optimize_by_reduce": False})
