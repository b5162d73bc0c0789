"""The port's importer of frozen TorchScript deployments
(``sevennet_tpu_torch/io/torchscript_import.py``) against the JAX
package's (``sevennet_tpu/io/torchscript_import.py``).

The artifacts are written here by ``tests/torch_deployed_artifact.py``
from a small model with random weights (3 layers, lmax 2, channel 4, 8
Bessel functions, radial MLP [16, 16]): the channel count stays away from
the Bessel count, because the importers' hidden-width scan misreads the
stream when the two are equal. The same file goes to both importers; the
configs must be equal, the state dicts and parameters bitwise equal, the
parameters within 1e-6 relative of the weights written (fp32 rounding of
the path norms' round trip), and the two models' energy, forces and stress
within the tolerances of tests/test_torch_model.py (energy 1e-5 relative,
forces 1e-4 eV/A, stress 1e-6 eV/A^3).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sevennet_tpu.atoms import AtomsLite as JAtomsLite
from sevennet_tpu.calculator import SevenNetTPUCalculator
from sevennet_tpu.io import torch_checkpoint as jtc
from sevennet_tpu.io import torchscript_import as jti
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.io import torchscript_import as ti
from sevennet_tpu_torch.io.convert import params_from_numpy, params_to_numpy, random_params
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.train.trainer import tree_leaves

from .torch_deployed_artifact import write_deployed

torch.set_num_threads(1)

# channel 4, Bessel count 8: kept apart (see the module docstring)
MODEL = {"channel": 4, "lmax": 2, "num_convolution_layer": 3, "cutoff": 4.0,
         "chemical_species": ["Hf", "O"], "weight_nn_hidden_neurons": [16, 16],
         "radial_basis": {"radial_basis_name": "bessel", "bessel_basis_num": 8},
         "conv_denominator": [5.0, 6.0, 7.0], "shift": -1.2, "scale": 0.8}
SCALED = ("0_self_interaction_1.linear.weight",
          "1_self_connection_intro.fc_tensor_product.weight",
          "reduce_input_to_hidden.linear.weight")
FLIPS = ((1, 1, 2), (2, 1, 1), (1, 2, 2))
CASES = {
    # (a) 0.11.0, every denominator distinct
    "v0.11": ({}, {}),
    # (b) equal denominators: freezing pools them into one constant
    "pooled": ({"conv_denominator": 8.0}, {}),
    # (c) explicit aten::mul scales on the data operands of three entries
    "scaled": ({}, {"scaled": SCALED, "scale": 2.5}),
    # (d) pre-0.11: construction-order columns, Wigner tables, some negated
    "v0.10": ({}, {"version": "0.10.0", "old": True, "flips": FLIPS}),
    "v0.9": ({}, {"version": "0.9.5", "old": True, "flips": FLIPS}),
    # (e) a species-wise (n,) rescale
    "specieswise": ({"shift": [-1.2, 0.3], "scale": [0.8, 1.1]}, {}),
}
# a SevenNet-0 layout at small width: per-layer irreps and the XPLOR cutoff,
# which a deployment's metadata does not record
S0_LAYOUT = {"lmax": 2, "irreps_manual": ["12x0e"] + ["12x0e+4x1e+2x2e"] * 2 + ["12x0e"],
             "cutoff_function": {"cutoff_function_name": "XPLOR", "cutoff_on": 3.5},
             "self_connection_type": "linear", "cutoff": 4.0, "channel": 12,
             "is_parity": False, "num_convolution_layer": 3,
             "weight_nn_hidden_neurons": [16, 16], "conv_denominator": 35.0,
             "chemical_species": ["Hf", "O"]}
S0_GIVEN = {"irreps_manual": S0_LAYOUT["irreps_manual"],
            "cutoff_function": S0_LAYOUT["cutoff_function"], "_full_last_layer": False}


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


def _model(model, seed):
    spec = build_model_spec(model)
    return spec, params_from_numpy(spec, random_params(spec, seed))


@pytest.fixture(scope="module", params=list(CASES))
def imported(request, tmp_path_factory):
    """One case's artifact, the weights written, and both importers' results."""
    overrides, kw = CASES[request.param]
    spec, params = _model(dict(MODEL, **overrides), seed=3)
    path = str(tmp_path_factory.mktemp("deployed") / f"{request.param}.pt")
    stream = write_deployed(path, spec, params, **kw)
    return dict(case=request.param, path=path, spec=spec, params=params, stream=stream,
                jax=jti.load_deployed_model(path, return_state=True),
                port=ti.load_deployed_model(path, return_state=True))


def test_writer_follows_jax_expected_entries(imported):
    """The writer's constants (Wigner tables aside, denominators before
    freezing pools them) have the keys, shapes and order of the JAX
    importer's expected entries for the model written."""
    jspec = j_build(dict(imported["jax"][2]))
    want = [(key, tuple(shape)) for key, shapes, _, _ in jti._expected_entries(jspec)
            for shape in shapes]
    got = [(key, c.shape) for key, c, _ in imported["stream"] if key is not None]
    spec = imported["spec"]
    # a species-wise rescale has (n,) where the entries say (1,)
    n = len(spec.type_map) if imported["case"] == "specieswise" else 1
    want = [(k, (n,) if k.startswith("rescale_atomic_energy") else s) for k, s in want]
    assert got == want


def test_frozen_stream(imported):
    """What each case is about shows in the frozen graph: pooled or
    distinct denominators, the explicit scales, the Wigner tables."""
    consts = ti._ordered_constants(torch.jit.load(imported["path"]))
    assert [(c.shape, s) for c, s in consts] == [
        (c.shape, s) for c, s in jti._ordered_constants(torch.jit.load(imported["path"]))]
    n_layers = len(imported["spec"].layers)
    ones = sum(c.shape == (1,) for c, _ in consts)
    case = imported["case"]
    assert ones == (1 if case == "pooled" else n_layers) + (0 if case == "specieswise" else 2)
    scales = sorted({s for _, s in consts})
    assert scales == ([1.0, 2.5] if case == "scaled" else [1.0])
    n_w3j = sum(ti._is_w3j(c) for c, _ in consts)
    old = case in ("v0.10", "v0.9")
    assert (n_w3j > 0) == old
    if old:
        # the pre-0.11 order differs from the sorted one: the permutation runs
        assert any(tuple(i[:3] for i in layer.conv.instructions) != layer.conv.instructions_enum
                   for layer in imported["spec"].layers)


def test_import_matches_jax(imported, hfo2_structure):
    """Equal configs and specs, bitwise state dicts and parameters, the
    weights written recovered, and the two models' results."""
    jspec, jparams, jcfg, jsd = imported["jax"]
    spec, params, cfg, sd = imported["port"]
    assert cfg == jcfg
    j, t = _plain(jspec), _plain(spec)
    assert j.keys() == t.keys()
    for name in j:
        assert j[name] == t[name], name
    assert sd.keys() == jsd.keys()
    for k in jsd:
        a, b = np.asarray(jsd[k]), np.asarray(sd[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    jtree = jax.tree_util.tree_map(np.asarray, jparams)
    ttree = params_to_numpy(params)
    assert jax.tree_util.tree_structure(jtree) == jax.tree_util.tree_structure(ttree)
    for a, b in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(ttree)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b, a)
    for got, want in zip(tree_leaves(params), tree_leaves(imported["params"])):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())

    pos, Z, cell = hfo2_structure
    r = SevenNetTPUCalculator(jspec, jparams, fused=False, matmul_precision="highest").calculate(
        JAtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    p = SevenNetCalculator(spec, params, device="cpu").calculate(
        AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    assert abs(p["energy"] - r["energy"]) <= 1e-5 * abs(r["energy"])
    np.testing.assert_allclose(p["forces"], r["forces"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(p["stress"], r["stress"], atol=1e-6, rtol=0)
    assert np.abs(r["forces"]).max() > 1e-3


@pytest.mark.parametrize("kind", ["unmatched", "ambiguous"])
def test_no_single_candidate_raises(kind, tmp_path):
    """A stream no candidate matches (one stray weight appended), and one
    two candidates match (two layers of lmax 1, where parity changes no
    shape): both importers raise ``ValueError``."""
    if kind == "unmatched":
        spec, params = _model(MODEL, seed=4)
        stream = write_deployed(tmp_path / "a.pt", spec, params)
        stream.insert(-2, ("stray", np.full((3, 5), 0.25, np.float32), 1.0))
        from .torch_deployed_artifact import _Deployed

        frozen = torch.jit.freeze(torch.jit.trace(_Deployed(stream).eval(), torch.tensor(1.0)))
        meta = ti.deployed_metadata(str(tmp_path / "a.pt"))
        torch.jit.save(frozen, str(tmp_path / "a.pt"), _extra_files=meta)
        match = "no architecture candidate"
    else:
        spec, params = _model(dict(MODEL, lmax=1, num_convolution_layer=2,
                                   conv_denominator=[5.0, 6.0]), seed=4)
        write_deployed(tmp_path / "a.pt", spec, params)
        match = "ambiguous architecture"
    for load in (jti.load_deployed_model, ti.load_deployed_model):
        with pytest.raises(ValueError, match=match):
            load(str(tmp_path / "a.pt"))


def test_metadata_matches_jax(tmp_path):
    spec, params = _model(MODEL, seed=5)
    write_deployed(tmp_path / "a.pt", spec, params, version="0.11.2")
    meta = ti.deployed_metadata(str(tmp_path / "a.pt"))
    assert meta == jti.deployed_metadata(str(tmp_path / "a.pt"))
    assert meta["chemical_symbols_to_index"] == "Hf O" and meta["version"] == "0.11.2"
    assert float(meta["cutoff"]) == MODEL["cutoff"]


def test_sevennet0_layout_needs_its_config(tmp_path, hfo2_structure):
    """SevenNet-0's per-layer irreps and XPLOR cutoff are not in a
    deployment's metadata: both importers find no candidate. Given them
    (``config``; the last layer fixed, since without parity a full last
    layer of scalar irreps is the same model), the port recovers the model
    written; its walk of the stream is bitwise the JAX importer's
    ``_try_match`` on the JAX spec of the same config, and both models
    agree."""
    spec0, params0 = _model(S0_LAYOUT, seed=6)
    path = str(tmp_path / "s0.pt")
    write_deployed(path, spec0, params0)
    for load in (jti.load_deployed_model, ti.load_deployed_model):
        with pytest.raises(ValueError, match="no architecture candidate"):
            load(path)
    with pytest.raises(ValueError, match="ambiguous"):
        ti.load_deployed_model(path, config={k: v for k, v in S0_GIVEN.items()
                                             if k != "_full_last_layer"})
    spec, params, cfg, sd = ti.load_deployed_model(path, return_state=True, config=S0_GIVEN)
    assert spec == spec0
    for got, want in zip(tree_leaves(params), tree_leaves(params0)):
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())

    module = torch.jit.load(path)
    consts = [(t, s) for t, s in jti._ordered_constants(module) if not jti._is_w3j(t)]
    base = {k: v for k, v in cfg.items()
            if k not in ("shift", "scale", "conv_denominator")}
    jspec = j_build(base)
    jsd = jti._try_match(jspec, consts)
    assert jsd is not None and jsd.keys() == sd.keys()
    for k in jsd:
        np.testing.assert_array_equal(np.asarray(sd[k]), np.asarray(jsd[k]), err_msg=k)
    jspec = j_build(jtc.spec_config_from_checkpoint(base, jsd))
    jparams = jtc.params_from_torch_state_dict(jspec, jsd)

    pos, Z, cell = hfo2_structure
    r = SevenNetTPUCalculator(jspec, jparams, fused=False, matmul_precision="highest").calculate(
        JAtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True))
    at = AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)
    p = SevenNetCalculator(spec, params, device="cpu").calculate(at)
    p0 = SevenNetCalculator(spec0, params0, device="cpu").calculate(at)
    for want in (r, p0):
        assert abs(p["energy"] - want["energy"]) <= 1e-5 * abs(want["energy"])
        np.testing.assert_allclose(p["forces"], want["forces"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(p["stress"], want["stress"], atol=1e-6, rtol=0)
    assert np.abs(r["forces"]).max() > 1e-3
