"""Checkpoints and model resolution in the port: a checkpoint the JAX
package wrote (``sevennet_tpu/io/native_checkpoint.py:save_checkpoint``,
msgpack through flax) read by the port without flax or msgpack, pretrained
names resolved over local search directories
(``sevennet_tpu_torch/io/registry.py``), and the calculator built from a
name, a path or a spec with its parameters.

Tolerances: parameters read from the JAX checkpoint bitwise equal to those
carried across with ``params_from_numpy``; a request served from the
checkpoint within 1e-5 (energy relative, forces eV/A) of the JAX
calculator on the same weights (fp32 on both sides, sums in another
order); the port's own paths bitwise equal to each other.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from sevennet_tpu.calculator import SevenNetTPUCalculator as JCalculator
from sevennet_tpu.io.native_checkpoint import save_checkpoint as j_save
from sevennet_tpu.model.build import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.data.extxyz import write_extxyz
from sevennet_tpu_torch.io import load_checkpoint, load_model, resolve_checkpoint
from sevennet_tpu_torch.io.convert import params_from_numpy
from sevennet_tpu_torch.io.native_checkpoint import load_native_checkpoint, save_checkpoint
from sevennet_tpu_torch.io.registry import get_available_pretrained_models
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.scripts.train import train_run
from sevennet_tpu_torch.train.trainer import tree_leaves

torch.set_num_threads(1)
MODEL = {"cutoff": 4.0, "channel": 4, "lmax": 1, "is_parity": False,
         "num_convolution_layer": 2, "chemical_species": ["H", "O"],
         "self_connection_type": "linear", "conv_denominator": 6.0,
         "shift": -1.2, "scale": 0.8}


def _atoms(seed=9, n=8):
    rng = np.random.default_rng(seed)
    return AtomsLite(positions=rng.uniform(0, 7, (n, 3)), numbers=[8, 1] * (n // 2),
                     cell=np.eye(3) * 7.0, pbc=True)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint directory written by the JAX package (weights and an
    Adam state), and its parameters as numpy."""
    path = str(tmp_path_factory.mktemp("jax") / "checkpoint_last")
    spec = j_build(MODEL)
    params = model_init(jax.random.PRNGKey(7), spec)
    opt_state = optax.adam(1e-3).init(params)
    j_save(path, dict(MODEL), params, opt_state, epoch=3, extra={"best": 0.5})
    return path, jax.tree_util.tree_map(np.asarray, params)


def test_reads_jax_checkpoint(jax_checkpoint):
    """The port's reader against the weights the JAX package saved: every
    parameter bitwise equal to ``params_from_numpy`` of the JAX tree; the
    config, epoch and extras as saved; the optimizer state a tree."""
    path, tree = jax_checkpoint
    cfg, params, opt_state, meta = load_native_checkpoint(path)
    assert meta["format"] == "sevennet_tpu.v1" and meta["epoch"] == 3
    assert meta["extra"] == {"best": 0.5} and cfg["channel"] == MODEL["channel"]
    assert isinstance(opt_state, dict) and opt_state
    spec, got, _ = load_checkpoint(path)
    assert spec == build_model_spec(MODEL)
    want = params_from_numpy(spec, tree)
    assert len(tree_leaves(got)) == len(tree_leaves(want)) == len(jax.tree_util.tree_leaves(tree))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_serves_jax_checkpoint(jax_checkpoint):
    """A request served from the JAX checkpoint's directory (and from its
    ``params.msgpack``) against the JAX calculator on the same weights."""
    path, tree = jax_checkpoint
    at = _atoms()
    want = JCalculator(j_build(MODEL), jax.tree_util.tree_map(jax.numpy.asarray, tree),
                       fused=False).calculate(at)
    for model in (path, os.path.join(path, "params.msgpack")):
        got = SevenNetCalculator(model, device="cpu").calculate(at)
        assert got["energy"] == pytest.approx(want["energy"], rel=1e-5)
        np.testing.assert_allclose(got["forces"], want["forces"], atol=1e-5)
        np.testing.assert_allclose(got["stress"], want["stress"], atol=1e-6)


def test_continue_from_jax_checkpoint(jax_checkpoint, tmp_path):
    """``train_run`` continues from a JAX checkpoint's weights with a fresh
    optimizer, and refuses to carry its optax state over."""
    path, _ = jax_checkpoint
    rng = np.random.default_rng(1)
    data = str(tmp_path / "d.extxyz")
    write_extxyz(data, [AtomsLite(positions=rng.uniform(0, 6, (6, 3)),
                                  numbers=rng.choice([8, 1], 6), cell=np.eye(3) * 6.0,
                                  pbc=True, energy=-7.0, forces=rng.normal(size=(6, 3)) * 0.1,
                                  stress=rng.normal(size=6) * 1e-3) for _ in range(4)])
    dcfg = {"load_trainset_path": [data], "batch_size": 2}
    with pytest.raises(ValueError, match="reset_optimizer"):
        train_run(dict(MODEL), {"continue": {"checkpoint": path}}, dict(dcfg),
                  str(tmp_path / "a"), 1, device="cpu")
    trainer = train_run(dict(MODEL), {"continue": {"checkpoint": path, "reset_optimizer": True}},
                        dict(dcfg), str(tmp_path / "b"), 1, device="cpu")
    assert trainer.step == 2
    assert load_native_checkpoint(str(tmp_path / "b" / "checkpoint_last"))[3]["epoch"] == 4


@pytest.fixture
def search_dirs(tmp_path, monkeypatch):
    """An empty ``$SEVENN_TPU_CHECKPOINT_DIR`` and an empty home."""
    env, home = tmp_path / "env", tmp_path / "home"
    env.mkdir()
    home.mkdir()
    monkeypatch.setenv("SEVENN_TPU_CHECKPOINT_DIR", str(env))
    monkeypatch.setenv("HOME", str(home))
    return env, home


def test_resolve_checkpoint(search_dirs, tmp_path):
    """Paths pass through; names resolve to the first search directory
    holding their file or checkpoint directory (flat, under the name, or
    one subdirectory deep); a missing name lists every path searched; an
    unknown one lists the known names."""
    env, home = search_dirs
    assert resolve_checkpoint(str(tmp_path)) == str(tmp_path)
    with pytest.raises(FileNotFoundError, match="known: .*sevennet-mf-ompa"):
        resolve_checkpoint("7net-nope")
    with pytest.raises(FileNotFoundError, match="'sevennet-0' not found") as err:
        resolve_checkpoint("7net-0")
    msg = str(err.value)
    for d in (str(env), os.path.join(str(home), ".cache", "sevennet_tpu"),
              os.path.join(str(home), ".cache", "sevennet")):
        assert os.path.join(d, "checkpoint_sevennet_0.pth") in msg
        assert os.path.join(d, "sevennet-0", "checkpoint_sevennet_0.pth") in msg
    with pytest.raises(FileNotFoundError, match="releases/download/v0.11.0.cp"):
        resolve_checkpoint("SevenNet-MF-ompa")
    cache = home / ".cache" / "sevennet" / "SevenNet_0__11Jul2024"
    cache.mkdir(parents=True)
    (cache / "checkpoint_sevennet_0.pth").write_bytes(b"")
    assert resolve_checkpoint("7net-0") == str(cache / "checkpoint_sevennet_0.pth")
    (env / "checkpoint_sevennet_0").mkdir()  # a checkpoint directory, the earlier dir wins
    for name in ("7net-0", "SevenNet-0", "sevennet-0_11Jul2024"):
        assert resolve_checkpoint(name) == str(env / "checkpoint_sevennet_0")
    assert "sevennet-l3i5" in get_available_pretrained_models()


def test_calculator_by_name(search_dirs):
    """A port checkpoint saved under a registry base name serves by name,
    bit for bit as the spec-and-params calculator on the same weights;
    the calculator refuses mixed arguments and, without CUDA, a missing
    device."""
    env, _ = search_dirs
    spec = build_model_spec(MODEL)
    tree = jax.tree_util.tree_map(np.asarray, model_init(jax.random.PRNGKey(2), j_build(MODEL)))
    params = params_from_numpy(spec, tree)
    save_checkpoint(str(env / "checkpoint_sevennet_0"), dict(MODEL), params)
    spec2, params2 = load_model("7net-0")
    assert spec2 == spec
    at = _atoms(seed=4)
    want = SevenNetCalculator(spec, params, device="cpu").calculate(at)
    got = SevenNetCalculator("7net-0", device="cpu").calculate(at)
    assert got["energy"] == want["energy"]
    np.testing.assert_array_equal(got["forces"], want["forces"])
    np.testing.assert_array_equal(got["stress"], want["stress"])
    with pytest.raises(ValueError, match="needs its params"):
        SevenNetCalculator(spec, device="cpu")
    with pytest.raises(ValueError, match="params go with a ModelSpec"):
        SevenNetCalculator("7net-0", params, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SevenNetCalculator("7net-0")


def test_as_ase_without_ase_raises(monkeypatch):
    """Without ASE, ``as_ase`` raises an ImportError that names it."""
    import sys

    monkeypatch.setitem(sys.modules, "ase", None)
    monkeypatch.setitem(sys.modules, "ase.calculators", None)
    monkeypatch.setitem(sys.modules, "ase.calculators.calculator", None)
    spec = build_model_spec(MODEL)
    tree = jax.tree_util.tree_map(np.asarray, model_init(jax.random.PRNGKey(2), j_build(MODEL)))
    calc = SevenNetCalculator(spec, params_from_numpy(spec, tree), device="cpu")
    with pytest.raises(ImportError, match="'ase'"):
        calc.as_ase()


def test_as_ase_serves():
    """With ASE installed: the ASE calculator gives the port's results."""
    ase = pytest.importorskip("ase")
    spec = build_model_spec(MODEL)
    tree = jax.tree_util.tree_map(np.asarray, model_init(jax.random.PRNGKey(2), j_build(MODEL)))
    calc = SevenNetCalculator(spec, params_from_numpy(spec, tree), device="cpu")
    at = _atoms(seed=5)
    atoms = ase.Atoms(numbers=at.numbers, positions=at.positions, cell=at.cell, pbc=True)
    atoms.calc = calc.as_ase()
    assert atoms.get_potential_energy() == calc.calculate(at)["energy"]
