"""The port's command line (``sevennet_tpu_torch/cli/main.py``, the
``sevennet-tpu-torch`` console script) against the JAX package's
``sevennet-tpu``: ``preset`` prints the same text for every preset;
``checkpoint`` (and ``--get_yaml``) the same output for a checkpoint
directory that both read; ``get_model`` writes the port's format and keeps
the parameters bitwise (from the JAX package's directory and from the
port's); ``graph_build`` writes the same statistics; ``inference``, ``train``
and ``md`` run from files written here (``train`` and ``md`` from YAML),
on the CPU with ``--device cpu``."""

import json
import os

import jax
import numpy as np
import pytest

from bench import water_box
from sevennet_tpu.cli.main import PRESETS as J_PRESETS
from sevennet_tpu.cli.main import main as j_main
from sevennet_tpu.io.native_checkpoint import save_checkpoint as j_save_checkpoint
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.cli.main import PRESETS, main
from sevennet_tpu_torch.data.extxyz import write_extxyz
from sevennet_tpu_torch.io.native_checkpoint import FORMAT, load_checkpoint
from sevennet_tpu_torch.io.registry import load_model
from sevennet_tpu_torch.train.trainer import tree_leaves

MODEL = {"cutoff": 3.0, "channel": 8, "lmax": 1, "is_parity": False,
         "num_convolution_layer": 2, "self_connection_type": "linear",
         "conv_denominator": 8.0, "chemical_species": ["H", "O"]}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ckpt = str(d / "model")
    j_save_checkpoint(ckpt, MODEL, model_init(jax.random.PRNGKey(0), j_build(MODEL)), epoch=7)
    rng = np.random.default_rng(2)
    frames = []
    for i, n_mol in enumerate((6, 8, 10, 6)):
        pos, Z, cell = water_box(n_mol, seed=i)
        frames.append(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True,
                                energy=float(-2.0 * len(Z) + rng.normal()),
                                forces=rng.normal(size=(len(Z), 3)) * 0.3))
    xyz = str(d / "data.extxyz")
    write_extxyz(xyz, frames)
    return dict(dir=d, ckpt=ckpt, xyz=xyz)


def _run(fn, argv, capsys):
    assert fn(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(J_PRESETS))
def test_preset_prints_jax_text(name, capsys):
    assert sorted(PRESETS) == sorted(J_PRESETS)
    assert _run(main, ["preset", name], capsys) == _run(j_main, ["preset", name], capsys)


@pytest.mark.parametrize("get_yaml", [False, True])
def test_checkpoint_prints_jax_output(files, get_yaml, capsys):
    argv = ["checkpoint", files["ckpt"]] + (["--get_yaml"] if get_yaml else [])
    got, want = _run(main, argv, capsys), _run(j_main, argv, capsys)
    assert got == want
    info, _ = json.JSONDecoder().raw_decode(got)
    assert info["epoch"] == 7 and info["layers"] == 2


def test_get_model_round_trip_keeps_the_parameters(files, tmp_path, capsys):
    _, want = load_model(files["ckpt"])
    first, second = str(tmp_path / "first"), str(tmp_path / "second")
    _run(main, ["get_model", files["ckpt"], "--out", first], capsys)
    _run(main, ["get_model", first, "--out", second], capsys)
    for path in (first, second):
        spec, params, meta = load_checkpoint(path)
        assert meta["format"] == FORMAT and meta["model_config"]["cutoff"] == MODEL["cutoff"]
        got = tree_leaves(params)
        assert len(got) == len(tree_leaves(want))
        for a, b in zip(got, tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_graph_build_statistics_equal_jax(files, tmp_path, capsys):
    out, jout = str(tmp_path / "stats.json"), str(tmp_path / "jstats.json")
    printed = _run(main, ["graph_build", files["xyz"], "--cutoff", "3.0", "--out", out], capsys)
    jprinted = _run(j_main, ["graph_build", files["xyz"], "--cutoff", "3.0", "--out", jout],
                    capsys)
    assert json.loads(printed).keys() == json.loads(jprinted).keys()
    with open(out) as f, open(jout) as g:
        got, want = json.load(f), json.load(g)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12, err_msg=k)


def test_inference_command(files, tmp_path, capsys):
    out = str(tmp_path / "infer")
    printed = _run(main, ["inference", files["ckpt"], files["xyz"], "--output", out,
                          "--batch", "3", "--device", "cpu"], capsys)
    errors = json.loads(printed)
    # the frames carry no stress labels: those metrics are NaN, as in the JAX package
    assert "Energy_RMSE (eV/atom)" in errors
    assert all(np.isfinite(v) != k.startswith("Stress") for k, v in errors.items())
    for name in ("per_graph.csv", "per_atom.csv", "errors.txt"):
        assert os.path.exists(os.path.join(out, name))


def test_train_from_yaml(files, tmp_path, capsys):
    yml = tmp_path / "input.yaml"
    yml.write_text(
        "model:\n  cutoff: 3.0\n  channel: 4\n  lmax: 1\n  is_parity: False\n"
        "  num_convolution_layer: 2\n  chemical_species: auto\n"
        "  self_connection_type: linear\n"
        "train:\n  epoch: 2\n  optimizer: adam\n  optim_param:\n    lr: 0.005\n"
        f"data:\n  batch_size: 2\n  load_trainset_path: ['{files['xyz']}']\n")
    wd = str(tmp_path / "wd")
    _run(main, ["train", str(yml), "--working_dir", wd, "--epochs", "1", "--device", "cpu"],
         capsys)
    _, _, meta = load_checkpoint(os.path.join(wd, "checkpoint_last"))
    assert meta["epoch"] == 1
    assert os.path.exists(os.path.join(wd, "lc.csv"))


def test_md_from_yaml(files, tmp_path, capsys):
    pos, Z, cell = water_box(16, seed=5)
    start = str(tmp_path / "start.extxyz")
    write_extxyz(start, [AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)])
    yml = tmp_path / "md.yaml"
    yml.write_text(
        f"md:\n  checkpoint: {files['ckpt']}\n  structure: {start}\n  ensemble: nvt\n"
        f"  steps: 6\n  dt: 0.5\n  temperature: 300.0\n  chunk: 3\n"
        f"  trajectory: {tmp_path / 'traj.extxyz'}\n  traj_every: 3\n"
        f"  log: {tmp_path / 'thermo.csv'}\n  precision: highest\n")
    printed = _run(main, ["md", str(yml), "--device", "cpu"], capsys)
    assert "ignored" in printed and "thermo log written" in printed
    rows = (tmp_path / "thermo.csv").read_text().strip().split("\n")
    assert rows[0].startswith("step,pe,ke,temperature,pressure") and len(rows) == 3
