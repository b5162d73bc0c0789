"""The port's scripts (``sevennet_tpu_torch/scripts/inference.py`` and
``md_run.py``) against the JAX package's, on a checkpoint directory of the
JAX package that both read.

- ``inference`` over labelled water boxes in extxyz: the errors dict and
  the per-graph and per-atom CSV files (the same columns and rows; energies
  1e-5 relative, forces 1e-4 eV/A, stress 1e-6 eV/A^3, the tolerances of
  tests/test_torch_model.py, and each error metric within what those allow).
- ``run_md_from_config`` from extxyz and from POSCAR: the thermo rows of
  ``nvt`` and ``npt_berendsen`` against the JAX ``run_md_from_config`` on the
  same input (energies 1e-4 eV and positions of the trajectory's last frame
  1e-4 A, the limits of tests/test_torch_md.py; temperature and pressure
  through the same); ``langevin`` runs and repeats itself from its seed;
  the ``d3:`` key equals a direct ``MDEngine(d3=...)`` run from the same
  seed; the JAX input's ``precision`` and ``fused`` keys are accepted with
  one log line.
"""

import csv

import jax
import numpy as np
import pytest

from bench import water_box
from sevennet_tpu.io.native_checkpoint import save_checkpoint as j_save_checkpoint
from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu.scripts.inference import inference as j_inference
from sevennet_tpu.scripts.md_run import run_md_from_config as j_run_md
from sevennet_tpu.train.error_recorder import RecorderSpec as JRecorderSpec
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.data.extxyz import read_extxyz, write_extxyz
from sevennet_tpu_torch.io.registry import load_model
from sevennet_tpu_torch.md import MDEngine
from sevennet_tpu_torch.scripts.inference import METRICS, inference
from sevennet_tpu_torch.scripts.md_run import run_md_from_config
from sevennet_tpu_torch.train.error_recorder import RecorderSpec

MODEL = {"cutoff": 3.0, "channel": 8, "lmax": 1, "is_parity": False,
         "num_convolution_layer": 2, "self_connection_type": "linear",
         "conv_denominator": 8.0, "chemical_species": ["H", "O"]}
E_TOL, F_TOL, S_TOL = 1e-5, 1e-4, 1e-6
MD_E_TOL, MD_X_TOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scripts")
    ckpt = str(d / "model")
    j_save_checkpoint(ckpt, MODEL, model_init(jax.random.PRNGKey(0), j_build(MODEL)))
    rng = np.random.default_rng(4)
    frames = []
    for i, n_mol in enumerate((8, 10, 12, 8, 14)):
        pos, Z, cell = water_box(n_mol, seed=i)
        frames.append(AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True,
                                energy=float(-2.0 * len(Z) + rng.normal()),
                                forces=rng.normal(size=(len(Z), 3)) * 0.3,
                                stress=rng.normal(size=6) * 1e-3))
    xyz = str(d / "targets.extxyz")
    write_extxyz(xyz, frames)
    pos, Z, cell = water_box(16, seed=7)
    start = str(d / "start.extxyz")
    write_extxyz(start, [AtomsLite(positions=pos, numbers=Z, cell=cell, pbc=True)])
    poscar = d / "POSCAR"
    order = np.argsort(Z, kind="stable")  # H block, then O
    lines = ["water", "1.0"] + [" ".join(f"{x:.10f}" for x in row) for row in cell]
    lines += ["H O", f"{int((Z == 1).sum())} {int((Z == 8).sum())}", "Cartesian"]
    lines += [" ".join(f"{x:.10f}" for x in p) for p in pos[order]]
    poscar.write_text("\n".join(lines) + "\n")
    return dict(dir=d, ckpt=ckpt, xyz=xyz, start=start, poscar=str(poscar), frames=frames)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: "_".join(m))
def test_metric_names_equal_jax(metric):
    """The error table's keys, units included, are the JAX package's (the
    force unit was written with U+00C5 instead of the JAX package's U+212B
    ANGSTROM SIGN, so the keys of the errors dict differed)."""
    got = RecorderSpec.from_config([metric])
    want = JRecorderSpec.from_config([metric])
    assert [got.key_str(n) for n in got.names()] == [want.key_str(n) for n in want.names()]


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_inference_matches_jax(files):
    out, jout = files["dir"] / "infer", files["dir"] / "jinfer"
    errors = inference(files["ckpt"], [files["xyz"]], str(out), batch_size=2, device="cpu")
    jerrors = j_inference(files["ckpt"], [files["xyz"]], str(jout), batch_size=2)
    assert list(errors) == list(jerrors)
    e_max = max(abs(f.energy) / len(f) for f in files["frames"])
    for k, v in errors.items():
        tol = (E_TOL * e_max if k.startswith("Energy") else F_TOL if k.startswith("Force")
               else S_TOL * 1602.1766208)  # stress metrics in kbar
        assert abs(v - jerrors[k]) <= tol, (k, v, jerrors[k])
    for name, cols in (("per_graph.csv", {"energy": E_TOL, "stress_xx": S_TOL}),
                       ("per_atom.csv", {c: F_TOL for c in ("fx", "fy", "fz")})):
        got, want = _csv(out / name), _csv(jout / name)
        assert len(got) == len(want) > 0 and list(got[0]) == list(want[0])
        for g, w in zip(got, want):
            for c in g:
                if c in cols:
                    tol = cols[c] * (abs(float(w[c])) if c == "energy" else 1.0)
                    assert abs(float(g[c]) - float(w[c])) <= tol, (name, c)
                else:
                    assert float(g[c]) == pytest.approx(float(w[c]), abs=1e-9), (name, c)
    assert (out / "errors.txt").read_text().count("\n") == len(errors)


def _md_cfg(files, tmp, structure, **kw):
    cfg = {"checkpoint": files["ckpt"], "structure": structure, "steps": 10, "dt": 1.0,
           "temperature": 300.0, "chunk": 5, "skin": 0.6, "seed": 3,
           "trajectory": str(tmp / "traj.extxyz"), "traj_every": 5,
           "log": str(tmp / "thermo.csv")}
    cfg.update(kw)
    return {"md": cfg}


@pytest.mark.parametrize("ensemble,structure", [("nvt", "start"), ("npt_berendsen", "poscar")])
def test_md_run_matches_jax(files, tmp_path, ensemble, structure):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    cfg = _md_cfg(files, tmp_path / "t", files[structure], ensemble=ensemble)
    jcfg = _md_cfg(files, tmp_path / "j", files[structure], ensemble=ensemble, fused=False)
    out = run_md_from_config(cfg, log=lambda *a: None, device="cpu")
    jout = j_run_md(jcfg, log=lambda *a: None)
    rows, jrows = out["thermo"], jout["thermo"]
    assert len(rows) == len(jrows) == 2 and list(rows[0]) == list(jrows[0])
    n = len(read_extxyz(files[structure])[-1]) if structure == "start" else 48
    for r, j in zip(rows, jrows):
        assert r["step"] == j["step"]
        assert abs(r["pe"] - j["pe"]) < MD_E_TOL
        assert abs(r["ke"] - j["ke"]) < MD_E_TOL
        assert abs(r["temperature"] - j["temperature"]) < 2 * MD_E_TOL / (3 * n * 8.617333262e-5)
    if ensemble == "npt_berendsen":
        assert abs(rows[-1]["pressure"] - jrows[-1]["pressure"]) < 1e-6
    traj = read_extxyz(str(tmp_path / "t" / "traj.extxyz"))
    jtraj = read_extxyz(str(tmp_path / "j" / "traj.extxyz"))
    assert len(traj) == len(jtraj) == 3
    np.testing.assert_allclose(traj[-1].positions, jtraj[-1].positions, rtol=0, atol=MD_X_TOL)
    with open(tmp_path / "t" / "thermo.csv") as f:
        assert f.readline().strip() == ",".join(rows[0])


def test_md_run_langevin_repeats_from_its_seed(files, tmp_path):
    runs = []
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        runs.append(run_md_from_config(
            _md_cfg(files, tmp_path / sub, files["start"], ensemble="langevin"),
            log=lambda *a: None, device="cpu")["thermo"])
    assert runs[0] == [dict(r, walltime=r0["walltime"]) for r, r0 in zip(runs[1], runs[0])]
    assert all(np.isfinite(r["pe"]) for r in runs[0])


def test_md_run_d3_key_equals_the_engine(files, tmp_path):
    d3 = {"functional": "pbe", "damping": "damp_bj", "cutoff": 4.0}
    logs = []
    out = run_md_from_config(_md_cfg(files, tmp_path, files["start"], ensemble="nvt", d3=d3,
                                     precision="highest", fused=True),
                             log=logs.append, device="cpu")
    assert sum("ignored" in line for line in logs) == 1
    assert out["engine"].d3_params is not None
    spec, params = load_model(files["ckpt"])
    at = read_extxyz(files["start"])[-1]
    eng = MDEngine(spec, params, at.cell, skin=0.6, d3=d3, device="cpu")
    st = eng.make_state(at.positions, at.numbers, temperature=300.0, seed=3)
    st, (pe, ke) = eng.run(st, 10, dt=1.0, chunk=5, integrator="nvt", temperature=300.0)
    assert [r["pe"] for r in out["thermo"]] == [float(pe[4]), float(pe[9])]
    assert [r["ke"] for r in out["thermo"]] == [float(ke[4]), float(ke[9])]
