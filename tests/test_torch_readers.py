"""The port's structure readers and dataset against the JAX package's: the
VASP readers (``read_outcar``, ``read_poscar``, ``read_structure_list``) on
small files written here, ``read_structures``' dispatch and its refusal of
an unknown format without ASE, the disk cache written by either package and
read by the other, lazy batches, and the multiprocess build.

Everything here is numpy and file formats: the readers' fields must be
equal (the same float parsing), the cache's graphs bitwise equal (but the
cell volume, which both packages recompute on load from the cell the cache
keeps in fp32: 1e-6 relative) and its statistics equal.
"""

import sys

import numpy as np
import pytest

from sevennet_tpu.data import readers as jreaders
from sevennet_tpu.data import vasp as jvasp
from sevennet_tpu.data.dataset import GraphDataset as JGraphDataset
from sevennet_tpu.model.build import build_model_spec as j_build
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.data import readers, vasp
from sevennet_tpu_torch.data.dataset import GraphDataset
from sevennet_tpu_torch.data.extxyz import write_extxyz

CUTOFF = 4.0
ATOM_FIELDS = ("positions", "numbers", "cell", "pbc", "energy", "forces", "stress")
GRAPH_FIELDS = ("positions", "species", "edge_src", "edge_dst", "edge_shift", "energy", "forces",
                "stress", "modal", "data_weight", "cell", "atom_mask", "edge_mask")


def _outcar(path, n_frames=3, seed=0):
    """A VASP OUTCAR of ``n_frames`` ionic steps of a 2 O + 4 H cell: POTCAR
    titles (twice, as VASP writes them), ions per type, the lattice,
    stress in kB, positions with forces, and the free energy."""
    rng = np.random.default_rng(seed)
    lines = [" POTCAR:    PAW_PBE O 08Apr2002", " POTCAR:    PAW_PBE H 15Jun2001",
             " POTCAR:    PAW_PBE O 08Apr2002", " POTCAR:    PAW_PBE H 15Jun2001",
             "   ions per type =               2   4"]
    for _ in range(n_frames):
        cell = np.eye(3) * 6.0 + rng.normal(scale=0.05, size=(3, 3))
        lines.append("      direct lattice vectors                 reciprocal lattice vectors")
        lines += ["  " + "".join(f"{v:13.9f}" for v in row) + "   0.166666667  0.000000000  "
                  "0.000000000" for row in cell]
        s = rng.normal(size=6) * 10.0
        lines.append("  Total   " + "  ".join(f"{v:.5f}" for v in s))
        lines.append("  in kB   " + "  ".join(f"{v:.5f}" for v in s))
        lines.append(" POSITION                                       TOTAL-FORCE (eV/Angst)")
        lines.append(" " + "-" * 83)
        pos, frc = rng.uniform(0, 6, (6, 3)), rng.normal(size=(6, 3))
        lines += ["  " + "".join(f"{v:13.5f}" for v in p) + "".join(f"{v:15.6f}" for v in f)
                  for p, f in zip(pos, frc)]
        lines.append(" " + "-" * 83)
        lines.append(f"  free  energy   TOTEN  =       {-20.0 + rng.normal():.8f} eV")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _poscar(path, cartesian=False, selective=False, scale="1.0"):
    lines = ["water", f"  {scale}", "  6.0 0.0 0.0", "  0.1 6.0 0.0", "  0.0 0.2 6.0",
             "  O H", "  1 2"]
    if selective:
        lines.append("Selective dynamics")
    lines.append("Cartesian" if cartesian else "Direct")
    coords = [[0.1, 0.2, 0.3], [0.15, 0.25, 0.3], [0.05, 0.22, 0.31]]
    if cartesian:
        coords = [[6 * c for c in row] for row in coords]
    lines += ["  " + " ".join(f"{v:.6f}" for v in row) + (" T T F" if selective else "")
              for row in coords]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _same_atoms(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for name in ATOM_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            if y is None:
                assert x is None, name
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
        assert (a.info or {}) == (b.info or {})


def test_vasp_readers_match_jax(tmp_path):
    """``read_outcar`` (all frames, an index and a slice), ``read_poscar``
    (direct, cartesian, selective dynamics, a negative scale: the target
    volume) and ``read_structure_list`` (labels, indices and slices, an
    extxyz entry) give the JAX readers' structures field by field."""
    out = _outcar(tmp_path / "OUTCAR", seed=1)
    for index in (slice(None), 1, slice(0, 3, 2)):
        _same_atoms(vasp.read_outcar(out, index), jvasp.read_outcar(out, index))
    frames = vasp.read_outcar(out)
    assert frames[0].stress is not None and frames[0].energy is not None
    assert list(frames[0].numbers) == [8, 8, 1, 1, 1, 1]
    for kw in ({}, {"cartesian": True}, {"selective": True}, {"scale": "-220.0"}):
        p = _poscar(tmp_path / "POSCAR", **kw)
        _same_atoms([vasp.read_poscar(p)], [jvasp.read_poscar(p)])
    _outcar(tmp_path / "OUTCAR_b", n_frames=4, seed=2)
    rng = np.random.default_rng(3)
    write_extxyz(str(tmp_path / "extra.extxyz"), [AtomsLite(
        positions=rng.uniform(0, 5, (4, 3)), numbers=[8, 1, 1, 8], cell=np.eye(3) * 5, pbc=True,
        energy=-3.0, forces=rng.normal(size=(4, 3)))])
    (tmp_path / "structure_list").write_text(
        "# training data\n[bulk]\nOUTCAR :\nOUTCAR_b 1:4:2\n\n[surface]\nOUTCAR_b -1\n"
        "extra.extxyz\n")
    got = vasp.read_structure_list(str(tmp_path / "structure_list"))
    want = jvasp.read_structure_list(str(tmp_path / "structure_list"))
    assert list(got) == list(want) == ["bulk", "surface"]
    for label in got:
        _same_atoms(got[label], want[label])
    assert len(got["bulk"]) == 5 and len(got["surface"]) == 2


def test_read_structures_dispatch_matches_jax(tmp_path, monkeypatch):
    """``read_structures`` picks the reader by file name as the JAX
    package's does (extxyz, OUTCAR*, POSCAR*/CONTCAR*/*.vasp,
    structure_list*), and refuses an unknown format without ASE, naming the
    formats it reads."""
    _outcar(tmp_path / "OUTCAR_run1", seed=4)
    for name in ("POSCAR_relaxed", "CONTCAR", "cell.vasp"):
        _poscar(tmp_path / name, cartesian=name == "CONTCAR")
    write_extxyz(str(tmp_path / "a.xyz"), [AtomsLite(
        positions=np.eye(3), numbers=[8, 1, 1], cell=np.eye(3) * 4, pbc=True, energy=-1.0)])
    (tmp_path / "structure_list_all").write_text("[all]\nOUTCAR_run1 0:2\n")
    for name in ("OUTCAR_run1", "POSCAR_relaxed", "CONTCAR", "cell.vasp", "a.xyz",
                 "structure_list_all"):
        path = str(tmp_path / name)
        _same_atoms(readers.read_structures(path), jreaders.read_structures(path))
    monkeypatch.setitem(sys.modules, "ase", None)
    (tmp_path / "x.cif").write_text("data_x\n")
    with pytest.raises(ValueError, match="unrecognized structure format.*install ASE"):
        readers.read_structures(str(tmp_path / "x.cif"))
    with pytest.raises(ValueError, match="unrecognized structure format"):
        GraphDataset.from_files(str(tmp_path / "x.cif"), CUTOFF)


def _frames(n_frames=7, seed=1):
    """6- and 9-atom H/O cells with energy, force and stress labels, one
    without forces, one without stress, one with data weights."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        n = 6 if i % 2 else 9
        frames.append(AtomsLite(
            positions=rng.uniform(0, 6, (n, 3)), numbers=rng.choice([8, 1], n),
            cell=np.eye(3) * 6.0, pbc=True, energy=float(-1.0 * n + 0.1 * rng.normal()),
            forces=None if i == 3 else rng.normal(size=(n, 3)) * 0.1,
            stress=None if i == 5 else rng.normal(size=6) * 0.001,
            info={"data_weight": {"energy": 2.0, "force": 0.5}} if i == 2 else {}))
    return frames


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    write_extxyz(str(d / "set.extxyz"), _frames())
    return dict(xyz=str(d / "set.extxyz"), outcar=_outcar(d / "OUTCAR", seed=6), dir=d)


def _z2t():
    return j_build({"cutoff": CUTOFF, "chemical_species": ["H", "O"]}).z_to_type


def _same_graphs(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for name in GRAPH_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                          np.asarray(getattr(w, name)), err_msg=name)
        np.testing.assert_allclose(np.asarray(g.volume), np.asarray(w.volume), rtol=1e-6)


@pytest.mark.parametrize("source", ["xyz", "outcar"])
def test_cache_round_trips_between_packages(files, source, tmp_path):
    """A cache written by the JAX package loads in the port to the graphs
    the port builds and the JAX statistics; a cache the port writes loads
    in the JAX package to the JAX package's graphs and the port's
    statistics, which equal the JAX ones."""
    jds = JGraphDataset.from_files(files[source], CUTOFF).build(_z2t())
    ds = GraphDataset.from_files(files[source], CUTOFF).build(_z2t())
    assert ds.statistics == jds.statistics
    jds.save_cache(str(tmp_path / "jax"))
    ds.save_cache(str(tmp_path / "port"))
    from_jax = GraphDataset.load_cache(str(tmp_path / "jax"))
    from_port = JGraphDataset.load_cache(str(tmp_path / "port"))
    _same_graphs(from_jax.graphs, ds.graphs)
    _same_graphs(from_port.graphs, jds.graphs)
    assert from_jax.statistics == from_port.statistics == ds.statistics
    assert from_jax.cutoff == from_port.cutoff == CUTOFF
    # the port's own round trip batches like the built set
    again = GraphDataset.load_cache(str(tmp_path / "port"))
    for a, b in zip(again.batches(3, pad_multiple=16, dense_k=32),
                    ds.batches(3, pad_multiple=16, dense_k=32)):
        _same_graphs([a], [b])


def test_lazy_batches_and_multiprocess_build_match_the_serial_build(files):
    """``batches(lazy=True)`` builds each batch's graphs as it goes, with no
    ``build()``, to the built set's batches (shuffled too);
    ``build(processes=2)`` (a fork pool of numpy workers) gives the serial
    build's graphs."""
    serial = GraphDataset.from_files(files["xyz"], CUTOFF).build(_z2t())
    pooled = GraphDataset.from_files(files["xyz"], CUTOFF).build(_z2t(), processes=2)
    _same_graphs(pooled.graphs, serial.graphs)
    lazy = GraphDataset.from_files(files["xyz"], CUTOFF, z_to_type=_z2t())
    assert not lazy.graphs
    K = serial.max_neighbors() + 3
    for shuffle in (False, True):
        kw = dict(shuffle=shuffle, seed=4, pad_multiple=16, dense_k=K)
        got, want = list(lazy.batches(3, lazy=True, **kw)), list(serial.batches(3, **kw))
        assert len(got) == len(want) == 3
        _same_graphs(got, want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.edge_mir.numpy(), b.edge_mir.numpy())
    assert not lazy.graphs
