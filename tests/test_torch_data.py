"""The port's training data path against the JAX package's: extxyz reading
and writing, dataset statistics, and the padded dense batches (with mirror
index and labels) that the trainer consumes, on the same file.

Batches are compared field by field, exactly (integers, masks, labels and
positions are copied, not computed); statistics within 1e-12 relative
(both float64 numpy).
"""

import numpy as np
import pytest
import torch

from sevennet_tpu.data.dataset import GraphDataset as JGraphDataset
from sevennet_tpu.data.extxyz import read_extxyz as j_read_extxyz
from sevennet_tpu.model.build import build_model_spec as j_build
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.data.dataset import GraphDataset, atoms_to_graph
from sevennet_tpu_torch.data.extxyz import read_extxyz, write_extxyz
from sevennet_tpu_torch.data.graph import batch_graphs, pad_graph
from sevennet_tpu_torch.io.convert import params_from_numpy, random_params
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.model.model import model_compute

torch.set_num_threads(1)
CUTOFF = 4.0
FIELDS = ("positions", "species", "atom_mask", "batch", "edge_src", "edge_dst", "edge_shift",
          "edge_mask", "cell", "volume", "num_atoms", "graph_mask", "energy", "forces",
          "stress", "data_weight", "edge_mir")


def _frames(n_frames=7, seed=1):
    """Small periodic H/O cells with every label, some of them missing."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        n = int(rng.integers(4, 9))
        cell = np.diag(rng.uniform(5.5, 7.0, 3)) + rng.normal(scale=0.2, size=(3, 3))
        frames.append(AtomsLite(
            positions=rng.uniform(0, 6, (n, 3)), numbers=rng.choice([8, 1], n), cell=cell,
            pbc=True, energy=float(-1.5 * n + rng.normal()),
            forces=None if i == 2 else rng.normal(size=(n, 3)) * 0.1,
            stress=None if i == 4 else rng.normal(size=6) * 1e-3,
        ))
    return frames


@pytest.fixture(scope="module")
def xyz(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "train.extxyz"
    write_extxyz(str(path), _frames())
    return str(path)


def test_extxyz_round_trip_matches_jax(xyz):
    frames = _frames()
    port, ref = read_extxyz(xyz), j_read_extxyz(xyz)
    assert len(port) == len(ref) == len(frames)
    for a, p, r in zip(frames, port, ref):
        np.testing.assert_array_equal(p.numbers, a.numbers)
        np.testing.assert_allclose(p.positions, a.positions, atol=1e-9)
        np.testing.assert_allclose(p.cell, a.cell, atol=1e-9)
        assert p.energy == pytest.approx(a.energy, abs=1e-9)
        for name in ("forces", "stress"):
            want = getattr(a, name)
            if want is None:
                assert getattr(p, name) is None and getattr(r, name) is None
            else:
                np.testing.assert_allclose(getattr(p, name), want, atol=1e-9)
        for name in ("positions", "numbers", "cell", "pbc", "energy", "forces", "stress"):
            pv, rv = getattr(p, name), getattr(r, name)
            if pv is None:
                assert rv is None
            else:
                np.testing.assert_array_equal(pv, rv)


def test_dataset_statistics_match_jax(xyz):
    ds, jds = GraphDataset.from_files(xyz, CUTOFF), JGraphDataset.from_files(xyz, CUTOFF)
    assert ds.species == jds.species == ["H", "O"]
    s, js = ds.statistics, jds.statistics
    assert s.keys() == js.keys()
    for k in s:
        np.testing.assert_allclose(s[k], js[k], rtol=1e-12, atol=0, err_msg=k)
    assert ds.avg_num_neigh > 0 and ds.force_rms > 0
    tr, va = ds.split(0.3, seed=2)
    jtr, jva = jds.split(0.3, seed=2)
    assert [len(a) for a in tr.atoms_list] == [len(a) for a in jtr.atoms_list]
    assert [len(a) for a in va.atoms_list] == [len(a) for a in jva.atoms_list]


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_match_jax(xyz, shuffle):
    """Dense (N, K) batches with mirror index and labels, as the JAX
    package's ``batches(dense_k=K, with_mirror=True)`` builds them."""
    z2t = j_build({"cutoff": CUTOFF, "chemical_species": ["H", "O"]}).z_to_type
    ds = GraphDataset.from_files(xyz, CUTOFF).build(z2t)
    jds = JGraphDataset.from_files(xyz, CUTOFF).build(z2t)
    assert ds.max_neighbors() == jds.max_neighbors()
    K = -(-(ds.max_neighbors() + 2) // 8) * 8
    kw = dict(shuffle=shuffle, seed=3, pad_multiple=16, dense_k=K)
    port = list(ds.batches(3, **kw))
    ref = list(jds.batches(3, with_mirror=True, **kw))
    assert len(port) == len(ref) == 3
    for b, jb in zip(port, ref):
        assert b.dense_k == K
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(jb, name)),
                                          err_msg=name)
        # unlabeled forces and stress stay NaN, padding atoms carry zeros
        assert np.isnan(b.energy.numpy()[~b.graph_mask.numpy()]).all()


def test_dataset_parts_not_ported_raise(xyz, tmp_path):
    """What the dataset cannot do raises with the reason: an unknown file
    format without ASE, batches or a cache before ``build()``, and lazy
    batches without ``z_to_type`` or ``dense_k``; the parts earlier slices
    refused (other readers, the multiprocess build, the cache, lazy
    batches) are held against the JAX package in tests/test_torch_readers.py."""
    ds = GraphDataset.from_files(xyz, CUTOFF)
    (tmp_path / "x.cif").write_text("data_x\n")
    for call, why in ((lambda: GraphDataset.from_files(str(tmp_path / "x.cif"), CUTOFF),
                       "unrecognized structure format"),
                      (lambda: ds.build(), "z_to_type"),
                      (lambda: next(ds.batches(2)), "build"),
                      (lambda: ds.save_cache(str(tmp_path / "c")), "build"),
                      (lambda: next(ds.batches(2, lazy=True, dense_k=16)), "lazy"),
                      (lambda: next(GraphDataset.from_files(xyz, CUTOFF, np.zeros(120, np.int64))
                                    .batches(2, lazy=True)), "dense_k")):
        with pytest.raises(ValueError, match=why):
            call()


def test_padded_batch_gives_the_graphs_results():
    """A batch of two structures, padded with atoms and a graph slot, gives
    each structure's energy, forces and stress as the structure alone."""
    spec = build_model_spec({"cutoff": CUTOFF, "channel": 4, "lmax": 1, "is_parity": False,
                             "num_convolution_layer": 2, "chemical_species": ["H", "O"]})
    params = params_from_numpy(spec, random_params(spec, 4))
    graphs = [atoms_to_graph(a, CUTOFF, spec.z_to_type) for a in _frames(2, seed=5)]
    both = model_compute(spec, params, batch_graphs(graphs, n_atoms_cap=32, n_graphs_cap=3),
                         device="cpu")
    off = 0
    for gi, g in enumerate(graphs):
        n = g.n_atoms_cap
        alone = model_compute(spec, params, pad_graph(g, n + 3), device="cpu")
        assert abs(float(both["energy"][gi]) - float(alone["energy"][0])) <= 1e-5 * abs(
            float(alone["energy"][0]))
        np.testing.assert_allclose(both["forces"][off:off + n], alone["forces"][:n], atol=1e-5)
        np.testing.assert_allclose(both["stress"][gi], alone["stress"][0], atol=1e-7)
        assert (alone["forces"][n:] == 0).all()
        off += n
    assert float(both["energy"][2]) == 0.0
