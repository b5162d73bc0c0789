"""The port's host graph against the JAX package: the native C++ cell list
(``sevennet_tpu_torch/native``) edge for edge against ``sevennet_tpu.native``,
the dispatch between it and scipy (256 atoms and more, periodic, and a cell
the cell list takes), its build, and the device densify and mirror map
(``data/graph.py:dense_graph_device``, here on the CPU) bit for bit against
the host densify (``dense_graph_from_arrays``)."""

import numpy as np
import pytest
import torch

from sevennet_tpu.data import neighbor_list_numpy as j_nl
from sevennet_tpu.native import native_neighbor_list as j_native
from sevennet_tpu_torch import native
from sevennet_tpu_torch.data.graph import (
    dense_graph_device,
    dense_graph_from_arrays,
    receiver_sorted,
)
from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy


def _water(n_atoms, seed=0):
    """Random positions at water's atom density (0.1003 atoms/A^3)."""
    box = (n_atoms / 0.1003) ** (1 / 3)
    rng = np.random.default_rng(seed)
    return rng.uniform(0, box, (n_atoms, 3)), np.eye(3) * box


def _triclinic(n_atoms, seed=1):
    cell = np.array([[14.0, 0.0, 0.0], [4.5, 13.0, 0.0], [-3.0, 2.5, 15.0]])
    frac = np.random.default_rng(seed).uniform(0, 1, (n_atoms, 3))
    return frac @ cell, cell


LARGE = {
    "water_2000": (*_water(2000), (1, 1, 1), 5.0),
    "water_9999": (*_water(9999, 2), (1, 1, 1), 6.0),
    "slab_3000": (*_water(3000, 3), (1, 1, 0), 5.0),
    "triclinic_2500": (*_triclinic(2500), (1, 1, 1), 5.0),
}


def _small_cases():
    rng = np.random.default_rng(4)
    tri = np.array([[3.0, 0.0, 0.0], [1.0, 3.2, 0.0], [0.5, 0.7, 3.5]])
    yield "triclinic_under_cutoff", rng.uniform(0, 1, (7, 3)) @ tri, tri, (1, 1, 1)
    yield "slab", rng.uniform(0, 8, (30, 3)), np.diag([8.0, 8.0, 20.0]), (1, 1, 0)
    yield "molecule", rng.uniform(0, 5, (12, 3)), None, (0, 0, 0)
    yield "cube_2A", rng.uniform(0, 2, (4, 3)), np.eye(3) * 2.0, (1, 1, 1)
    outside = rng.uniform(0, 6, (20, 3))
    outside[3] = [7.5, -1.2, 13.0]
    yield "atom_outside_cell", outside, np.eye(3) * 6.0, (1, 1, 1)


SMALL = {name: case for name, *case in _small_cases()}


@pytest.mark.parametrize("name", list(LARGE))
def test_native_list_matches_jax_native(name):
    pos, cell, pbc, cutoff = LARGE[name]
    want = [np.array(a) for a in j_native(pos, cutoff, cell, pbc)]
    got = native.native_neighbor_list(pos, cutoff, cell, pbc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 40 * len(pos)
    # the dispatcher serves it natively, as the JAX package's does
    before = dict(neighbor_list_numpy.served)
    for g, w in zip(neighbor_list_numpy(pos, cutoff, cell, pbc), j_nl(pos, cutoff, cell, pbc)):
        np.testing.assert_array_equal(g, np.array(w))
    assert neighbor_list_numpy.served == dict(before, native=before["native"] + 1)


@pytest.mark.parametrize("name", list(SMALL))
def test_small_systems_go_to_scipy(name):
    pos, cell, pbc = SMALL[name]
    before = dict(neighbor_list_numpy.served)
    got = neighbor_list_numpy(pos, 5.0, cell, pbc)
    assert neighbor_list_numpy.served == dict(before, scipy=before["scipy"] + 1)
    for g, w in zip(got, j_nl(pos, 5.0, cell, pbc)):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0


def test_cell_under_cutoff_goes_to_scipy():
    """300 atoms in a periodic cell 4 A high: the cell list returns -1
    (it would need two images) and scipy lists it, as in the JAX package."""
    rng = np.random.default_rng(5)
    cell = np.diag([30.0, 30.0, 4.0])
    pos = rng.uniform(0, 1, (300, 3)) @ cell
    assert native.native_neighbor_list(pos, 5.0, cell, (1, 1, 1)) is None
    before = dict(neighbor_list_numpy.served)
    got = neighbor_list_numpy(pos, 5.0, cell, (1, 1, 1))
    assert neighbor_list_numpy.served == dict(before, scipy=before["scipy"] + 1)
    for g, w in zip(got, j_nl(pos, 5.0, cell, (1, 1, 1))):
        np.testing.assert_array_equal(g, w)


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without g++ the native list raises, here and through the dispatcher:
    no silent fall back to scipy."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    pos, cell, pbc, cutoff = LARGE["water_2000"]
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.native_neighbor_list(pos, cutoff, cell, pbc)
    with pytest.raises(RuntimeError, match="g.. not found"):
        neighbor_list_numpy(pos, cutoff, cell, pbc)
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.parametrize("name", ["water_2000", "slab_3000", "triclinic_2500", "slab",
                                  "atom_outside_cell", "molecule"])
def test_device_densify_equals_host(name):
    """The device densify (CPU tensors here) of the receiver-sorted list
    equals the host densify bit for bit: slots, shifts, mask, mirrors."""
    if name in LARGE:
        pos, cell, pbc, cutoff = LARGE[name]
    else:
        (pos, cell, pbc), cutoff = SMALL[name], 5.0
    dst, src, sh = neighbor_list_numpy(pos, cutoff, cell, pbc)
    species = np.arange(len(pos)) % 2
    host = dense_graph_from_arrays(pos, species, src, dst, sh, cell)
    d_s, s_s, sh_s = receiver_sorted(dst, src, sh)
    dev = dense_graph_device(pos, species, s_s, d_s, sh_s, cell)
    assert dev.dense_k == host.dense_k
    for f in ("edge_src", "edge_dst", "edge_shift", "edge_mask", "edge_mir", "positions",
              "species", "batch", "atom_mask", "cell", "volume", "num_atoms", "modal"):
        a, b = getattr(dev, f), getattr(host, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    with pytest.raises(ValueError, match="sorted by receiver"):
        dense_graph_device(pos, species, s_s[::-1].copy(), d_s[::-1].copy(), sh_s[::-1].copy(),
                           cell)
