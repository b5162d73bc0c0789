"""Multi-fidelity models in the port against the JAX package: the modality
one-hot on the spec's modal linears, the modal-wise energy shift and scale,
the pinned modality, batches that mix modalities, and the modal tools.

Narrow widths (``tests/test_modal.py:MODAL_CONFIG``, and the same with a
modal-wise scale), random weights from ``model_init`` carried across with
``params_from_numpy``; the JAX side is its jitted ``model_compute`` on the
flat edge list (``tests/conftest.py:compute``). Tolerances: energy 1e-5
relative, forces 1e-5 eV/A, stress 1e-6 eV/A^3: fp32 on both sides, sums in
another order.
"""

import jax
import numpy as np
import pytest
import torch

from sevennet_tpu.model import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu.scripts import modal_tools as j_tools
from sevennet_tpu_torch.data.graph import batch_graphs, dense_graph_from_arrays, graph_from_arrays
from sevennet_tpu_torch.data.neighborlist import neighbor_list_numpy
from sevennet_tpu_torch.io.convert import params_from_numpy, params_to_numpy, random_params
from sevennet_tpu_torch.model.build import build_model_spec as t_build
from sevennet_tpu_torch.model.model import model_compute
from sevennet_tpu_torch.model.presets import MF_OMPA
from sevennet_tpu_torch.scripts import modal_tools as t_tools

from .conftest import build_graph, compute
from .test_modal import MODAL_CONFIG
from .test_torch_model import _plain

torch.set_num_threads(1)

MODAL_SCALE = dict(MODAL_CONFIG, use_modal_wise_scale=True,
                   scale=[[0.5, 0.7], [0.9, 1.3]])
CONFIGS = {"shift": MODAL_CONFIG, "shift_scale": MODAL_SCALE}


def _structure(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 6, (n, 3)), rng.choice([72, 8], n), np.eye(3) * 6.0


def _models(cfg, seed=0):
    jspec = j_build(cfg)
    jparams = model_init(jax.random.PRNGKey(seed), jspec)
    spec = t_build(cfg)
    return jspec, jparams, spec, params_from_numpy(spec, jax.tree_util.tree_map(np.asarray,
                                                                                jparams))


def _port_graph(spec, pos, Z, cell, modal=0):
    dst, src, shifts = neighbor_list_numpy(pos, spec.cutoff, cell, np.ones(3, bool))
    return dense_graph_from_arrays(pos, spec.z_to_type[Z], src, dst, shifts, cell, modal=modal)


def _close(port, ref, n=None):
    e, e_r = port["energy"].numpy(), np.asarray(ref["energy"])
    n = n or len(e)
    np.testing.assert_allclose(e[:n], e_r[:n], rtol=1e-5, atol=0)
    f, f_r = port["forces"].numpy(), np.asarray(ref["forces"])
    n_at = min(len(f), len(f_r))   # the JAX graph may carry padding atoms
    np.testing.assert_allclose(f[:n_at], f_r[:n_at], atol=1e-5, rtol=0)
    np.testing.assert_allclose(port["stress"].numpy()[:n], np.asarray(ref["stress"])[:n],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("cfg", [MODAL_CONFIG, MODAL_SCALE, dict(MF_OMPA, chemical_species=[
    "H", "O"])], ids=["shift", "shift_scale", "mf_ompa"])
def test_modal_spec_matches_jax(cfg):
    j, t = _plain(j_build(cfg)), _plain(t_build(cfg))
    assert j.keys() == t.keys()
    for name in j:
        assert j[name] == t[name], name


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("modal", [0, 1])
def test_modal_matches_jax(name, modal):
    """Each modality from the graph's own index (unpinned) against the JAX
    model; the two modalities give different energies."""
    jspec, jparams, spec, params = _models(CONFIGS[name])
    pos, Z, cell = _structure()
    jg = build_graph(jspec, pos, Z, cell)
    jg = jg.replace(modal=jg.modal + modal)
    ref = compute(jspec, jparams, jg)
    out = model_compute(spec, params, _port_graph(spec, pos, Z, cell, modal), device="cpu")
    _close(out, ref, n=1)
    other = model_compute(spec, params, _port_graph(spec, pos, Z, cell, 1 - modal), device="cpu")
    assert abs(float(other["energy"][0]) - float(out["energy"][0])) > 1e-4


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("modal", ["pbe", "scan"])
def test_pinned_modal_matches_jax(name, modal):
    """``select_modality`` pins a modality over the graph's own index, in
    both packages alike."""
    cfg = CONFIGS[name]
    jcfg, jp = j_tools.select_modality(cfg, model_init(jax.random.PRNGKey(0), j_build(cfg)),
                                       modal)
    tcfg, tp = t_tools.select_modality(
        cfg, params_from_numpy(t_build(cfg), jax.tree_util.tree_map(np.asarray, jp)), modal)
    assert tcfg == jcfg and tcfg["_pinned_modal"] == cfg["modal_map"][modal]
    jspec, spec = j_build(jcfg), t_build(tcfg)
    assert spec.pinned_modal == jspec.pinned_modal
    pos, Z, cell = _structure(1)
    ref = compute(jspec, jp, build_graph(jspec, pos, Z, cell))
    for graph_modal in (0, 1):  # the graph's own index is overridden
        out = model_compute(spec, tp, _port_graph(spec, pos, Z, cell, graph_modal), device="cpu")
        _close(out, ref, n=1)
    with pytest.raises(ValueError, match="unknown modality"):
        t_tools.select_modality(cfg, tp, "r2scan")


def test_mixed_modal_batch_matches_singles_and_jax():
    """A batch of two structures with modalities 0 and 1 equals each alone,
    and the JAX package's batch."""
    jspec, jparams, spec, params = _models(MODAL_SCALE, seed=3)
    from sevennet_tpu.data import batch_graphs as j_batch
    from sevennet_tpu.data import graph_from_arrays as j_graph
    from sevennet_tpu.data import neighbor_list_numpy as j_nl

    singles, flats, jflats = [], [], []
    for m, seed in ((0, 4), (1, 5)):
        pos, Z, cell = _structure(seed, n=6 + m)
        singles.append(model_compute(spec, params, _port_graph(spec, pos, Z, cell, m),
                                     device="cpu"))
        dst, src, sh = neighbor_list_numpy(pos, spec.cutoff, cell, np.ones(3, bool))
        flats.append(graph_from_arrays(pos, spec.z_to_type[Z], src, dst, sh, cell, modal=m))
        jd, js, jsh = j_nl(pos, spec.cutoff, cell, True)
        jflats.append(j_graph(pos, jspec.z_to_type[Z], js, jd, jsh, cell, modal=m))
    batch = batch_graphs(flats, n_atoms_cap=16, n_graphs_cap=3)
    assert batch.modal.tolist() == [0, 1, 0]
    out = model_compute(spec, params, batch, device="cpu")
    ref = compute(jspec, jparams, j_batch(jflats, n_atoms_cap=16, n_graphs_cap=3))
    np.testing.assert_allclose(out["energy"].numpy()[:2], np.asarray(ref["energy"])[:2],
                               rtol=1e-5)
    np.testing.assert_allclose(out["forces"].numpy()[:13], np.asarray(ref["forces"])[:13],
                               atol=1e-5, rtol=0)
    for g, (single, n0, n) in enumerate(zip(singles, (0, 6), (6, 7))):
        np.testing.assert_allclose(float(out["energy"][g]), float(single["energy"][0]),
                                   rtol=1e-5)
        np.testing.assert_allclose(out["forces"].numpy()[n0:n0 + n], single["forces"].numpy(),
                                   atol=1e-5, rtol=0)


def test_append_modality_matches_jax():
    """``append_modality`` gives the JAX tool's config and weights, and the
    new modality, copied from modality 1, predicts as modality 1 does."""
    cfg = MODAL_SCALE
    jparams = model_init(jax.random.PRNGKey(6), j_build(cfg))
    params = params_from_numpy(t_build(cfg), jax.tree_util.tree_map(np.asarray, jparams))
    jcfg, jp = j_tools.append_modality(cfg, jparams, "r2scan", copy_from=1)
    tcfg, tp = t_tools.append_modality(cfg, params, "r2scan", copy_from=1)
    assert tcfg == jcfg and tcfg["modal_map"]["r2scan"] == 2
    spec = t_build(tcfg)
    tp = params_from_numpy(spec, params_to_numpy(tp))   # every shape as the spec says
    for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp)),
                    jax.tree_util.tree_leaves(params_to_numpy(tp))):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    pos, Z, cell = _structure(7)
    e = [float(model_compute(spec, tp, _port_graph(spec, pos, Z, cell, m), device="cpu")
               ["energy"][0]) for m in (1, 2)]
    assert abs(e[0] - e[1]) <= 1e-5 * abs(e[0])
    # the input is left as it was
    assert params["0_self_interaction_1"]["w"][-1].shape[0] == 2


@pytest.mark.parametrize("cfg", [MODAL_SCALE, dict(MF_OMPA, chemical_species=["H", "O"])],
                         ids=["shift_scale", "mf_ompa"])
def test_random_params_have_jax_shapes(cfg):
    """``random_params`` of a multi-fidelity spec draws every array at the
    shape of the JAX package's ``model_init``: the modal linears widened by
    the modality one-hot, the (modalities, species) shift."""
    spec = t_build(cfg)
    tree = random_params(spec, 0)
    jtree = jax.tree_util.tree_map(np.asarray, model_init(jax.random.PRNGKey(0), j_build(cfg)))
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jtree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jtree)):
        assert a.shape == b.shape
    assert tree["rescale_atomic_energy"]["shift"].shape == (2, 2)
    params_from_numpy(spec, tree)
