"""Multi-fidelity training in the port against the JAX package: the
multi-modal dataset (modality tags, data weights, split, pooled and
modal-wise statistics), the statistics ``train_run`` resolves into the
model config, one train step on a batch that mixes the modalities, and
``train_run`` end to end on a two-modality config on the CPU.

Data: two modalities ("pbe", "scan") of 6-atom H/O cells with energy,
force and stress labels, the second with a data weight. Tolerances:
statistics 1e-12 relative (float64 numpy on both sides, the same
formulas); the train step's loss 1e-5 relative and each gradient leaf 1e-4
of its largest entry (tests/test_torch_train.py's: fp32, sums in another
order, second derivatives through different code).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_tpu.data.graph import batch_graphs as j_batch_graphs
from sevennet_tpu.data.modal_dataset import MultiModalDataset as JMultiModalDataset
from sevennet_tpu.model.build import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu.scripts.train import _resolve_statistics as j_resolve
from sevennet_tpu.train.loss import LossConfig as JLossConfig
from sevennet_tpu.train.trainer import Trainer as JTrainer
from sevennet_tpu.train.trainer import TrainerConfig as JTrainerConfig
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.data.extxyz import write_extxyz
from sevennet_tpu_torch.data.modal_dataset import MultiModalDataset
from sevennet_tpu_torch.io.convert import params_from_numpy
from sevennet_tpu_torch.io.native_checkpoint import load_checkpoint, load_native_checkpoint
from sevennet_tpu_torch.logger import Logger
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.scripts.modal_tools import select_modality
from sevennet_tpu_torch.scripts.train import resolve_statistics, train_run
from sevennet_tpu_torch.train.loss import LossConfig
from sevennet_tpu_torch.train.trainer import Trainer, TrainerConfig, tree_leaves, tree_map

torch.set_num_threads(1)
CUTOFF = 4.0
MODAL = {"cutoff": CUTOFF, "channel": 4, "lmax": 1, "is_parity": False,
         "num_convolution_layer": 2, "chemical_species": ["H", "O"],
         "self_connection_type": "linear", "conv_denominator": 6.0,
         "use_modality": True, "num_modalities": 2, "modal_map": {"pbe": 0, "scan": 1},
         "use_modal_node_embedding": False, "use_modal_self_inter_intro": True,
         "use_modal_self_inter_outro": True, "use_modal_output_block": True,
         "use_modal_wise_shift": True, "use_modal_wise_scale": False,
         "shift": [-1.1, -1.6], "scale": 0.8}


def _frames(n_frames, seed, e0):
    """6-atom H/O cells in a 6 A box, per-atom energy near ``e0``."""
    rng = np.random.default_rng(seed)
    return [AtomsLite(positions=rng.uniform(0, 6, (6, 3)), numbers=rng.choice([8, 1], 6),
                      cell=np.eye(3) * 6.0, pbc=True,
                      energy=float(e0 * 6 + 0.2 * rng.normal()),
                      forces=rng.normal(size=(6, 3)) * (0.1 if e0 < -1.3 else 0.2),
                      stress=rng.normal(size=6) * 1e-3)
            for _ in range(n_frames)]


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    """The multi-modal data config of two extxyz files."""
    d = tmp_path_factory.mktemp("modal")
    paths = {}
    for name, seed, e0, n in (("pbe", 1, -1.0, 8), ("scan", 2, -1.5, 6)):
        paths[name] = str(d / f"{name}.extxyz")
        write_extxyz(paths[name], _frames(n, seed, e0))
    return [{"data_modality": "pbe", "file_list": [{"file": paths["pbe"]}]},
            {"data_modality": "scan", "file_list": [{"file": paths["scan"]}],
             "data_weight": {"energy": 2.0, "force": 0.5}}]


def _both(entries, modal_map=None):
    return (MultiModalDataset.from_config(entries, CUTOFF, modal_map),
            JMultiModalDataset.from_config(entries, CUTOFF, modal_map))


STATS = ("per_atom_energy_mean", "per_atom_energy_mean_combined", "force_rms",
         "avg_num_neigh", "sqrt_avg_num_neigh", "elemwise_reference_energies")


@pytest.mark.parametrize("modal_map", [None, {"scan": 0, "pbe": 1}])
def test_modal_dataset_matches_jax(entries, modal_map):
    """Modality indices, data weights, split, statistics and the batches'
    modality tags against the JAX package's ``MultiModalDataset``."""
    mm, jmm = _both(entries, modal_map)
    assert mm.modal_map == jmm.modal_map and len(mm) == len(jmm) == 14
    assert mm.species == jmm.species == ["H", "O"]
    for name in mm.datasets:
        d, jd = mm.datasets[name], jmm.datasets[name]
        assert d.modal == jd.modal == mm.modal_map[name]
        assert [a.info for a in d.atoms_list] == [a.info for a in jd.atoms_list]
    assert mm.datasets["scan"].atoms_list[0].info["data_weight"] == {
        "energy": 2.0, "force": 0.5, "stress": 1.0}
    for key in STATS:
        np.testing.assert_allclose(getattr(mm, key), getattr(jmm, key), rtol=1e-12, err_msg=key)
    (tr, va), (jtr, jva) = mm.split(0.25), jmm.split(0.25)
    for a, b in ((tr, jtr), (va, jva)):
        assert {n: len(d) for n, d in a.datasets.items()} == {
            n: len(d) for n, d in b.datasets.items()}
        assert {n: d.modal for n, d in a.datasets.items()} == mm.modal_map

    mm.build(np.asarray(j_build(MODAL).z_to_type))
    tags = []
    for b in mm.batches(4, shuffle=True, seed=3, pad_multiple=16):
        real = b.graph_mask.numpy()
        tags += b.modal.numpy()[real].tolist()
        assert (b.data_weight.numpy()[real][b.modal.numpy()[real] == mm.modal_map["scan"], 0]
                == 2.0).all()
    order = np.arange(14)
    np.random.default_rng(3).shuffle(order)
    want = np.repeat([mm.modal_map["pbe"], mm.modal_map["scan"]], [8, 6])[order]
    assert tags == want.tolist()  # globally shuffled over both modalities


@pytest.mark.parametrize("wise_shift,wise_scale", [(True, False), (False, False),
                                                   (True, True)])
def test_resolved_statistics_match_jax(entries, wise_shift, wise_scale):
    """``resolve_statistics`` on a multi-modal set: modal-wise shift or
    scale resolve to per-modality lists, the others to pooled values."""
    mm, jmm = _both(entries)
    cfg = dict(MODAL, shift="per_atom_energy_mean", scale="force_rms",
               conv_denominator="avg_num_neigh", use_modal_wise_shift=wise_shift,
               use_modal_wise_scale=wise_scale)
    got, want = dict(cfg), dict(cfg)
    resolve_statistics(got, {}, mm, Logger(None, screen=False))

    class _Quiet:
        def format_k_v(self, *a):
            pass

    j_resolve(want, {}, jmm, _Quiet())
    for key in ("shift", "scale", "conv_denominator"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, err_msg=key)
    assert isinstance(got["shift"], list) == wise_shift
    spec, jspec = build_model_spec(got), j_build(want)
    np.testing.assert_allclose(np.asarray(spec.shift_init), np.asarray(jspec.shift_init),
                               rtol=1e-7)


def test_mixed_modality_train_step_matches_jax(entries, monkeypatch):
    """One batch holding both modalities, the same numpy weights: the
    port's loss and every parameter leaf's gradient against
    ``jax.value_and_grad`` of the JAX Trainer's loss (its fused conv,
    Pallas kernels in interpret mode). The trainer takes the batch as it
    is: the modality rides on ``GraphBatch.modal``."""
    import sevennet_tpu.ops.fused_conv as jfc

    monkeypatch.setenv("SEVENNET_TPU_TARGET_T", "256")
    jfc._KERNEL_CACHE.clear()
    K = 16
    mm, jmm = _both(entries)
    z2t = np.asarray(j_build(MODAL).z_to_type)
    mm.build(z2t)
    jmm.build(z2t)
    b = next(iter(mm.batches(6, shuffle=True, seed=5, pad_multiple=16, dense_k=K)))
    assert len(set(b.modal.numpy()[b.graph_mask.numpy()].tolist())) == 2
    jgraphs = [g for d in jmm.datasets.values() for g in d.graphs]
    order = np.arange(len(jgraphs))
    np.random.default_rng(5).shuffle(order)
    jb = j_batch_graphs([jgraphs[i] for i in order[:6]], n_atoms_cap=b.n_atoms_cap,
                        n_graphs_cap=b.n_graphs_cap, dense_k=K, with_mirror=True)
    np.testing.assert_array_equal(np.asarray(jb.modal), b.modal.numpy())

    jspec = j_build(MODAL)
    tree = jax.tree_util.tree_map(np.asarray, model_init(jax.random.PRNGKey(4), jspec))
    jspec = dataclasses.replace(jspec, edge_dense_k=K, conv_fused=True, conv_param_grads=True)
    kw = dict(force_weight=0.3, stress_weight=1e-2)
    jtrainer = JTrainer(jspec, jax.tree_util.tree_map(jnp.asarray, tree),
                        JTrainerConfig(loss=JLossConfig(**kw)))
    (jtotal, _), jgrads = jax.value_and_grad(jtrainer._loss_and_metrics, has_aux=True)(
        jtrainer.state.params, jb)
    spec = build_model_spec(MODAL)
    trainer = Trainer(spec, params_from_numpy(spec, tree), TrainerConfig(loss=LossConfig(**kw)),
                      device="cpu")
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), trainer.params)
    total, _, _ = trainer._loss_and_metrics(params, b)
    grads = torch.autograd.grad(total, tree_leaves(params))
    assert abs(total.item() - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max())


def test_train_run_two_modalities(entries, tmp_path):
    """``train_run`` on the two-modality config with a modal-wise shift
    from the statistics: the loss falls, the checkpoint keeps the modal map
    and the per-modality shift, and each modality served from it through
    ``select_modality`` gives the trained model's energy for that
    modality (the two differ)."""
    model = {k: v for k, v in MODAL.items()
             if k not in ("use_modality", "num_modalities", "modal_map")}
    model.update(shift="per_atom_energy_mean", scale="force_rms",
                 conv_denominator="avg_num_neigh", channel=8)
    wd = str(tmp_path / "wd")
    trainer = train_run(model, {"epoch": 4, "optimizer": "adam", "optim_param": {"lr": 0.01},
                                "per_epoch": 2, "random_seed": 3},
                        {"batch_size": 4, "load_trainset_path": entries, "ratio": 0.25},
                        working_dir=wd, device="cpu")
    lines = open(os.path.join(wd, "lc.csv")).read().strip().splitlines()
    header = lines[0].split(",")
    rows = [dict(zip(header, map(float, ln.split(",")))) for ln in lines[1:]]
    assert len(rows) == 4 and rows[-1]["train_loss_total"] < rows[0]["train_loss_total"]
    cfg, _, _, meta = load_native_checkpoint(os.path.join(wd, "checkpoint_last"))
    assert cfg["use_modality"] and cfg["num_modalities"] == 2
    assert cfg["modal_map"] == {"pbe": 0, "scan": 1}
    assert isinstance(cfg["shift"], list) and len(cfg["shift"]) == 2
    spec, params, _ = load_checkpoint(os.path.join(wd, "checkpoint_last"))
    assert spec == trainer.spec
    rng = np.random.default_rng(9)
    at = AtomsLite(positions=rng.uniform(0, 6, (6, 3)), numbers=[8, 1] * 3,
                   cell=np.eye(3) * 6.0, pbc=True)
    energies = {}
    for name in ("pbe", "scan"):
        cfg_m, params_m = select_modality(cfg, params, name)
        energies[name] = SevenNetCalculator(build_model_spec(cfg_m), params_m,
                                            device="cpu").calculate(at)["energy"]
        live = dataclasses.replace(trainer.spec, pinned_modal=cfg["modal_map"][name])
        want = SevenNetCalculator(live, tree_map(lambda p: p.detach(), trainer.params),
                                  device="cpu").calculate(at)["energy"]
        assert energies[name] == pytest.approx(want, rel=1e-6)
    assert abs(energies["pbe"] - energies["scan"]) > 1e-4
