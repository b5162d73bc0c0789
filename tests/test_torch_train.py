"""The port's training stack against the JAX package's: losses and the
error recorder on the same outputs, optimizers against optax, schedules,
the trainer's loss and parameter gradients on one batch (the JAX side with
its fused conv, ``conv_param_grads=True``, Pallas kernels in interpret
mode), and ``train_run`` end to end on the CPU.

Tolerances: losses and metrics 1e-6 relative (fp32 on both sides, the same
formulas); optimizers 1e-6 of each parameter leaf's largest entry (the same
formulas, but XLA's fp32 square root on the CPU is not correctly rounded,
so an update can differ in its last bits); the trainer's loss
1e-5 relative and each gradient leaf 1e-4 of its largest entry (fp32, sums
in another order, second derivatives through different code).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sevennet_tpu.data.dataset import GraphDataset as JGraphDataset
from sevennet_tpu.model.build import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu.train import error_recorder as jrec
from sevennet_tpu.train import metrics as jmetrics
from sevennet_tpu.train.loss import LossConfig as JLossConfig
from sevennet_tpu.train.loss import compute_losses as j_compute_losses
from sevennet_tpu.train.optim import build_optimizer as j_build_optimizer
from sevennet_tpu.train.optim import build_schedule as j_build_schedule
from sevennet_tpu.train.optim import trainable_mask as j_trainable_mask
from sevennet_tpu.train.trainer import Trainer as JTrainer
from sevennet_tpu.train.trainer import TrainerConfig as JTrainerConfig
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.calculator import SevenNetCalculator
from sevennet_tpu_torch.config import config_from_dicts, read_config_yaml
from sevennet_tpu_torch.data.dataset import GraphDataset
from sevennet_tpu_torch.data.extxyz import write_extxyz
from sevennet_tpu_torch.io.convert import params_from_numpy, params_to_numpy
from sevennet_tpu_torch.io.native_checkpoint import load_checkpoint
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.scripts.train import train_run
from sevennet_tpu_torch.train import error_recorder as rec
from sevennet_tpu_torch.train import metrics
from sevennet_tpu_torch.train.loss import LossConfig, compute_losses
from sevennet_tpu_torch.train.optim import build_optimizer, build_schedule, set_lr, trainable_mask
from sevennet_tpu_torch.train.trainer import Trainer, TrainerConfig, tree_leaves, tree_map

torch.set_num_threads(1)
CUTOFF = 4.0
MODEL = {"cutoff": CUTOFF, "channel": 4, "lmax": 1, "is_parity": False,
         "num_convolution_layer": 2, "chemical_species": ["H", "O"],
         "self_connection_type": "linear", "conv_denominator": 6.0,
         "shift": -1.2, "scale": 0.8}


def _frames(n_frames=8, seed=1):
    """6-atom H/O cells (tests/test_train.py's tiny set) with energy, force
    and stress labels; one structure without forces, one without stress."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        n = 6
        frames.append(AtomsLite(
            positions=rng.uniform(0, 6, (n, 3)), numbers=rng.choice([8, 1], n),
            cell=np.eye(3) * 6.0, pbc=True, energy=float(-1.0 * n + 0.1 * rng.normal()),
            forces=None if i == 3 else rng.normal(size=(n, 3)) * 0.1,
            stress=None if i == 5 else rng.normal(size=6) * 0.001,
        ))
    return frames


@pytest.fixture(scope="module")
def xyz(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "train.extxyz"
    write_extxyz(str(path), _frames())
    return str(path)


def _batches(xyz, batch_size=4, K=16):
    """The same batches from both packages' datasets."""
    z2t = j_build(MODEL).z_to_type
    ds = GraphDataset.from_files(xyz, CUTOFF).build(z2t)
    jds = JGraphDataset.from_files(xyz, CUTOFF).build(z2t)
    kw = dict(pad_multiple=16, dense_k=K)
    return list(ds.batches(batch_size, **kw)), list(jds.batches(batch_size, with_mirror=True, **kw))


def _outputs(graph, seed):
    """Random model outputs of the batch's shapes (padding masked)."""
    rng = np.random.default_rng(seed)
    G, N = graph.n_graphs_cap, graph.n_atoms_cap
    return {
        "energy": (np.asarray(graph.energy.nan_to_num(0.0)) + rng.normal(size=G)).astype(np.float32),
        "forces": rng.normal(size=(N, 3)).astype(np.float32) * 0.1,
        "stress": rng.normal(size=(G, 6)).astype(np.float32) * 1e-3,
    }


@pytest.mark.parametrize("criterion,use_weight,train_stress", [
    ("mse", False, True), ("huber", True, True), ("mse", True, False)])
def test_losses_and_recorder_match_jax(xyz, criterion, use_weight, train_stress):
    (b, *_), (jb, *_) = _batches(xyz)
    b.data_weight[0] = torch.tensor([2.0, 0.5, 3.0])
    jb = jb.replace(data_weight=jnp.asarray(b.data_weight.numpy()))
    kw = dict(criterion=criterion, huber_delta=0.05, force_weight=0.3, stress_weight=1e-3,
              train_stress=train_stress, use_weight=use_weight)
    cfg, jcfg = LossConfig(**kw), JLossConfig(**kw)
    record = [("Energy", "RMSE"), ("TotalEnergy", "MAE"), ("Force", "RMSE"),
              ("Force", "ComponentRMSE"), ("Force", "Loss"), ("Stress", "RMSE"),
              ("Stress_GPa", "MAE"), ("Energy", "Loss"), ("TotalLoss", "None")]
    spec = rec.RecorderSpec.from_config(record, cfg)
    jspec = jrec.RecorderSpec.from_config(record, jcfg)
    assert spec.names() == jspec.names()
    acc, jacc = rec.recorder_empty(spec), jrec.recorder_empty(jspec)
    macc, jmacc = metrics.empty_accumulator(), jmetrics.empty_accumulator()
    for seed in (0, 1):
        out = _outputs(b, seed)
        tout = {k: torch.tensor(v) for k, v in out.items()}
        jout = {k: jnp.asarray(v) for k, v in out.items()}
        total, losses = compute_losses(tout, b, cfg)
        jtotal, jlosses = j_compute_losses(jout, jb, jcfg)
        assert losses.keys() == jlosses.keys()
        for k in losses:
            np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-6, err_msg=k)
        acc = rec.recorder_update(spec, acc, tout, b)
        jacc = jrec.recorder_update(jspec, jacc, jout, jb)
        macc = metrics.metrics_update(macc, tout, b)
        jmacc = jmetrics.metrics_update(jmacc, jout, jb)
    got, want = rec.recorder_finalize(spec, acc), jrec.recorder_finalize(jspec, jacc)
    recorder = rec.ErrorRecorder(spec)
    recorder.absorb(acc)
    assert recorder.get_current() == got
    assert list(recorder.epoch_forward()) == [spec.key_str(n) for n in got]
    got.update(metrics.metrics_finalize(macc))
    want.update(jmetrics.metrics_finalize(jmacc))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def _param_trees(cfg=None):
    cfg = dict(MODEL, **(cfg or {}))
    jspec = j_build(cfg)
    tree = jax.tree_util.tree_map(np.asarray, model_init(jax.random.PRNGKey(3), jspec))
    return build_model_spec(cfg), jspec, tree


@pytest.mark.parametrize("name,optim_param,steps", [
    ("sgd", {"momentum": 0.9}, 3), ("sgd", {}, 3), ("adagrad", {}, 3),
    ("adam", {"b1": 0.8, "eps": 1e-6}, 3), ("adamw", {"weight_decay": 0.05}, 3),
    ("radam", {}, 8),  # rho crosses 5 at the 6th step: both branches
])
def test_optimizers_match_optax(name, optim_param, steps):
    """Each optimizer over identical gradients, frozen leaves included
    (train_shift_scale off: shift and scale get no update, no decay)."""
    spec, jspec, tree = _param_trees({"train_denominator": True})
    lr = 0.02
    mask = trainable_mask(spec, tree)
    assert mask == j_trainable_mask(jspec, tree)
    assert mask["rescale_atomic_energy"]["shift"] is False
    params = tree_map(lambda p, m: torch.tensor(p).requires_grad_(m), tree, mask)
    opt = build_optimizer(name, [p for p in tree_leaves(params) if p.requires_grad], lr, optim_param)
    set_lr(opt, lr)
    jopt = j_build_optimizer(name, lr, optim_param, spec=jspec, params=tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    rng = np.random.default_rng(5)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32), tree)
        for p, g in zip(tree_leaves(params), jax.tree_util.tree_leaves(grads)):
            if p.requires_grad:
                p.grad = torch.tensor(g)
        opt.step()
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for got, want in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    frozen = params["rescale_atomic_energy"]["scale"]
    np.testing.assert_array_equal(frozen.detach().numpy(), tree["rescale_atomic_energy"]["scale"])
    moved = params["0_convolution"]["weight_nn"]["w"][0].detach().numpy()
    assert np.abs(moved - tree["0_convolution"]["weight_nn"]["w"][0]).max() > 1e-4


@pytest.mark.parametrize("name,param", [
    ("constant", {}), ("steplr", {"step_size": 3, "gamma": 0.5}),
    ("multisteplr", {"milestones": [2, 5], "gamma": 0.3}), ("exponentiallr", {"gamma": 0.9}),
    ("cosineannealinglr", {"T_max": 7, "eta_min": 1e-4}),
    ("linearlr", {"start_factor": 0.5, "end_factor": 0.1, "total_iters": 6}),
    ("reducelronplateau", {"factor": 0.5}),
])
def test_schedules_match_jax(name, param):
    got, want = build_schedule(name, 0.01, param), j_build_schedule(name, 0.01, param)
    for epoch in range(12):
        assert got(epoch) == pytest.approx(want(epoch), rel=1e-12, abs=0)


def _trainer_grads_match_jax(xyz, monkeypatch, cfg=None):
    """One batch, the same numpy weights: the port's loss and every
    parameter leaf's gradient against ``jax.value_and_grad`` of the JAX
    Trainer's loss with its fused conv (``conv_param_grads=True``). Returns
    the port's trainer, its parameters and their gradients."""
    import sevennet_tpu.ops.fused_conv as jfc

    monkeypatch.setenv("SEVENNET_TPU_TARGET_T", "256")
    jfc._KERNEL_CACHE.clear()
    K = 16
    (b, *_), (jb, *_) = _batches(xyz, K=K)
    spec, jspec, tree = _param_trees(cfg)
    jspec = dataclasses.replace(jspec, edge_dense_k=K, conv_fused=True, conv_param_grads=True)
    kw = dict(force_weight=0.3, stress_weight=1e-2)
    jtrainer = JTrainer(jspec, jax.tree_util.tree_map(jnp.asarray, tree),
                        JTrainerConfig(loss=JLossConfig(**kw)))
    (jtotal, (jlosses, _)), jgrads = jax.value_and_grad(jtrainer._loss_and_metrics, has_aux=True)(
        jtrainer.state.params, jb)

    trainer = Trainer(spec, params_from_numpy(spec, tree), TrainerConfig(loss=LossConfig(**kw)),
                      device="cpu")
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), trainer.params)
    total, losses, _ = trainer._loss_and_metrics(params, b)
    grads = torch.autograd.grad(total, tree_leaves(params))
    assert abs(total.item() - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    for k in ("energy", "force", "stress"):
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]), rtol=1e-5, err_msg=k)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max())
    return spec, tree, b, params, grads


def test_trainer_loss_and_grads_match_jax(xyz, monkeypatch):
    """One batch, the same numpy weights: the port's loss and every
    parameter leaf's gradient (forces and stress through the conv's
    differentiable backward, B2′'s twin on the CPU) against
    ``jax.value_and_grad`` of the JAX Trainer's loss with its fused conv
    (``conv_param_grads=True``)."""
    spec, tree, b, params, grads = _trainer_grads_match_jax(xyz, monkeypatch)
    # the force and stress terms reach the radial MLP and the Bessel
    # coefficients: without them these gradients differ
    e_only = Trainer(spec, params_from_numpy(spec, tree),
                     TrainerConfig(loss=LossConfig(force_weight=0.0, stress_weight=0.0)),
                     device="cpu")
    t2, _, _ = e_only._loss_and_metrics(params, b)
    w3 = params["0_convolution"]["weight_nn"]["w"][2]
    g2 = torch.autograd.grad(t2, w3)[0]
    g1 = grads[next(i for i, p in enumerate(tree_leaves(params)) if p is w3)]
    assert (g1 - g2).abs().max() > 1e-3 * g1.abs().max()


def test_trainer_loss_and_grads_match_jax_legacy(xyz, monkeypatch):
    """The same with unnormalized spherical harmonics (a model loaded from a
    checkpoint older than SevenNet 0.10): the port's emb/sh conv (B4′'s
    twin and its plain second-order rule) against the JAX Trainer's emb/sh
    fused conv, whose backward runs B4′ in interpret mode."""
    _trainer_grads_match_jax(xyz, monkeypatch, {"_normalize_sph": False})


def _toy_set(path, seed=0):
    """examples/train_toy.py's synthetic set, with stress labels."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(16):
        n = 8
        frames.append(AtomsLite(positions=rng.uniform(0, 7, (n, 3)), numbers=rng.choice([8, 1], n),
                                cell=np.eye(3) * 7, pbc=True, energy=float(-2.0 * n),
                                forces=rng.normal(size=(n, 3)) * 0.05,
                                stress=rng.normal(size=6) * 1e-3))
    write_extxyz(path, frames)
    return path


def _lc(wd):
    lines = open(os.path.join(wd, "lc.csv")).read().strip().splitlines()
    header = lines[0].split(",")
    return [dict(zip(header, map(float, ln.split(",")))) for ln in lines[1:]]


TOY_MODEL = {"cutoff": 4.0, "channel": 8, "lmax": 1, "is_parity": False,
             "num_convolution_layer": 2, "chemical_species": "auto",
             "self_connection_type": "linear", "conv_denominator": "avg_num_neigh",
             "shift": "per_atom_energy_mean", "scale": "force_rms"}


def test_train_run_on_cpu(tmp_path):
    """examples/train_toy.py through the port: the loss falls over 5
    epochs, lc.csv and the checkpoints are written, and the last checkpoint
    reloads to the trainer's weights and energies."""
    data = _toy_set(str(tmp_path / "toy.extxyz"))
    wd = str(tmp_path / "wd")
    trainer = train_run(dict(TOY_MODEL), {"epoch": 5, "optimizer": "adam", "optim_param": {"lr": 0.01},
                                          "per_epoch": 2},
                        {"batch_size": 4, "load_trainset_path": [data], "ratio": 0.25},
                        working_dir=wd, device="cpu")
    rows = _lc(wd)
    assert [r["epoch"] for r in rows] == [1, 2, 3, 4, 5]
    assert rows[-1]["train_loss_total"] < rows[0]["train_loss_total"]
    assert all(np.isfinite(list(r.values())).all() for r in rows)
    for tag in ("checkpoint_best", "checkpoint_2", "checkpoint_4", "checkpoint_last"):
        assert os.path.isdir(os.path.join(wd, tag)), tag
    spec, params, meta = load_checkpoint(os.path.join(wd, "checkpoint_last"))
    assert meta["epoch"] == 5 and spec == trainer.spec
    for a, b in zip(tree_leaves(params), tree_leaves(trainer.params)):
        np.testing.assert_array_equal(a.numpy(), b.detach().numpy())
    rng = np.random.default_rng(9)
    at = AtomsLite(positions=rng.uniform(0, 7, (8, 3)), numbers=[8, 1] * 4, cell=np.eye(3) * 7,
                   pbc=True)
    e1 = SevenNetCalculator(spec, params, device="cpu").calculate(at)["energy"]
    e2 = SevenNetCalculator(trainer.spec, tree_map(lambda p: p.detach(), trainer.params),
                            device="cpu").calculate(at)["energy"]
    assert e1 == e2


def test_continue_reproduces_run(tmp_path):
    """Continue restores parameters, optimizer state and epoch: a 2 + 2
    epoch run equals an uninterrupted 4-epoch run (the JAX package's
    test_kill_and_resume_reproduces_run)."""
    data = _toy_set(str(tmp_path / "toy.extxyz"), seed=1)
    model = dict(TOY_MODEL, conv_denominator=10.0, shift=0.0, scale=1.0)
    dcfg = {"load_trainset_path": [data], "batch_size": 4}
    tcfg = {"epoch": 4, "optimizer": "adam", "optim_param": {"lr": 0.005},
            "scheduler": "exponentiallr", "scheduler_param": {"gamma": 0.5},
            "train_shuffle": True, "per_epoch": 2}
    full = train_run(dict(model), dict(tcfg), dict(dcfg), str(tmp_path / "full"), 4, device="cpu")
    train_run(dict(model), dict(tcfg), dict(dcfg), str(tmp_path / "half"), 2, device="cpu")
    resumed = train_run(dict(model), dict(tcfg, **{"continue": {
        "checkpoint": str(tmp_path / "half" / "checkpoint_last")}}), dict(dcfg),
        str(tmp_path / "resumed"), 2, device="cpu")
    assert resumed.step == full.step == 16
    for a, b in zip(tree_leaves(full.params), tree_leaves(resumed.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose([r["train_loss_total"] for r in _lc(str(tmp_path / "resumed"))],
                               [r["train_loss_total"] for r in _lc(str(tmp_path / "full"))[2:]],
                               rtol=1e-5)


def test_config_yaml(tmp_path):
    path = tmp_path / "input.yaml"
    path.write_text("model:\n  cutoff: 4.0\n  channel: 8\n  num_convolution_layer: 2\n"
                    "train:\n  optimizer: adamw\n  epoch: 3\ndata:\n  batch_size: 2\n")
    model, train, data = read_config_yaml(str(path))
    assert (model["cutoff"], model["channel"], train["optimizer"], data["batch_size"]) == (
        4.0, 8, "adamw", 2)
    assert train["force_loss_weight"] == 0.1 and data["shift"] == "per_atom_energy_mean"
    with pytest.raises(ValueError, match="unknown train config key"):
        config_from_dicts({"model": {"cutoff": 4.0, "num_convolution_layer": 2},
                           "train": {"opitmizer": "adam"}, "data": {}})


def test_trainer_needs_a_card_unless_cpu():
    spec, _, tree = _param_trees()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(spec, params_from_numpy(spec, tree))
    t = Trainer(spec, params_from_numpy(spec, tree), device="cpu")
    back = params_to_numpy(t.params)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
