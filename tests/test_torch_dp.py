"""The port's data-parallel training (``Trainer(data_parallel=True)`` on
``torch.distributed``) against the JAX package's ``Trainer(mesh=...)``: two
``gloo`` ranks, each in its own spawned process (tests/torch_dp_worker.py,
a ``file://`` rendezvous in the test's directory), take 2 steps on
different batches; the JAX trainer takes the same 2 steps on a 2-device CPU
mesh (the root conftest gives 8 host devices), the batches stacked along
the device axis, with its plain XLA conv. The ranks' parameters must be
bitwise equal to each other (rank 1 starts from other weights: the
broadcast at construction makes them rank 0's) and equal to the JAX
trainer's within the trainer parity tests' tolerance carried through SGD:
each leaf within 1e-4 of its largest change (tests/test_torch_train.py
holds each gradient leaf to 1e-4 of its largest entry) plus one fp32 ulp of
its largest entry a step (the rounding of each update); the mean losses
1e-5 relative. Each process is joined with a timeout of its own, so a hang fails
the test.
"""

import dataclasses
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sevennet_tpu.data.dataset import GraphDataset as JGraphDataset
from sevennet_tpu.model.build import build_model_spec as j_build
from sevennet_tpu.model.model import model_init
from sevennet_tpu.train.loss import LossConfig as JLossConfig
from sevennet_tpu.train.trainer import Trainer as JTrainer
from sevennet_tpu.train.trainer import TrainerConfig as JTrainerConfig
from sevennet_tpu_torch.atoms import AtomsLite
from sevennet_tpu_torch.data.extxyz import write_extxyz

from . import torch_dp_worker

CUTOFF, K, WORLD, STEPS, JOIN_S = 4.0, 16, 2, 2, 120
MODEL = {"cutoff": CUTOFF, "channel": 4, "lmax": 1, "is_parity": False,
         "num_convolution_layer": 2, "chemical_species": ["H", "O"],
         "self_connection_type": "linear", "conv_denominator": 6.0,
         "shift": -1.2, "scale": 0.8}
LOSS = dict(force_weight=0.3, stress_weight=1e-2)
BATCH_KW = dict(batch_size=2, pad_multiple=16, dense_k=K)


def _frames(seed=1):
    """Eight 6-atom H/O cells with energy, force and stress labels."""
    rng = np.random.default_rng(seed)
    return [AtomsLite(positions=rng.uniform(0, 6, (6, 3)), numbers=rng.choice([8, 1], 6),
                      cell=np.eye(3) * 6.0, pbc=True, energy=float(-6.0 + 0.1 * rng.normal()),
                      forces=rng.normal(size=(6, 3)) * 0.1, stress=rng.normal(size=6) * 1e-3)
            for _ in range(8)]


def test_two_gloo_ranks_match_the_jax_mesh_trainer(tmp_path):
    xyz = str(tmp_path / "train.extxyz")
    write_extxyz(xyz, _frames())
    jspec = j_build(MODEL)
    tree = jax.tree_util.tree_map(np.asarray, model_init(jax.random.PRNGKey(3), jspec))
    trainer_kw = dict(loss=LOSS, optimizer="sgd", lr=0.05)

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_dp_worker.run_rank, args=(
        r, WORLD, f"file://{tmp_path / 'rendezvous'}", MODEL, tree, xyz, CUTOFF, BATCH_KW,
        trainer_kw, STEPS, str(tmp_path))) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
        assert [p.exitcode for p in procs] == [0] * WORLD
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()

    jds = JGraphDataset.from_files(xyz, CUTOFF).build(jspec.z_to_type)
    jb = list(jds.batches(with_mirror=True, **BATCH_KW))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    jtrainer = JTrainer(dataclasses.replace(jspec, edge_dense_k=K),
                        jax.tree_util.tree_map(jnp.asarray, tree),
                        JTrainerConfig(loss=JLossConfig(**LOSS), optimizer="sgd", lr=0.05),
                        mesh=mesh)
    jtrainer.set_epoch(0)
    jlosses = []
    for s in range(STEPS):
        stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                         *jb[WORLD * s:WORLD * (s + 1)])
        losses, _ = jtrainer.train_step(stacked)
        jlosses.append([float(losses[k]) for k in sorted(losses)])

    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]
    start = jax.tree_util.tree_leaves(tree)
    want = jax.tree_util.tree_leaves(jtrainer.state.params)
    assert len(want) == len(start) == len([k for k in ranks[0] if k.startswith("p")])
    moved = 0
    for i, (p0, jp) in enumerate(zip(start, want)):
        got = ranks[0][f"p{i}"]
        np.testing.assert_array_equal(got, ranks[1][f"p{i}"], err_msg=f"leaf {i}")
        change = np.abs(np.asarray(jp) - p0).max()
        moved += change > 0
        ulp = np.spacing(np.abs(np.asarray(jp, np.float32)).max())
        np.testing.assert_allclose(got, np.asarray(jp), rtol=0, atol=1e-4 * change + STEPS * ulp,
                                   err_msg=f"leaf {i}")
    assert moved >= len(start) // 2
    for r in ranks:
        np.testing.assert_allclose(r["losses"], np.asarray(jlosses), rtol=1e-5)
