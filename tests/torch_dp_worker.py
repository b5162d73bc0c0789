"""One rank of the port's data-parallel training, started by
tests/test_torch_dp.py in its own process (spawned: it imports torch and the
port only, never JAX). Rank ``r`` of ``world`` takes batches ``world * s +
r`` for steps ``s = 0 .. steps-1`` and writes its parameter leaves and the
step losses to ``{out}/rank{r}.npz``."""

import numpy as np
import torch

from sevennet_tpu_torch.data.dataset import GraphDataset
from sevennet_tpu_torch.io.convert import params_from_numpy
from sevennet_tpu_torch.model.build import build_model_spec
from sevennet_tpu_torch.train.loss import LossConfig
from sevennet_tpu_torch.train.trainer import Trainer, TrainerConfig, init_process_group, tree_leaves


def run_rank(rank, world, init_method, model, tree, xyz, cutoff, batch_kw, trainer_kw, steps,
             out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    init_process_group(init_method, rank, world, device="cpu")
    try:
        spec = build_model_spec(model)
        batches = list(GraphDataset.from_files(xyz, cutoff).build(spec.z_to_type)
                       .batches(**batch_kw))
        cfg = TrainerConfig(loss=LossConfig(**trainer_kw["loss"]), optimizer=trainer_kw["optimizer"],
                            lr=trainer_kw["lr"])
        params = params_from_numpy(spec, tree)
        if rank:  # other starting weights: the broadcast makes them rank 0's
            w = params["0_convolution"]["weight_nn"]["w"]
            w[0] = w[0] + 1.0
        trainer = Trainer(spec, params, cfg, device="cpu", data_parallel=True)
        trainer.set_epoch(0)
        losses = []
        for s in range(steps):
            step_losses, _ = trainer.train_step(batches[world * s + rank])
            losses.append([float(step_losses[k]) for k in sorted(step_losses)])
        np.savez(f"{out}/rank{rank}.npz", losses=np.asarray(losses),
                 **{f"p{i}": p.detach().numpy() for i, p in enumerate(tree_leaves(trainer.params))})
    finally:
        dist.destroy_process_group()
