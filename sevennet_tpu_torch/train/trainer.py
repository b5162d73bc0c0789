"""Training engine on one device (PyTorch port of
``sevennet_tpu/train/trainer.py``).

A train step computes the energy, forces and stress of a batch with the
autograd graph kept (``model_compute(..., create_graph=True)``), the loss
(:func:`~sevennet_tpu_torch.train.loss.compute_losses`), its gradient with
respect to every trainable parameter (through the fused conv's
differentiable backward, so the force and stress terms reach the radial-MLP
weights and the Bessel coefficients), and one optimizer update. The
reference needs the same ``create_graph=True`` (``force_output.py:180``);
the JAX package composes ``jax.grad``.

The learning rate is set per epoch (``set_epoch``) as
``schedule(epoch) x plateau factor``, the reference's per-epoch
``scheduler.step()`` (``trainer.py:177-184``).

Data parallelism (``data_parallel=True``; the JAX package's ``Trainer(mesh=
...)`` over a ``dp`` mesh axis, ``sevennet_tpu/train/trainer.py:186-221``;
the reference's DDP) runs on ``torch.distributed``, one process a device,
under a process group the caller starts (:func:`init_process_group`:
``nccl`` on the card, ``gloo`` on the CPU). The parameters are broadcast
from rank 0 at construction; each rank steps on its own batch, and the
gradients are summed over the ranks in one flattened bucket and divided by
the world size, so that every rank applies the same update; the step's
losses are averaged over the ranks and the error recorder's accumulators
summed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.graph import GraphBatch
from ..device import resolve_device
from ..model.build import ModelSpec
from ..model.model import model_compute
from .error_recorder import (
    DEFAULT_ERROR_RECORD,
    RecorderSpec,
    recorder_add,
    recorder_empty,
    recorder_finalize,
    recorder_update,
)
from .loss import LossConfig, compute_losses
from .optim import build_optimizer, build_schedule, set_lr, trainable_mask

__all__ = ["TrainerConfig", "Trainer", "tree_leaves", "tree_map", "init_process_group"]


def tree_leaves(tree) -> List[Any]:
    """Leaves of a parameter tree in a fixed order, that of
    ``jax.tree_util.tree_leaves`` (sorted dict keys, then list order): the
    order of the optimizer's parameters and of its saved state."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def init_process_group(init_method: str, rank: int, world_size: int,
                       device: Optional[str] = None):
    """Starts the default ``torch.distributed`` group of data-parallel
    training with the backend of the device the trainer runs on: ``nccl``
    for ``cuda`` (the default), ``gloo`` for ``device="cpu"``.
    ``init_method`` is a ``tcp://host:port`` or ``file://`` address; one
    process a device."""
    import torch.distributed as dist

    backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)


def _flat_collective(tensors: List[torch.Tensor], collective) -> List[torch.Tensor]:
    """``collective`` (``dist.all_reduce``, a broadcast) on the
    concatenation of ``tensors`` (one dtype and device), one call for all:
    the results, shaped as ``tensors``."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    collective(flat)
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


@dataclass
class TrainerConfig:
    loss: LossConfig = field(default_factory=LossConfig)
    optimizer: str = "adam"
    lr: float = 0.01
    optim_param: Dict[str, Any] = field(default_factory=dict)
    scheduler: str = "constant"
    scheduler_param: Dict[str, Any] = field(default_factory=dict)
    # metric table, reference 'error_record' (_const.py:276-281)
    error_record: Any = DEFAULT_ERROR_RECORD


class Trainer:
    def __init__(
        self,
        spec: ModelSpec,
        params,
        config: Optional[TrainerConfig] = None,
        device: Optional[str] = None,
        plain: bool = False,
        data_parallel: bool = False,
    ):
        """``params``: the port's parameter tree; the trainer keeps its own
        copy on ``device`` (``cuda`` unless ``device="cpu"``). ``plain=True``
        runs the conv's plain PyTorch version instead of the kernels.
        ``data_parallel=True`` trains as one rank of the default process
        group, which must be started (:func:`init_process_group`); the
        parameters are then rank 0's."""
        self.spec = spec
        self.config = config or TrainerConfig()
        self.device = resolve_device(device)
        self.plain = plain
        mask = trainable_mask(spec, params)
        self.params = tree_map(
            lambda p, m: p.detach().to(self.device, torch.float32).clone().requires_grad_(m),
            params, mask,
        )
        self.trainable = [p for p in tree_leaves(self.params) if p.requires_grad]
        self.world = 1
        if data_parallel:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise ValueError("data_parallel needs a started process group "
                                 "(trainer.init_process_group)")
            self.world = dist.get_world_size()
            leaves = tree_leaves(self.params)
            with torch.no_grad():
                for p, v in zip(leaves, _flat_collective(leaves,
                                                         lambda t: dist.broadcast(t, src=0))):
                    p.copy_(v)
        self.data_parallel = data_parallel
        self.optimizer = build_optimizer(
            self.config.optimizer, self.trainable, self.config.lr, self.config.optim_param
        )
        self._plateau = self.config.scheduler.lower() == "reducelronplateau"
        self._plateau_best = float("inf")
        self._plateau_bad = 0
        p = self.config.scheduler_param
        self._plateau_factor = float(p.get("factor", 0.5))
        self._plateau_patience = int(p.get("patience", 10))
        self._plateau_scale = 1.0
        self.schedule = build_schedule(self.config.scheduler, self.config.lr,
                                       self.config.scheduler_param)
        self.sched_epoch0 = 0  # schedule origin (continue.reset_scheduler)
        self.step = 0
        self.recorder_spec = RecorderSpec.from_config(self.config.error_record, self.config.loss)

    # ------------------------------------------------------------------
    def current_lr(self, epoch: int) -> float:
        return self.schedule(max(epoch - self.sched_epoch0, 0)) * self._plateau_scale

    def set_epoch(self, epoch: int):
        """Apply the epoch schedule (call before each epoch's batches)."""
        set_lr(self.optimizer, self.current_lr(epoch))

    def aux_state(self) -> Dict[str, Any]:
        """Host-side scheduler/plateau state for checkpointing."""
        return {
            "plateau_best": self._plateau_best,
            "plateau_bad": self._plateau_bad,
            "plateau_scale": self._plateau_scale,
            "sched_epoch0": self.sched_epoch0,
        }

    def load_aux_state(self, aux: Dict[str, Any]):
        self._plateau_best = float(aux.get("plateau_best", float("inf")))
        self._plateau_bad = int(aux.get("plateau_bad", 0))
        self._plateau_scale = float(aux.get("plateau_scale", 1.0))
        self.sched_epoch0 = int(aux.get("sched_epoch0", 0))

    def opt_state(self) -> Dict[str, Any]:
        """The optimizer state in the checkpoint format: ``arrays`` (numpy,
        keyed ``"<leaf index>/<name>"``) and JSON ``meta``."""
        sd = self.optimizer.state_dict()
        arrays, scalars = {}, {}
        for idx, st in sd["state"].items():
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    arrays[f"{idx}/{k}"] = v.detach().cpu().numpy()
                else:
                    scalars[f"{idx}/{k}"] = v
        groups = [{k: v for k, v in g.items()} for g in sd["param_groups"]]
        return {"arrays": arrays, "meta": {"scalars": scalars, "param_groups": groups,
                                           "step": self.step}}

    def load_opt_state(self, state: Dict[str, Any]):
        """Restores :meth:`opt_state` (continue without reset_optimizer)."""
        per_leaf: Dict[int, Dict[str, Any]] = {}
        for key, v in state["arrays"].items():
            idx, name = key.split("/", 1)
            per_leaf.setdefault(int(idx), {})[name] = torch.as_tensor(np.asarray(v))
        for key, v in state["meta"]["scalars"].items():
            idx, name = key.split("/", 1)
            per_leaf.setdefault(int(idx), {})[name] = v
        self.optimizer.load_state_dict({"state": per_leaf,
                                        "param_groups": state["meta"]["param_groups"]})
        self.step = int(state["meta"].get("step", 0))

    # ------------------------------------------------------------------
    def _loss_and_metrics(self, params, graph: GraphBatch, create_graph: bool = True):
        out = model_compute(self.spec, params, graph, device=self.device, plain=self.plain,
                            create_graph=create_graph)
        total, losses = compute_losses(out, graph, self.config.loss)
        acc = recorder_update(self.recorder_spec, recorder_empty(self.recorder_spec, self.device),
                              out, graph)
        return total, losses, acc

    def train_step(self, graph: GraphBatch) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """One optimizer step on ``graph``; the gradients stay in ``.grad``
        of the trainable leaves until the next step. Data-parallel: this
        rank's batch; gradients, losses and metrics over all ranks."""
        graph = graph.to(self.device)
        self.optimizer.zero_grad(set_to_none=True)
        total, losses, acc = self._loss_and_metrics(self.params, graph)
        total.backward()
        if self.data_parallel:
            losses, acc = self._reduce_ranks(losses, acc)
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}, acc

    def _reduce_ranks(self, losses, acc):
        """Data-parallel step: each trainable leaf's gradient becomes the
        mean over the ranks (a leaf without one on this rank, as on every
        rank with the same model, keeps none), the losses their mean and
        the recorder's accumulators their sums; one bucket each."""
        import torch.distributed as dist

        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.trainable]
        for p, g in zip(self.trainable, _flat_collective(grads, dist.all_reduce)):
            if p.grad is not None:
                p.grad = g.div_(self.world)
        names = sorted(losses)
        summed = _flat_collective([losses[k] for k in names], dist.all_reduce)
        losses = {k: v / self.world for k, v in zip(names, summed)}
        keys = sorted(acc)
        acc = dict(zip(keys, _flat_collective([acc[k] for k in keys], dist.all_reduce)))
        return losses, acc

    def eval_step(self, graph: GraphBatch) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """Losses and metrics without an update. The parameters go in
        detached, so the conv's backward (forces and stress) needs no
        parameter gradients."""
        graph = graph.to(self.device)
        params = tree_map(lambda p: p.detach(), self.params)
        _, losses, acc = self._loss_and_metrics(params, graph, create_graph=False)
        return {k: v.detach() for k, v in losses.items()}, acc

    def plateau_step(self, metric: float):
        """Reduce the plateau lr factor when ``metric`` stops improving."""
        if not self._plateau:
            return
        if metric < self._plateau_best - 1e-12:
            self._plateau_best = metric
            self._plateau_bad = 0
            return
        self._plateau_bad += 1
        if self._plateau_bad > self._plateau_patience:
            self._plateau_bad = 0
            self._plateau_scale *= self._plateau_factor

    def run_epoch(self, loader, train: bool = True) -> Dict[str, float]:
        """``loader`` yields GraphBatch. Returns the mean losses over the
        batches (``loss_<term>``) and the finalized metrics."""
        acc_total = recorder_empty(self.recorder_spec, self.device)
        loss_sums: Dict[str, torch.Tensor] = {}
        n = 0
        for graph in loader:
            losses, acc = self.train_step(graph) if train else self.eval_step(graph)
            acc_total = recorder_add(acc_total, acc)
            for k, v in losses.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + v.double()
            n += 1
        result = {f"loss_{k}": float(v) / max(n, 1) for k, v in loss_sums.items()}
        result.update(recorder_finalize(self.recorder_spec, acc_total))
        return result
