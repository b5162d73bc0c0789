"""Optimizers and learning-rate schedules (PyTorch port of
``sevennet_tpu/train/optim.py``).

Name-compatible with the reference registries (``sevenn/train/optim.py:5-23``):
optimizers sgd / adagrad / adam / adamw / radam; schedulers steplr /
multisteplr / exponentiallr / cosineannealinglr / linearlr /
reducelronplateau.

The optimizers are ``torch.optim`` optimizers with the numerics of the optax
transforms the JAX package chains (``optax.sgd``, ``adagrad``, ``adam``,
``adamw``, ``radam`` with a unit rate, then ``scale(step_size)``), not
torch's own defaults: adagrad starts its accumulator at 0.1 and adds eps
inside the square root, adam's bias corrections divide the moments, radam
switches on ``rho >= 5``. The learning rate is set per epoch by the trainer
(``set_lr``). Frozen leaves (:func:`trainable_mask`) are left out of the
optimizer: no update, no state and no weight decay, as ``multi_transform``
with ``set_to_zero`` gives.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from ..model.build import ModelSpec

__all__ = ["OptaxOptimizer", "build_optimizer", "build_schedule", "trainable_mask", "set_lr"]


def build_schedule(name: str, lr: float, param: Optional[Dict[str, Any]] = None):
    """Returns a host-side ``epoch -> lr`` callable.

    The reference steps its torch schedulers once per epoch
    (``scripts/processing_epoch.py`` + ``trainer.py:177-184``), so the
    schedule argument is the epoch counter, not the optimizer step.
    """
    param = dict(param or {})
    name = (name or "constant").lower()
    if name in ("constant", "none"):
        return lambda epoch: lr
    if name == "steplr":
        step_size = int(param.get("step_size", 1))
        gamma = float(param.get("gamma", 0.1))
        return lambda epoch: lr * gamma ** (epoch // step_size)
    if name == "multisteplr":
        milestones = sorted(int(m) for m in param.get("milestones", []))
        gamma = float(param.get("gamma", 0.1))
        return lambda epoch: lr * gamma ** sum(epoch >= m for m in milestones)
    if name == "exponentiallr":
        gamma = float(param.get("gamma", 0.99))
        return lambda epoch: lr * gamma**epoch
    if name == "cosineannealinglr":
        t_max = int(param.get("T_max", 100))
        eta_min = float(param.get("eta_min", 0.0))
        return lambda epoch: eta_min + 0.5 * (lr - eta_min) * (
            1.0 + math.cos(math.pi * min(epoch, t_max) / t_max)
        )
    if name == "linearlr":
        start = float(param.get("start_factor", 1.0))
        end = float(param.get("end_factor", 1e-4))
        iters = int(param.get("total_iters", 100))
        return lambda epoch: lr * (start + (end - start) * min(epoch, iters) / iters)
    if name == "reducelronplateau":
        # metric-driven factor handled at the trainer level
        return lambda epoch: lr
    raise ValueError(f"unknown scheduler {name}")


def _pow(base: float, n: int, dtype) -> torch.Tensor:
    """``base ** n`` in ``dtype`` by binary exponentiation, as XLA evaluates
    optax's ``decay ** count`` (torch's pow can differ by an ulp, which
    radam's ``rho`` magnifies a thousandfold)."""
    b = torch.tensor(base, dtype=dtype)
    out = None
    while n > 0:
        if n & 1:
            out = b if out is None else out * b
        n >>= 1
        if n:
            b = b * b
    return torch.ones((), dtype=dtype) if out is None else out


class OptaxOptimizer(torch.optim.Optimizer):
    """One optax update rule on ``torch.optim``: ``param -= lr * u`` where
    ``u`` is the update of the named rule at unit rate, computed in the
    order optax computes it (fp32, the same bias corrections and eps
    placement)."""

    RULES = ("sgd", "adagrad", "adam", "adamw", "radam")

    def __init__(self, params, rule: str, lr: float, momentum: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, initial_accumulator_value: float = 0.1,
                 threshold: float = 5.0):
        if rule not in self.RULES:
            raise ValueError(f"unknown optimizer {rule}")
        defaults = dict(lr=lr, momentum=momentum, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay,
                        initial_accumulator_value=initial_accumulator_value,
                        threshold=threshold)
        super().__init__(params, defaults)
        self.rule = rule

    def _state(self, p, group):
        st = self.state[p]
        if not st:
            st["count"] = 0
            if self.rule == "sgd":
                st["trace"] = torch.zeros_like(p)
            elif self.rule == "adagrad":
                st["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
            else:
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self._state(p, group)
                # optax: the update scaled by the rate, then added (two roundings)
                p.sub_(self._update(p, p.grad, st, group) * group["lr"])
        return loss

    def _update(self, p, g, st, group):
        st["count"] += 1
        t = st["count"]
        if self.rule == "sgd":
            # optax.trace: trace = g + decay * trace
            st["trace"] = g + group["momentum"] * st["trace"]
            return st["trace"].clone()
        if self.rule == "adagrad":
            # optax.scale_by_rss: g * rsqrt(sum_sq + eps) where sum_sq > 0
            ss = st["sum_of_squares"] = g * g + st["sum_of_squares"]
            inv = torch.where(ss > 0, torch.rsqrt(ss + group["eps"]), torch.zeros_like(ss))
            return inv * g
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        # optax.tree.update_moment(_per_elem_norm)
        mu = st["mu"] = (1 - b1) * g + b1 * st["mu"]
        nu = st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
        # optax.tree.bias_correction: 1 - decay**count in the moments' dtype
        dt = mu.dtype
        b1t, b2t = _pow(b1, t, dt), _pow(b2, t, dt)
        mu_hat = mu / (1 - b1t)
        nu_hat = nu / (1 - b2t)
        if self.rule == "radam":
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            ro = ro_inf - 2 * t * b2t / (1 - b2t)
            if float(ro) < group["threshold"]:
                return mu_hat
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            return r * mu_hat / (torch.sqrt(nu_hat) + eps)
        u = mu_hat / (torch.sqrt(nu_hat) + eps)
        if self.rule == "adamw":
            # optax.add_decayed_weights after scale_by_adam
            u = u + group["weight_decay"] * p
        return u


def build_optimizer(
    name: str,
    params: List[torch.Tensor],
    lr: float = 0.01,
    optim_param: Optional[Dict[str, Any]] = None,
) -> OptaxOptimizer:
    """The optimizer ``name`` over the trainable leaves ``params``, with the
    options the JAX package passes to optax (``sevennet_tpu/train/optim.py:
    84-94``): sgd ``momentum``; adam ``b1``, ``b2``, ``eps``; adamw
    ``weight_decay`` (default 1e-2); adagrad and radam at optax defaults."""
    p = dict(optim_param or {})
    name = name.lower()
    kw: Dict[str, Any] = {}
    if name == "sgd":
        kw["momentum"] = float(p.get("momentum", 0.0))
    elif name == "adam":
        kw = {k: float(v) for k, v in p.items() if k in ("b1", "b2", "eps")}
    elif name == "adamw":
        kw["weight_decay"] = float(p.get("weight_decay", 1e-2))
    elif name == "adagrad":
        kw["eps"] = 1e-7
    elif name != "radam":
        raise ValueError(f"unknown optimizer {name}")
    return OptaxOptimizer(params, name, lr, **kw)


def set_lr(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def trainable_mask(spec: ModelSpec, params) -> Any:
    """True = trainable. Mirrors the reference's requires_grad choices:
    bessel coeffs trainable (``BesselBasis`` default), denominators per
    ``train_denominator``, shift/scale per ``train_shift_scale``."""

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, keys) for v in node]
        if "rescale_atomic_energy" in keys:
            return spec.train_shift_scale
        if any(k.endswith("_convolution") for k in keys) and "denominator" in keys:
            return spec.train_denominator
        return True

    return walk(params, ())
