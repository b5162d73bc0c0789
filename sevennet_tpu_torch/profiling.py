"""Profiling hooks (the port of ``sevennet_tpu/profiling.py``; the
reference has only environment-variable print statements,
``pair_e3gnn_parallel.cpp:90-96``).

- :func:`trace`: context manager recording a ``torch.profiler`` trace of
  the host and, where a card is present, its kernels, written into
  ``logdir`` as a Chrome trace (``*.pt.trace.json``: TensorBoard's profile
  plugin, Perfetto or ``chrome://tracing`` open it).
- :func:`step_timer`: a wall-clock timer whose laps wait for the card:
  :meth:`_Timer.lap` synchronizes the device of the result it is given
  before it reads the clock (the JAX package blocks until its result is
  ready).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["trace", "step_timer"]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace (CPU activity, and CUDA activity
    when a card is present) of the block into ``logdir``; yields the
    profiler (``key_averages()`` and the like)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    with prof:
        yield prof


def _first_tensor(result) -> Optional[torch.Tensor]:
    if isinstance(result, torch.Tensor):
        return result
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for r in result:
            t = _first_tensor(r)
            if t is not None:
                return t
    return None


class _Timer:
    def __init__(self):
        self.laps = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def lap(self, result=None):
        """End a lap; pass the lap's result (a tensor, or a dict, list or
        tuple holding tensors) to wait for its device first."""
        t = _first_tensor(result)
        if t is not None and t.is_cuda:
            torch.cuda.synchronize(t.device)
        dt = time.perf_counter() - self._t0
        self.laps.append(dt)
        self._t0 = time.perf_counter()
        return dt

    @property
    def mean(self):
        return sum(self.laps) / max(len(self.laps), 1)


@contextlib.contextmanager
def step_timer() -> Iterator[_Timer]:
    t = _Timer()
    t.start()
    yield t
