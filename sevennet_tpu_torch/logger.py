"""Rank-0 file+screen logger with named wall-clock timers and a
learning-curve CSV writer (the port's copy of ``sevennet_tpu/logger.py``;
the reference's ``sevenn/logger.py`` and ``lc.csv`` from
``scripts/processing_epoch.py:56-99``)."""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

__all__ = ["Logger", "LearningCurveCSV"]


class Logger:
    def __init__(self, filename: Optional[str] = "log.sevennet", screen: bool = True,
                 rank: int = 0):
        self.rank = rank
        self.screen = screen
        self.f = open(filename, "w", buffering=1) if (filename and rank == 0) else None
        self._timers: Dict[str, float] = {}

    def writeline(self, msg: str = ""):
        if self.rank != 0:
            return
        if self.screen:
            print(msg, file=sys.stderr)
        if self.f:
            self.f.write(msg + "\n")

    def bar(self):
        self.writeline("-" * 78)

    def format_k_v(self, k, v):
        self.writeline(f"{k:<32}: {v}")

    def dict_of_counts(self, title, d: Dict):
        self.writeline(title)
        for k, v in d.items():
            self.format_k_v("  " + str(k), v)

    # timers
    def timer_start(self, name: str):
        self._timers[name] = time.perf_counter()

    def timer_end(self, name: str, msg: Optional[str] = None):
        dt = time.perf_counter() - self._timers.pop(name, time.perf_counter())
        self.writeline(f"{msg or name}: elapsed {dt:.2f} s")
        return dt

    def close(self):
        if self.f:
            self.f.close()


class LearningCurveCSV:
    def __init__(self, path: str, rank: int = 0):
        self.path = path
        self.rank = rank
        self._header_written = os.path.exists(path) and os.path.getsize(path) > 0

    def append(self, epoch: int, rows: Dict[str, Dict[str, float]]):
        """rows: {'train': {...metrics}, 'valid': {...}}"""
        if self.rank != 0:
            return
        cols = ["epoch"]
        vals = [str(epoch)]
        for split, metrics in rows.items():
            for k, v in metrics.items():
                cols.append(f"{split}_{k}")
                vals.append(f"{v:.6e}")
        with open(self.path, "a") as f:
            if not self._header_written:
                f.write(",".join(cols) + "\n")
                self._header_written = True
            f.write(",".join(vals) + "\n")
