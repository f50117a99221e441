"""Step timing + throughput — first-class metrics.

The reference brackets the train step with ``torch.cuda.synchronize();
time.time()`` (train.py:123-124,148-149) and then *never prints the values*;
here timing is a real subsystem: wall-clock per step (with a device
synchronise on demand), EMA smoothing, and items/sec throughput.
"""

from __future__ import annotations

import time
from typing import Optional

import torch


def _synchronize(result) -> None:
    """Wait for the CUDA device of every tensor in ``result`` (a tensor, or a
    dict, list or tuple of them); CPU tensors need no wait."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)


class StepTimer:
    """EMA-smoothed step timer. Call ``start()`` / ``stop(result)``; pass the
    step's output tensors to ``stop`` to synchronise on their device's
    completion."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_s: Optional[float] = None
        self.last_s: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            _synchronize(result)
        dt = time.perf_counter() - self._t0
        self.record(dt)
        return dt

    def record(self, dt: float) -> None:
        """Feed an externally measured per-step time (e.g. a synced window's
        average) into the EMA without the start/stop bracket."""
        self.last_s = dt
        self.avg_s = dt if self.avg_s is None else self.ema * self.avg_s + (1 - self.ema) * dt


class ThroughputMeter:
    """Cumulative items/sec over a window."""

    def __init__(self):
        self.items = 0
        self.seconds = 0.0

    def update(self, n_items: int, seconds: float) -> None:
        self.items += n_items
        self.seconds += seconds

    @property
    def items_per_sec(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0

    def reset(self) -> None:
        self.items = 0
        self.seconds = 0.0
