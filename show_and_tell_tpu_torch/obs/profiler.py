"""Profiler hooks: ``torch.profiler`` traces on demand.

The reference has no profiling at all (SURVEY.md §5). Usage::

    with profile_trace("/tmp/trace", enabled=step == 50):
        state, metrics = train_step(...)

writes a Chrome trace (``trace_<pid>_<ns>.json``, viewable in Perfetto or
``chrome://tracing``) of the block's CPU ops and, where there is a card,
its CUDA kernels, under ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named trace region for the profiler timeline."""
    return torch.profiler.record_function(name)
