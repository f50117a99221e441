"""Median device milliseconds (CUDA events) of ``TrainStep.features`` per
step: the random crop and flip, and the frozen trunk."""

import statistics


def read(run):
    ms = run.timers.get("trunk_ms")
    return statistics.median(ms) if ms else None
