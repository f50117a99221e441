"""Median device milliseconds (CUDA events) of ``TrainStep.backward`` per
step: the gradients of the loss by parameter."""

import statistics


def read(run):
    ms = run.timers.get("backward_ms")
    return statistics.median(ms) if ms else None
