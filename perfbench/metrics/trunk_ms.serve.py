"""Median device milliseconds (CUDA events) of ``Captioner._features`` per
chunk: the eval transform and the trunk."""

import statistics


def read(run):
    ms = run.timers.get("trunk_ms")
    return statistics.median(ms) if ms else None
