"""The whole step's share of the chip's peak: the model FLOPs of the traced
work (from its shapes, ``harness.bounds``) over the seconds the same work
took without the profiler, over the dense bf16 peak of 989 TFLOP/s."""

from harness.bounds import MFU_PEAK


def read(run):
    if not run.unprofiled_s or not run.counters.get("model_flops"):
        return None
    return 100.0 * run.counters["model_flops"] / run.unprofiled_s / MFU_PEAK
