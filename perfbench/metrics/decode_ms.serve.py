"""Median host milliseconds of ``serve.decode_ids`` per chunk, to a
synchronise: the decode of one bucket chunk, beam search and all."""

import statistics


def read(run):
    ms = run.timers.get("decode_ms")
    return statistics.median(ms) if ms else None
