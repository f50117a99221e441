"""Spans and counters around the program's layers, for traced runs only.

The benchmark wraps the program's entry points where its callers look them
up, as ``chip_smoke.plain_ops`` does, and undoes it on exit:

- ``ops.lstm.lstm_cell`` and ``ops.fused_decode_attention.attention_beam``
  as the models call them: a ``record_function`` range each, and the least
  time of the call from its shapes (``bounds``), whatever implements it;
- ``serve.Captioner._features`` (the transform and the trunk of a chunk):
  a range and CUDA events (``trunk_ms``), and the images it took;
- ``serve.decode_ids`` (the decode of a chunk): a range and the host clock
  to a synchronise (``decode_ms``);
- ``serve.Captioner._decode_pending`` (the ids back and into strings): a
  range.

The untraced runs that give the end-to-end metrics run without any of it.
"""

from __future__ import annotations

import contextlib
import time

import torch

from harness import bounds
from harness.trace import Run, span


@contextlib.contextmanager
def patched(obj, name: str, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _cell(run: Run, orig):
    def lstm_cell(params, x, h, c):
        with span("lstm_cell"):
            B, I = x.shape
            run.counters["lstm_cell_calls"] += 1
            run.counters["lstm_cell_bound_s"] += bounds.cell_bound(B, I, h.shape[1], x.dtype) / 1e3
            run.counters["decode_row_cells"] += B
            return orig(params, x, h, c)

    return lstm_cell


def _attention(run: Run, orig):
    def attention_beam(ce, f, hp, watt, *args, **kw):
        with span("attention_beam"):
            B, L, D = ce.shape
            run.counters["attention_beam_calls"] += 1
            run.counters["attention_beam_bound_s"] += bounds.attention_bound(B, hp.shape[1], L, D, ce.dtype) / 1e3
            return orig(ce, f, hp, watt, *args, **kw)

    return attention_beam


def _features(run: Run, orig):
    def _features(self, chunk):
        with span("trunk"), run.device_timer("trunk_ms"):
            out = orig(self, chunk)
        run.counters["trunk_images"] += out.shape[0]
        return out

    return _features


def _decode(run: Run, orig):
    def decode_ids(*args, **kw):
        with span("decode"):
            t0 = time.perf_counter()
            ids = orig(*args, **kw)
            torch.cuda.synchronize()
            run.timers["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        return ids

    return decode_ids


def _ranged(label: str):
    def make(orig):
        def wrapper(*args, **kw):
            with span(label):
                return orig(*args, **kw)

        return wrapper

    return make


@contextlib.contextmanager
def serving(run: Run, decode_timer: bool = True):
    """Every wrap above, for the duration; ``decode_timer`` False leaves out
    the decode's synchronise (and so its timer), the one wrap that changes
    how the host and the device overlap."""
    from show_and_tell_tpu_torch import serve
    from show_and_tell_tpu_torch.models import show_attend_tell as sat
    from show_and_tell_tpu_torch.models import show_tell as st

    with contextlib.ExitStack() as stack:
        for mod in (sat, st):
            stack.enter_context(patched(mod, "lstm_cell", lambda o: _cell(run, o)))
        stack.enter_context(patched(sat, "attention_beam", lambda o: _attention(run, o)))
        stack.enter_context(patched(serve.Captioner, "_features", lambda o: _features(run, o)))
        stack.enter_context(patched(serve, "decode_ids", (lambda o: _decode(run, o)) if decode_timer
                                    else _ranged("decode")))
        stack.enter_context(patched(serve.Captioner, "_decode_pending", _ranged("strings")))
        yield
