"""Spans and counters around the program's layers, for traced runs only.

The benchmark wraps the program's entry points where its callers look them
up, as ``chip_smoke.plain_ops`` does, and undoes it on exit:

- the kernels' entry points that the model's plug-in lists (``WRAPS``, each
  a ``plugins.Wrap``), as the model calls them: a ``record_function`` range
  each, its calls, the least time of the call from its shapes, whatever
  implements it, and the counters the plug-in adds (the LSTM cell's
  ``decode_row_cells``, which its ``model_flops`` reads);
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
import importlib
import time
from typing import Sequence

import torch

from harness.plugins import Wrap
from harness.trace import Run, span


@contextlib.contextmanager
def patched(obj, name: str, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _kernel(run: Run, wrap: Wrap, orig):
    calls, bound_s = wrap.span + "_calls", wrap.span + "_bound_s"

    def kernel(*args, **kw):
        with span(wrap.span):
            run.counters[calls] += 1
            run.counters[bound_s] += wrap.bound(*args, **kw) / 1e3
            if wrap.adds is not None:
                for name, n in wrap.adds(*args, **kw).items():
                    run.counters[name] += n
            return orig(*args, **kw)

    return kernel


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
def serving(run: Run, wraps: Sequence[Wrap], decode_timer: bool = True):
    """Every wrap above, and each of the model's ``wraps``, for the duration;
    ``decode_timer`` False leaves out the decode's synchronise (and so its
    timer), the one wrap that changes how the host and the device
    overlap."""
    from show_and_tell_tpu_torch import serve

    with contextlib.ExitStack() as stack:
        for wrap in wraps:
            module, name = wrap.target.split(":")
            stack.enter_context(patched(importlib.import_module(module), name,
                                        lambda o, w=wrap: _kernel(run, w, o)))
        stack.enter_context(patched(serve.Captioner, "_features", lambda o: _features(run, o)))
        stack.enter_context(patched(serve, "decode_ids", (lambda o: _decode(run, o)) if decode_timer
                                    else _ranged("decode")))
        stack.enter_context(patched(serve.Captioner, "_decode_pending", _ranged("strings")))
        yield
