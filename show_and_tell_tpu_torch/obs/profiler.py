"""Spans and counters inside the port, and ``torch.profiler`` traces on
demand. The reference has no profiling at all (SURVEY.md §5).

A span is a ``torch.profiler.record_function`` range named
``show_and_tell.<name>``, so it sits in the same Kineto trace as the
device's activity (CUPTI), on one clock, and nests under the span open
around it on its thread. Spans and counters are on only while a
``recording()`` is open; otherwise ``span`` returns one shared no-op
context after one read of a module global, and counting is skipped. The
port's spans:

- serving: ``serve.call`` (a ``Captioner`` call) > ``serve.chunk`` (one
  bucket chunk) > ``trunk`` (``Captioner._features``) > ``trunk.copy`` (the
  images to the device), ``trunk.transform``, ``trunk.backbone``; ``decode``
  (``decode.dispatch.decode_ids`` and ``decode_nbest``; the attention
  surface's decode in ``serve``) > ``decode.prepare`` (the model's
  ``decode_state``, in ``decode.dispatch``), and from the one step loop,
  ``decode.loop.run``: ``decode.step`` (each call of the step function),
  ``decode.select`` (each selection rule's step: log-softmax, top-k, gathers
  and histories for beam; and its result), ``decode.sync`` (the read of
  whether every row has ended); ``strings`` (a chunk's result back to the
  host and into strings) > ``strings.wait``;
- the kernels' entry points: ``op.lstm_cell``, ``op.attention_beam``;
- training: ``train.step`` > ``train.features``, ``train.forward``,
  ``train.backward``, ``train.apply`` > ``train.apply.sync`` (the read of
  whether the gradient norm is finite).

Counters (``Recording.counters``): ``decode.row_steps``, the rows that each
call of a decode's step function computed, and ``decode.live_row_steps``,
those among them that had not emitted ``<end>`` before the call. The second
is reduced when the recording closes, from references to the decode's own
tensors, so that counting adds no device work and no synchronisation.
``trunk.convs`` counts the trunk's convolutions that carry an epilogue (a
bias, a ReLU, a residual add: each ``models.layers.conv_relu`` call), and
``trunk.fused_convs`` those among them that ran it inside cuDNN's fused
call. ``trunk.prepares`` counts each time a trunk's convolution weights are
prepared anew (``models.encoders.PreparedTrunk``: the first call, and the
first after a weight changed), ``trunk.prepared_calls`` each trunk call that
reused them; the second over their sum is the share of calls that skipped
the fold. Each ``TrainStep`` forward counts one of ``train.graph_captures``
(its padded shape's forward and backward captured as CUDA graphs, at the
shape's first step), ``train.graph_replays`` (the graphs replayed) or
``train.eager_steps`` (run eagerly: CPU tensors, a mesh across processes,
scheduled sampling, dropout, or shapes past the graphs' cap);
``graph_replays`` over the three's sum is the graphs' hit share. Launches
counted per kernel (``ops.cuda_lib.LAUNCHES``) count a graphed shape's
kernels in its warm-ups and capture, not at its replays.

Usage::

    with profile_trace("/tmp/trace", enabled=step == 50):
        state, metrics = train_step(...)

writes a Chrome trace (``trace_<pid>_<ns>.json``, viewable in Perfetto or
``chrome://tracing``) of the block's CPU ops, the spans and, where there is
a card, its CUDA kernels, under ``log_dir``. ``with recording() as rec:``
around any profiler of one's own does the same for the spans, and leaves the
counters in ``rec.counters``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "show_and_tell."

_OFF = contextlib.nullcontext()


class Recording:
    """The counters of one recording, and the reductions left to its close."""

    def __init__(self):
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self._later: List[Tuple[str, Callable, tuple]] = []

    def count_later(self, name: str, fn: Callable, *args) -> None:
        """Add ``fn(*args)`` (a number or a 0-d tensor) to ``name`` when the
        recording closes; ``args`` are kept alive until then."""
        self._later.append((name, fn, args))

    def close(self) -> None:
        later, self._later = self._later, []
        totals: Dict[str, object] = {}
        for name, fn, args in later:
            totals[name] = totals.get(name, 0) + fn(*args)
        for name, v in totals.items():
            self.counters[name] += int(v)


#: the open recording, or None; the one value every span and counter reads
active: Optional[Recording] = None


@contextlib.contextmanager
def recording():
    """Spans and counters on, for the duration; yields the ``Recording``.
    Inside an open recording it yields that one and leaves it open."""
    global active
    if active is not None:
        yield active
        return
    rec = active = Recording()
    try:
        yield rec
    finally:
        active = None
        rec.close()


def span(name: str):
    """The range ``show_and_tell.<name>`` while a recording is open, else a
    shared no-op context."""
    if active is None:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def annotate(name: str):
    """``span``, under the JAX package's name for it."""
    return span(name)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
