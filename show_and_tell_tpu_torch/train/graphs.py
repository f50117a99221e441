"""CUDA graphs of the train step's differentiable part.

``StepGraphs`` keeps, for each key of shapes it is given, a pair of CUDA
graphs: the teacher-forced forward (the loss and what else the forward
returns) and its backward (the gradients of the loss by leaf). A key is
captured the first time it is seen and replayed afterwards, so that a step
costs two graph launches on the host in place of the ~1,100 kernel launches
of the eager forward and backward. The hand kernels are captured as they
are launched. The first capture comes after a few eager warm-up runs on a
side stream, where lazy initialisation happens (the kernels' libraries,
the autograd thread's handles); a later key finds that done and is captured
at once, since a warm-up on a stream of its own costs more than the capture
(its every allocation new: on an H100, ~0.5 s of a first sight's ~0.8 s).

The graphs read their inputs from buffers of their own (the call's inputs
are copied in) and the leaves in place, so that an optimizer that updates
the leaves in place is seen by the next replay. The forward's outputs are
cloned before they are returned, so a later replay never rewrites a tensor
handed out. The gradients are the backward graph's own buffers: they hold
until the next replay, and a step consumes them before that.

Every key's graphs share one memory pool, which is safe because a key's
forward is always followed by its own backward before another key
replays: a graphed loss differentiated after another key's forward raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from show_and_tell_tpu_torch.obs import profiler
from show_and_tell_tpu_torch.ops.lstm import fresh_splits

#: eager runs of forward and backward on a side stream before the first
#: capture: lazy initialisation happens there, outside any capture
WARMUP_ITERS = 2
#: the most keys given graphs of their own (the dataset forms 4 padded
#: lengths); calls of further keys run eagerly
MAX_KEYS = 8


def count(name: str) -> None:
    """One more ``name`` in the open recording, if any."""
    rec = profiler.active
    if rec is not None:
        rec.counters[name] += 1


class _Pair:
    """One key's graphs, and the tensors they read and write in place."""

    def __init__(self, inputs: Sequence[torch.Tensor]):
        self.inputs = [t.clone() for t in inputs]
        self.forward = torch.cuda.CUDAGraph()
        self.backward = torch.cuda.CUDAGraph()
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.dloss: Optional[torch.Tensor] = None
        self.grads: Tuple[Optional[torch.Tensor], ...] = ()


class _Replay(torch.autograd.Function):
    """The forward graph's replay as a function of the leaves: the outputs
    cloned, the first differentiable; its backward replays the backward
    graph."""

    @staticmethod
    def forward(ctx, graphs: "StepGraphs", pair: _Pair, *leaves):
        pair.forward.replay()
        graphs.pending = pair
        ctx.graphs, ctx.pair = graphs, pair
        outs = tuple(o.clone() for o in pair.outputs)
        ctx.mark_non_differentiable(*outs[1:])
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, dloss, *_):
        graphs, pair = ctx.graphs, ctx.pair
        if graphs.pending is not pair:
            raise RuntimeError("a graphed loss is differentiated once, before the next graphed forward")
        graphs.pending = None
        pair.dloss.copy_(dloss)
        pair.backward.replay()
        return (None, None, *pair.grads)


class StepGraphs:
    """Forward and backward graphs of ``fn(*inputs) -> (loss, *outputs)``
    by key, at most ``MAX_KEYS`` of them."""

    def __init__(self):
        self.pairs: Dict[tuple, _Pair] = {}
        self.pool = None
        # the pair whose forward replayed last and whose backward has not
        self.pending: Optional[_Pair] = None
        # the eager warm-up runs made (all before the first capture)
        self.warmups = 0

    def __call__(
        self, fn: Callable, key: tuple, inputs: Sequence[torch.Tensor], leaves: Sequence[torch.Tensor],
    ) -> Optional[Tuple[torch.Tensor, ...]]:
        """``fn(*inputs)`` by the key's graphs, capturing them if the key is
        new: the loss on the autograd graph of ``leaves``, the other outputs
        without gradient. None where the key is new and ``MAX_KEYS`` keys
        have graphs already: the caller runs ``fn`` itself."""
        pair = self.pairs.get(key)
        if pair is None:
            if len(self.pairs) >= MAX_KEYS:
                return None
            pair = self.pairs[key] = self._capture(fn, inputs, leaves)
            count("train.graph_captures")
        else:
            for static, x in zip(pair.inputs, inputs):
                static.copy_(x)
            count("train.graph_replays")
        return _Replay.apply(self, pair, *leaves)

    def _capture(self, fn: Callable, inputs: Sequence[torch.Tensor], leaves: Sequence[torch.Tensor]) -> _Pair:
        pair = _Pair(inputs)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            # each run its own split scope: a split made in a warm-up and
            # found by the capture would be read by the graph from freed memory
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ITERS):
                    with fresh_splits():
                        torch.autograd.grad(fn(*pair.inputs)[0], leaves, allow_unused=True)
                    self.warmups += 1
            torch.cuda.current_stream().wait_stream(side)
        with fresh_splits(), torch.cuda.graph(pair.forward, pool=self.pool):
            outputs = fn(*pair.inputs)
        pair.dloss = torch.empty_like(outputs[0])
        with torch.cuda.graph(pair.backward, pool=self.pool):
            pair.grads = torch.autograd.grad(outputs[0], leaves, pair.dloss, allow_unused=True)
        pair.outputs = tuple(o.detach() for o in outputs)
        return pair
