"""The collectives of the port's multi-device layer, over ``torch.distributed``.

XLA inserts these in the JAX package (``parallel/mesh.py:18-19``); here they
are written out. Every one is an all-reduce or a broadcast, the two
operations that gloo also runs on CUDA tensors, so that ranks sharing one
card (gloo) run the same code as ranks on cards of their own (NCCL). The
all-gather is an all-reduce of a zero buffer that holds this rank's part in
its place: a sum with zeros is exact, so it gives the concatenation bit for
bit. Floating types narrower than fp32 travel as fp32 and come back in
their own type.

The autograd Functions are those that vocabulary tensor parallelism needs
(Megatron-LM's ``f`` and ``g``) and the cross-rank sum of a train-mode
BatchNorm's statistics:

- ``copy_to_model``: forward identity, backward all-reduce over the model
  group. It stands before the vocabulary-parallel head, whose input gradient
  is a partial sum on each rank;
- ``reduce_from_model``: forward all-reduce, backward identity. It sums the
  vocabulary-parallel embedding's rows, each rank holding zeros for the ids
  outside its slice;
- ``gather_from_model``: forward all-gather along a dimension, backward this
  rank's slice. It returns the full logits to the loss and the decoders;
- ``sum_over_data``: forward all-reduce over the data group, backward
  all-reduce: every rank's loss depends on the global sum.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _wire(t: torch.Tensor, copy: bool) -> torch.Tensor:
    """The buffer a collective runs on: ``t`` itself (``copy`` False) when it
    is contiguous and of a type the collective takes as it is, else a
    contiguous copy, in fp32 for floating types narrower than fp32."""
    if t.is_floating_point() and t.dtype not in (torch.float32, torch.float64):
        return t.detach().float()
    if copy or not t.is_contiguous():
        return t.detach().clone(memory_format=torch.contiguous_format)
    return t.detach()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The all-reduce of ``t`` over ``group`` as a new tensor of t's type
    (``t`` is left as it is)."""
    buf = _wire(t, copy=True)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.dtype)


def all_gather(t: torch.Tensor, group, index: int, size: int, dim: int = 0) -> torch.Tensor:
    """The concatenation along ``dim`` of every rank's ``t`` in ``group``
    (equal shapes), ``index`` being this rank's place among the ``size``."""
    dim = dim % t.dim()
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * size
    buf = _wire(t.new_zeros(shape), copy=False)
    buf.narrow(dim, index * n, n).copy_(t.detach())
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` in place with rank ``src``'s."""
    buf = _wire(t, copy=False)
    dist.broadcast(buf, src=src, group=group)
    if buf.data_ptr() != t.data_ptr() or buf.dtype != t.dtype:
        with torch.no_grad():
            t.copy_(buf)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return all_gather(x, mesh.model_group, mesh.model_index, mesh.model, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.model_index * ctx.n, ctx.n).contiguous(), None, None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x, mesh.data_group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh.data_group), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


def sum_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    return _SumOverData.apply(x, mesh)
