"""Device mesh and sharding layout over ``torch.distributed``: one process
per device.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a
``data`` axis and a ``model`` axis, and one jitted SPMD program sees the
whole batch while XLA inserts the collectives. The port runs PyTorch's own
idiom for the same thing: every rank is a process that drives one device,
a :class:`Mesh` records this rank's place on the two axes and the process
groups along them, and the collectives are written out
(``parallel/collectives.py``):

- ``data``: the batch is split over it (this data index's rows of the global
  batch), parameters are replicated, and gradients are summed over it;
- ``model``: the vocabulary dimension of the embedding and of the output
  head (``_is_vocab_dim_param``) is split over it when the vocabulary
  divides evenly; everything else is replicated.

Ranks are laid out as the JAX package's
``np.array(devices).reshape(n // mp, mp)``: rank = d * mp + m, so one model
group is consecutive ranks. Without an initialized process group a process
drives one device, and the mesh is that single device: every helper is then
the identity.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from show_and_tell_tpu_torch.parallel import collectives
from show_and_tell_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``data`` x ``model`` mesh of processes.
    ``data_group`` holds the ranks with this model index (they share a
    parameter slice), ``model_group`` the ranks with this data index (they
    share the batch rows); both are None on a single-device mesh."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def distributed(self) -> bool:
        """True when the mesh runs over a process group, even of one rank."""
        return self.data_group is not None


def make_mesh(
    num_devices: int = 0, model_parallel: int = 1, device: Union[str, torch.device] = "cuda"
) -> Mesh:
    """The mesh of the initialized process group (every rank calls this, in
    the same order), or of this process alone without one. ``num_devices``
    0 takes every rank. Raises as the JAX ``make_mesh`` does: for more
    devices than there are ranks, and for ``n % model_parallel``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    grouped = dist.is_available() and dist.is_initialized()
    have = dist.get_world_size() if grouped else 1
    n = num_devices if num_devices > 0 else have
    if have < n:
        where = (f"the process group has {have} ranks" if grouped else
                 "no process group is initialized, so this process drives one device")
        raise ValueError(
            f"make_mesh: requested {n} devices but {where}. The port runs one process per device: "
            f"cli.main starts them for num_devices > 1, or start them with a launcher (torchrun) and call "
            f"parallel.distributed.initialize first."
        )
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if not grouped:
        return Mesh(1, 1, 0, dev)
    if n != have:
        raise ValueError(
            f"make_mesh: requested {n} devices of a process group of {have} ranks; every rank drives one "
            f"device of the mesh, so num_devices must be 0 or {have}"
        )
    mp, dp, rank = model_parallel, n // model_parallel, dist.get_rank()
    data_group = model_group = None
    for m in range(mp):  # every rank creates every group, in one order
        g = dist.new_group([d * mp + m for d in range(dp)])
        if rank % mp == m:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            model_group = g
    return Mesh(dp, mp, rank, dev, data_group, model_group)


# --- the batch -----------------------------------------------------------------


def batch_rows(mesh: Optional[Mesh], n: int) -> slice:
    """This data index's rows of a global batch of ``n`` (divisible by the
    data axis)."""
    if mesh is None or mesh.data == 1:
        return slice(0, n)
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rows does not split over the mesh data axis ({mesh.data})")
    per = n // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(mesh: Mesh, batch: Mapping[str, Any]) -> Dict[str, Any]:
    """This data index's rows of every array (numpy or tensor) of a global
    batch."""
    return {k: v[batch_rows(mesh, int(np.shape(v)[0]))] for k, v in batch.items()}


def rand_rows(generator: Optional[torch.Generator], shape: Sequence[int], device, mesh: Optional[Mesh] = None,
              low: Optional[int] = None, high: Optional[int] = None) -> torch.Tensor:
    """``torch.rand(shape)`` (or ``torch.randint(low, high, shape)``) whose
    leading dimension is this rank's rows of the global batch: drawn for all
    ``shape[0] * data`` rows, this data index's rows kept, so a data-parallel
    run draws what one device draws for the same global batch."""
    dp = 1 if mesh is None else mesh.data
    full = (shape[0] * dp, *shape[1:])
    if low is None:
        x = torch.rand(full, generator=generator, device=device)
    else:
        x = torch.randint(low, high, full, generator=generator, device=device)
    return x if dp == 1 else x[batch_rows(mesh, full[0])]


# --- parameters ------------------------------------------------------------------


def replicate(mesh: Mesh, tree: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
    """Every tensor of ``tree`` overwritten in place by rank 0's."""
    if mesh.distributed and dist.get_world_size() > 1:
        for t in tree.values():
            collectives.broadcast_(t, src=0)
    return tree


def _is_vocab_dim_param(path: str, shape) -> Optional[int]:
    """Returns the axis index to shard over ``model``, or None.

    Vocab-dimension tensors: output heads ``out``/``classifier`` (w: [H, V],
    b: [V]) and the embedding table ([V, E])."""
    if "out" in path or "classifier" in path:
        return len(shape) - 1  # last dim is vocab
    if "embed" in path:
        return 0
    return None


def param_shardings(mesh: Mesh, params: Mapping[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """Per parameter (by state-dict name, at its full shape), the axis split
    over ``model``, or None for a replicated one: the vocabulary dimension
    of the embedding and the head when the mesh has a real ``model`` axis
    and the dimension divides by it, else None everywhere."""
    out: Dict[str, Optional[int]] = {}
    for name, x in params.items():
        ax = _is_vocab_dim_param(name, x.shape) if mesh.model > 1 else None
        out[name] = ax if ax is not None and x.shape[ax] % mesh.model == 0 else None
    return out


def vocab_parallel(mesh: Optional[Mesh], vocab_size: int) -> bool:
    """Whether a model of this vocabulary runs its embedding and head split
    over the mesh's model axis."""
    return mesh is not None and mesh.model > 1 and vocab_size % mesh.model == 0


def local_slice(mesh: Mesh, t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """This model index's slice of a full tensor (a view; ``t`` itself for
    a replicated one)."""
    if axis is None:
        return t
    n = t.shape[axis] // mesh.model
    return t.narrow(axis, mesh.model_index * n, n)


def _trainable(model) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def place_params(mesh: Mesh, model) -> None:
    """Put the model on the mesh: each parameter that ``param_shardings``
    splits keeps this rank's slice (the same ``Parameter``, its data
    replaced), and ``model.mesh`` is set, which the model's embedding, head,
    BatchNorm and random draws read."""
    params = _trainable(model)
    with torch.no_grad():
        for name, ax in param_shardings(mesh, params).items():
            if ax is not None:
                params[name].data = local_slice(mesh, params[name].data, ax).clone()
    model.mesh = mesh


def model_shardings(model) -> Dict[str, Optional[int]]:
    """The axis that each trainable parameter of a placed model is split on
    (None: replicated). Every parameter that ``_is_vocab_dim_param`` marks
    has the vocabulary as that axis, so all of them are split or none."""
    split = getattr(model, "vocab_mesh", None) is not None
    return {n: _is_vocab_dim_param(n, p.shape) if split else None for n, p in _trainable(model).items()}


def gather_params(mesh: Mesh, tree: Mapping[str, torch.Tensor], shardings: Mapping[str, Optional[int]]
                  ) -> Dict[str, torch.Tensor]:
    """The full tensors of a tree of local slices (params, Adam's moments,
    the EMA): the split ones gathered over the model group (every rank of it
    calls this), the replicated ones as they are."""
    return {
        k: v if shardings.get(k) is None else collectives.all_gather(
            v, mesh.model_group, mesh.model_index, mesh.model, shardings[k])
        for k, v in tree.items()
    }


@contextlib.contextmanager
def full_weights(model):
    """The block runs a placed model alone on this rank: its split
    parameters hold the full tensors and ``model.mesh`` is None (every rank
    of the mesh enters, as the gather is a collective). Afterwards each
    parameter keeps this rank's slice of what it then holds."""
    mesh, shardings, params = model.mesh, model_shardings(model), _trainable(model)
    full = gather_params(mesh, {k: params[k].data for k, ax in shardings.items() if ax is not None}, shardings)
    with torch.no_grad():
        for k, v in full.items():
            params[k].data = v
    model.mesh = None
    try:
        yield model
    finally:
        model.mesh = mesh
        with torch.no_grad():
            for k in full:
                params[k].data = local_slice(mesh, params[k].data, shardings[k]).clone()


# --- small agreements between ranks ---------------------------------------------------


def any_rank(mesh: Mesh, flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any."""
    if not mesh.distributed:
        return flag
    t = torch.tensor([int(flag)], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_object(mesh: Mesh, obj: Any) -> Any:
    """Rank 0's ``obj`` (picklable) on every rank."""
    if not mesh.distributed or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=mesh.device if dist.get_backend() == "nccl" else None)
    return box[0]
