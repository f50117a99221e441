"""Bring-up of the process group, and multi-host input.

The port runs one process per device over ``torch.distributed``: NCCL
between cards, gloo on the CPU and for ranks that share a card. Across
hosts (``--multihost``, every process started by a launcher such as
``torchrun``):

1. each process calls :func:`initialize` first;
2. ``mesh.make_mesh`` then lays the ``data`` and ``model`` axes out over all
   ranks;
3. the dataset shards records per data index
   (``CocoCaptionDataset(host_shard=host_shard_info(model_parallel))``), so
   the ranks of one model group read the same records and input IO scales
   with the data axis;
4. :func:`globalize_batch` takes each rank's local batch as its rows of the
   global batch, which is then the local batches of the data axis in order.

On one host, ``cli.main`` starts the processes itself for
``num_devices > 1``; each reads the whole global batch and keeps its rows
(``mesh.shard_batch``).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from show_and_tell_tpu_torch.parallel import mesh as mesh_lib

log = logging.getLogger(__name__)

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


def launched() -> bool:
    """Whether a launcher's environment (``RANK``, ``WORLD_SIZE``) is set."""
    return all(k in os.environ for k in _LAUNCHER_ENV)


def local_rank() -> int:
    """This process's index among the processes of its host: ``LOCAL_RANK``
    where a launcher set it, else the global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> None:
    """Bring up the process group (nothing if it is up already).

    With explicit arguments, or a launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``), a
    failure raises: a process told to join a 2-process job must not run
    alone. Only the call with no argument and no such environment stays a
    single process, and it logs why.

    ``coordinator_address`` is ``host:port`` (TCP rendezvous) or an init
    method URL (``tcp://...``, ``file://...``); None reads the launcher's
    environment. ``backend`` is ``"nccl"`` for ranks on cards of their own,
    ``"gloo"`` for the CPU and for ranks that share a card; it is never
    switched here. With ``"nccl"`` this process's card, ``cuda:{local
    rank}``, becomes the current device, and a local rank without a card of
    its own raises."""
    if dist.is_initialized():
        return
    explicit = any(a is not None for a in (coordinator_address, num_processes, process_id))
    if not explicit and not launched():
        log.info("no coordinator address, process count or process id, and no launcher environment "
                 "(%s): single process", ", ".join(_LAUNCHER_ENV))
        return
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", -1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", -1))
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"initialize: process {rank} of {world}: pass num_processes and process_id "
                         f"(or set RANK and WORLD_SIZE)")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: backend='nccl' needs CUDA; the CPU takes backend='gloo'")
        local = int(os.environ.get("LOCAL_RANK", rank))
        cards = torch.cuda.device_count()
        if local >= cards:
            raise ValueError(
                f"initialize: backend='nccl' needs a card per rank, and local rank {local} has none on a host "
                f"with {cards} card(s) (NCCL refuses two ranks on one card). Ranks that share a card run "
                f"backend='gloo'."
            )
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    log.info("process %d of %d (%s, %s)", rank, world, backend, init_method)


def host_shard_info(model_parallel: int = 1) -> Tuple[int, int]:
    """(data index, data axis size) of this process, to feed the dataset's
    ``host_shard``: the ranks of one model group get one index, so they
    read the same records. (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank() // model_parallel, dist.get_world_size() // model_parallel


def globalize_batch(mesh: "mesh_lib.Mesh", local_batch: Mapping[str, Any]) -> Mapping[str, Any]:
    """This rank's rows of the global batch from its local batch. Across
    processes each rank's loader read its own records, so its batch is its
    rows as they are; on one process this is exactly ``shard_batch``."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dict(local_batch)
    return mesh_lib.shard_batch(mesh, local_batch)
