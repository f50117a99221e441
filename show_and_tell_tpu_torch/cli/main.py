"""Training entry point: the ``main.py`` of the port.

Usage::

    python -m show_and_tell_tpu_torch.cli.main --data_json data/data.json \
        --vocab_path data/vocab.json --ann_file captions_val2014.json ...

Mirrors the reference flow (main.py:13-46): parse the config, create
``experiment/<user_id>/<exp_id>/``, build the loaders of the train and val
splits, the model and the trainer, and run. The model starts from the
``"init"`` stream of ``KeyChain(cfg.random_seed)``; the trainer then loads
``--encoder_weights`` (the frozen trunk, which checkpoints do not hold),
``--load_pretrained`` weights and ``--torch_checkpoint`` into it. It runs on
the GPU, and raises without one; ``main(cfg, device="cpu")`` runs the plain
PyTorch path on the CPU.

Several devices (``parallel/``) run one process each:
- ``--num_devices N`` (N > 1) without a launcher: ``main`` starts N
  processes itself, rank i on ``cuda:i`` (NCCL; more than the host's cards
  raises) or on the CPU (gloo), meeting through a file in the experiment
  dir, and returns None once they have finished: the results are in the
  experiment dir. Each reads the whole batch and keeps its rows;
- under a launcher (``torchrun``, which sets ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``) every process joins the group from its environment;
  ``--multihost`` (and ``--coordinator_address``) also gives each data index
  its own records (``host_shard``), and each rank's batch is its rows.
Ranks other than 0 log to ``log.proc<rank>.txt``; rank 0 alone writes the
checkpoints.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional, Union

import torch
import torch.distributed as dist

from show_and_tell_tpu_torch.config import Config, parse_config
from show_and_tell_tpu_torch.data.dataset import CocoCaptionDataset
from show_and_tell_tpu_torch.data.pipeline import make_loader
from show_and_tell_tpu_torch.evalsuite.driver import make_trainer_eval_fn
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.parallel import distributed
from show_and_tell_tpu_torch.train.trainer import Trainer
from show_and_tell_tpu_torch.utils.device import resolve_device
from show_and_tell_tpu_torch.utils.experiment import make_experiment_dir
from show_and_tell_tpu_torch.utils.logging import setup_logging
from show_and_tell_tpu_torch.utils.rng import KeyChain
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

log = logging.getLogger(__name__)

RENDEZVOUS = ".rendezvous"  # the spawned ranks' file store, in the experiment dir


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def main(cfg: Config, device: Union[str, torch.device] = "cuda") -> Optional[Trainer]:
    device = resolve_device(device)
    host_shard = None
    if cfg.multihost or distributed.launched():
        distributed.initialize(cfg.coordinator_address, backend=_backend(device))
    elif cfg.num_devices > 1 and not dist.is_initialized():
        return _spawn(cfg, device)
    if dist.is_initialized() and device.type == "cuda":
        device = torch.device("cuda", distributed.local_rank())
    if cfg.multihost:
        host_shard = distributed.host_shard_info(cfg.model_parallel)
    cfg = make_experiment_dir(cfg)
    return _train(cfg, device, host_shard)


def _train(cfg: Config, device: torch.device, host_shard=None) -> Trainer:
    rank = dist.get_rank() if dist.is_initialized() else 0
    # the log lives in the experiment dir, one file per rank; a resumed run
    # appends to it
    log_name = "log.txt" if rank == 0 else f"log.proc{rank}.txt"
    setup_logging(os.path.join(cfg.expr_dir, log_name), mode="a" if cfg.start_from else "w")
    log.info("run arguments: %s", json.dumps(cfg.to_dict(), indent=4, sort_keys=True))
    if dist.is_initialized():
        log.info("rank %d of %d on %s; records of data index %s", rank, dist.get_world_size(), device,
                 host_shard or "all")

    vocab = Vocabulary.load(cfg.vocab_path)
    with open(cfg.data_json) as f:
        records = json.load(f)
    train_ds = CocoCaptionDataset(records, vocab, "train", cfg.max_caption_len, cfg.num_buckets,
                                  host_shard=host_shard)
    val_ds = CocoCaptionDataset(records, vocab, "val", cfg.max_caption_len, cfg.num_buckets, host_shard=host_shard)
    trainloader = make_loader(cfg, train_ds, mode="train")
    validloader = make_loader(cfg, val_ds, mode="val")
    log.info(
        "total iterations in training phase : %d\ntotal iterations in validation phase : %d",
        len(trainloader), len(validloader),
    )

    model = build_model(cfg, len(vocab), device=device, generator=KeyChain(cfg.random_seed).generator("init"))
    eval_fn = make_trainer_eval_fn(model, cfg, validloader, vocab)
    trainer = Trainer(cfg, model, trainloader, validloader, eval_fn=eval_fn)
    trainer.train()
    log.info("done")
    return trainer


def _spawn(cfg: Config, device: torch.device) -> None:
    """Run ``cfg.num_devices`` ranks of this host as child processes, rank i
    on ``cuda:i`` or on the CPU, and wait for them."""
    n = cfg.num_devices
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"num_devices={n}, but this host has {torch.cuda.device_count()} CUDA device(s)")
    cfg = make_experiment_dir(cfg)
    store = os.path.join(cfg.expr_dir, RENDEZVOUS)
    if os.path.exists(store):
        os.remove(store)  # a store left by an earlier run would not meet
    torch.multiprocessing.spawn(_rank, args=(n, cfg, device.type, store), nprocs=n, join=True)
    return None


def _rank(rank: int, n: int, cfg: Config, device_type: str, store: str) -> None:
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    distributed.initialize(f"file://{store}", num_processes=n, process_id=rank, backend=_backend(device))
    try:
        _train(cfg, device)
    finally:
        dist.destroy_process_group()


def cli_entry() -> None:
    main(parse_config(sys.argv[1:]))


if __name__ == "__main__":
    cli_entry()
