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
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Union

import torch

from show_and_tell_tpu_torch.config import Config, parse_config
from show_and_tell_tpu_torch.data.dataset import CocoCaptionDataset
from show_and_tell_tpu_torch.data.pipeline import make_loader
from show_and_tell_tpu_torch.evalsuite.driver import make_trainer_eval_fn
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.train.trainer import Trainer
from show_and_tell_tpu_torch.utils.device import resolve_device
from show_and_tell_tpu_torch.utils.experiment import make_experiment_dir
from show_and_tell_tpu_torch.utils.logging import setup_logging
from show_and_tell_tpu_torch.utils.rng import KeyChain
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

log = logging.getLogger(__name__)


def main(cfg: Config, device: Union[str, torch.device] = "cuda") -> Trainer:
    if cfg.multihost:
        raise NotImplementedError("multihost: multi-device training is not ported yet; see ROADMAP.md A9")
    device = resolve_device(device)
    cfg = make_experiment_dir(cfg)
    # the log lives in the experiment dir; a resumed run appends to it
    setup_logging(os.path.join(cfg.expr_dir, "log.txt"), mode="a" if cfg.start_from else "w")
    log.info("run arguments: %s", json.dumps(cfg.to_dict(), indent=4, sort_keys=True))

    vocab = Vocabulary.load(cfg.vocab_path)
    with open(cfg.data_json) as f:
        records = json.load(f)
    train_ds = CocoCaptionDataset(records, vocab, "train", cfg.max_caption_len, cfg.num_buckets)
    val_ds = CocoCaptionDataset(records, vocab, "val", cfg.max_caption_len, cfg.num_buckets)
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


def cli_entry() -> None:
    main(parse_config(sys.argv[1:]))


if __name__ == "__main__":
    cli_entry()
