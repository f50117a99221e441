"""Standalone evaluation entry point.

Usage::

    python -m show_and_tell_tpu_torch.cli.evaluate --data_json data/data.json \
        --vocab_path data/vocab.json --load_model_path experiment/u/e \
        --encoder_weights vgg16.pth --ann_file captions_val2014.json --beam_size 3

Evaluates the val split: beam search when ``--beam_size`` > 1, else greedy,
as the JAX package's CLI. The model starts from the ``"init"`` stream of
``KeyChain(cfg.random_seed)``; ``--encoder_weights`` sets the frozen trunk,
which checkpoints do not hold; ``--load_model_path`` (the port's
``model-best.pt`` or the JAX package's ``model-best.msgpack``) or
``--torch_checkpoint`` (a reference-format ``.pth``) the decoder. With
``--quantize_backbone`` the trunk runs in int8, calibrated on the first val
batch (or read from ``--quantized_backbone_path``). It runs on
the GPU, and raises without one; ``main(argv, device="cpu")`` runs on the
CPU.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Union

import torch

from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.config import parse_config
from show_and_tell_tpu_torch.data.dataset import CocoCaptionDataset
from show_and_tell_tpu_torch.data.pipeline import make_loader
from show_and_tell_tpu_torch.evalsuite.driver import evaluation
from show_and_tell_tpu_torch.models import quantize
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.utils.device import resolve_device
from show_and_tell_tpu_torch.utils.logging import setup_logging
from show_and_tell_tpu_torch.utils.rng import KeyChain
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

log = logging.getLogger(__name__)


def main(argv=None, device: Union[str, torch.device] = "cuda"):
    cfg = parse_config(argv if argv is not None else sys.argv[1:])
    device = resolve_device(device)
    setup_logging("eval_log.txt")
    vocab = Vocabulary.load(cfg.vocab_path)
    with open(cfg.data_json) as f:
        records = json.load(f)
    val_ds = CocoCaptionDataset(records, vocab, "val", cfg.max_caption_len, cfg.num_buckets)
    loader = make_loader(cfg, val_ds, mode="val")

    model = build_model(cfg, len(vocab), device=device, generator=KeyChain(cfg.random_seed).generator("init"))
    if cfg.encoder_weights:
        from show_and_tell_tpu_torch.ckpt.torch_import import load_encoder_weights

        load_encoder_weights(cfg, model)
    if cfg.torch_checkpoint:
        # a reference-trained model-best.pth, evaluated as it is
        from show_and_tell_tpu_torch.ckpt.torch_import import apply_reference_checkpoint

        has_enc = apply_reference_checkpoint(cfg, model)
        if not has_enc and not cfg.encoder_weights and not cfg.features_path:
            log.warning(
                "--torch_checkpoint %s carries no encoder weights and --encoder_weights is unset: "
                "the frozen encoder is randomly initialized — expect near-zero scores.",
                cfg.torch_checkpoint,
            )
        if cfg.load_model_path:
            log.warning(
                "--torch_checkpoint overrides --load_model_path: the checkpoint in %s is NOT being evaluated",
                cfg.load_model_path,
            )
    elif cfg.load_model_path:
        if not cfg.encoder_weights and not cfg.features_path:
            log.warning(
                "--load_model_path given without --encoder_weights: the frozen encoder is randomly "
                "initialized (checkpoints do not store it). Pass the same --encoder_weights used in "
                "training, or expect near-zero scores."
            )
        if ckpt.load_best_params(cfg.load_model_path, ckpt.trainable_state_dict(model), model.batch_stats) is None:
            raise SystemExit(f"no checkpoint found in {cfg.load_model_path}")

    if quantize.needs_calibration(model, cfg) and not cfg.features_path:
        # the int8 trunk, calibrated on the first val batch's images
        first = next(iter(loader))
        if "images" in first:
            quantize.calibrate_model(model, cfg, torch.as_tensor(first["images"][:32]).to(device))
            log.info("backbone quantized to int8 (calibrated on %d images)", min(32, len(first["images"])))

    mode = "beam" if cfg.beam_size > 1 else "greedy"
    val_loss, preds, stats = evaluation(model, cfg, loader, vocab, mode=mode, ann_file=cfg.ann_file)
    log.info("val loss: %.4f", val_loss)
    for k, v in stats.items():
        log.info("%s: %.4f", k, v)
    return val_loss, preds, stats


if __name__ == "__main__":
    main()
