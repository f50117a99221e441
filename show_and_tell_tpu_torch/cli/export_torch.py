"""Export a trained checkpoint as a reference-format ``model-best.pth``: a
``state_dict`` keyed like the reference's ``ShowAttendTellModel``, or with
``--model show_tell`` its ``DecoderRNN``/``EncoderCNN`` under ``decoder.`` and
``encoder.``, which ``torch.load`` + ``load_state_dict`` read
(``ckpt/torch_export.py``).

Usage::

    python -m show_and_tell_tpu_torch.cli.export_torch \
        --vocab_path data/vocab.json --load_model_path experiment/u/e \
        --encoder_weights vgg16.pth --export_path model-best.pth

A Show-Attend-Tell export holds the ``encoder.*`` VGG16 trunk, as the
reference's save does, and checkpoints hold none: pass the
``--encoder_weights`` the model was trained with, or the export carries a
random trunk (warned about). A Show-and-Tell export holds the projection,
the BatchNorm and its running statistics, and no trunk.

It runs on the GPU and raises without one; ``main(argv, device="cpu")`` runs
on the CPU.
"""

from __future__ import annotations

import logging
import sys
from typing import Union

import torch

from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.ckpt.torch_export import export_checkpoint
from show_and_tell_tpu_torch.config import parse_config
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.utils.device import resolve_device
from show_and_tell_tpu_torch.utils.logging import setup_logging
from show_and_tell_tpu_torch.utils.rng import KeyChain
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

log = logging.getLogger(__name__)


def main(argv=None, device: Union[str, torch.device] = "cuda"):
    argv = list(sys.argv[1:] if argv is None else argv)
    # --export_path is this CLI's own flag, not a Config field: take it out
    # first, as "--export_path OUT" or "--export_path=OUT"
    out_path = None
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--export_path":
            if i + 1 >= len(argv):
                raise SystemExit("--export_path requires a value")
            out_path = argv[i + 1]
            i += 2
            continue
        if a.startswith("--export_path="):
            out_path = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    if not out_path:
        raise SystemExit("--export_path OUT.pth is required")
    cfg = parse_config(rest)
    device = resolve_device(device)
    setup_logging("export_log.txt")
    if not cfg.load_model_path:
        raise SystemExit("--load_model_path <experiment dir> is required")
    vocab = Vocabulary.load(cfg.vocab_path)
    model = build_model(cfg, len(vocab), device=device, generator=KeyChain(cfg.random_seed).generator("init"))
    if cfg.encoder_weights:
        from show_and_tell_tpu_torch.ckpt.torch_import import load_encoder_weights

        load_encoder_weights(cfg, model)
    elif cfg.model == "show_attend_tell":
        log.warning(
            "exporting without --encoder_weights: the state_dict's encoder.* trunk is randomly initialized "
            "(checkpoints do not store it)"
        )
    if ckpt.load_best_params(cfg.load_model_path, ckpt.trainable_state_dict(model), model.batch_stats) is None:
        raise SystemExit(f"no checkpoint found under {cfg.load_model_path}")
    export_checkpoint(cfg, model.state_dict(), out_path)
    log.info("exported %s (%s) -> %s", cfg.load_model_path, cfg.model, out_path)
    print(out_path)
    return out_path


if __name__ == "__main__":
    main()
