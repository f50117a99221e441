"""Feature extraction: run the frozen encoder once over a dataset and save
per-image features for decoder-only training and eval (``--features_path``).

The reference recomputes the frozen CNN on every epoch of every run; with
the encoder frozen that work is the same each time, so computing it once
turns decoder training into a features -> LSTM problem and eval into pure
decode.

Usage::

    python -m show_and_tell_tpu_torch.cli.extract_features \
        --data_json data/data.json --vocab_path data/vocab.json \
        --encoder_weights vgg16.pth --output_json features.npz

The trunk is the model's (``"init"`` stream of ``KeyChain(cfg.random_seed)``,
then ``--encoder_weights``), run as ``backbone_features(eval_transform(x))``
in the compute dtype and saved as fp32, one entry per image, keyed by
``str(cocoid)``. Images come from the memmap shards of ``--memmap_dir`` when
their index exists (the JAX CLI always decodes), else they are decoded. It
runs on the GPU, and raises without one; ``extract(cfg, device="cpu")`` runs
on the CPU.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Union

import numpy as np
import torch

from show_and_tell_tpu_torch.config import Config, parse_config
from show_and_tell_tpu_torch.data.dataset import CocoCaptionDataset
from show_and_tell_tpu_torch.data.pipeline import Loader
from show_and_tell_tpu_torch.data.transforms import eval_transform
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.utils.device import resolve_device
from show_and_tell_tpu_torch.utils.logging import setup_logging
from show_and_tell_tpu_torch.utils.rng import KeyChain
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

log = logging.getLogger(__name__)


def extract(cfg: Config, splits=("train", "val"), device: Union[str, torch.device] = "cuda") -> str:
    """Returns the path of the saved .npz (keys = str(cocoid))."""
    device = resolve_device(device)
    vocab = Vocabulary.load(cfg.vocab_path)
    with open(cfg.data_json) as f:
        records = json.load(f)
    model = build_model(cfg, len(vocab), device=device, generator=KeyChain(cfg.random_seed).generator("init"))
    if cfg.encoder_weights:
        from show_and_tell_tpu_torch.ckpt.torch_import import load_encoder_weights

        load_encoder_weights(cfg, model)
    memmap_images = None
    if cfg.memmap_dir and os.path.exists(os.path.join(cfg.memmap_dir, "index.json")):
        memmap_images = cfg.memmap_dir

    out = {}
    for split in splits:
        # one record per image: the dataset holds one per caption (~5 per
        # image on COCO), and the features of an image are the same for all
        seen, unique_records = set(), []
        for r in records:
            if r.get("split") == split and r["cocoid"] not in seen:
                seen.add(r["cocoid"])
                unique_records.append(r)
        ds = CocoCaptionDataset(unique_records, vocab, split, cfg.max_caption_len, 1)
        loader = Loader(ds, cfg.batch_size, shuffle=False, num_workers=cfg.num_workers,
                        memmap_images=memmap_images)
        n_before = len(out)
        with torch.no_grad():
            for batch in loader:
                x = torch.as_tensor(batch["images"]).to(device)
                feats = model.backbone_features(eval_transform(x, cfg.crop_size)).float().cpu().numpy()
                for cocoid, f in zip(batch["cocoids"], feats):
                    out[str(cocoid)] = f
        log.info("%s: %d images encoded", split, len(out) - n_before)

    path = cfg.output_json if cfg.output_json.endswith(".npz") else cfg.output_json + ".npz"
    np.savez_compressed(path, **out)
    log.info("saved %d feature maps to %s", len(out), path)
    return path


def main(argv=None, device: Union[str, torch.device] = "cuda"):
    cfg = parse_config(argv if argv is not None else sys.argv[1:])
    setup_logging("extract_log.txt")
    return extract(cfg, device=device)


if __name__ == "__main__":
    main()
