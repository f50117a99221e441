"""Preprocessing entry point (the reference ``preprocess.py`` CLI,
preprocess.py:142-161).

Usage::

    python -m show_and_tell_tpu_torch.cli.preprocess --caption_json \
        dataset_coco.json --images_root /data/coco --output_json \
        data/data.json --vocab_path data/vocab.json
"""

from __future__ import annotations

import sys

from show_and_tell_tpu_torch.config import parse_config
from show_and_tell_tpu_torch.data.preprocess import preprocess
from show_and_tell_tpu_torch.utils.logging import setup_logging


def main(argv=None) -> None:
    cfg = parse_config(argv if argv is not None else sys.argv[1:])
    setup_logging("preprocess_log.txt")
    if not cfg.caption_json:
        raise SystemExit("--caption_json is required")
    preprocess(cfg, resize_images=cfg.images_root is not None)


if __name__ == "__main__":
    main()
