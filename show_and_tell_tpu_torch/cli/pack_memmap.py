"""Pack an already-preprocessed dataset into decode-free uint8 memmap shards.

For datasets whose ``data.json`` exists (cli.preprocess without
``--memmap_dir``, or the reference's own preprocessing output migrated via
docs/MIGRATION.md), this packs every record image once so training never
decodes again (data/memmap.py):

    python -m show_and_tell_tpu_torch.cli.pack_memmap \
        --data_json data/data.json --memmap_dir data/memmap

Training and eval then pick the shards up through the same ``--memmap_dir``
flag (data/pipeline.make_loader). The shards are the JAX package's layout,
so one directory serves both packages.
"""

from __future__ import annotations

import json
import logging
import sys

from show_and_tell_tpu_torch.config import parse_config
from show_and_tell_tpu_torch.data.memmap import pack_memmap


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO)
    cfg = parse_config(sys.argv[1:] if argv is None else argv)
    if not cfg.memmap_dir:
        raise SystemExit("--memmap_dir is required")
    with open(cfg.data_json) as f:
        records = json.load(f)
    return pack_memmap(
        [r["file_path"] for r in records],
        cfg.memmap_dir,
        num_workers=max(1, cfg.num_workers),
        native_decode=cfg.native_decode,
    )


if __name__ == "__main__":
    main()
