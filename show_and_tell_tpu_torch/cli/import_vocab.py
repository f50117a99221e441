"""Convert a reference ``vocab.pkl`` to this framework's ``vocab.json``.

The reference persists its vocabulary as a (typically Python-2) pickle of a
``Vocabulary`` instance (preprocess.py:136); every other reference artifact
(checkpoints, data.json) indexes words through it. This one-shot converter
lets a reference user carry that exact index assignment over — required for
``--torch_checkpoint`` imports, whose embedding/logit rows are keyed by the
original indices.

Usage::

    python -m show_and_tell_tpu_torch.cli.import_vocab data/vocab.pkl data/vocab.json
"""

from __future__ import annotations

import argparse
import sys

from show_and_tell_tpu_torch.utils.vocab import Vocabulary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert a reference vocab.pkl to vocab.json"
    )
    p.add_argument("pkl_path", help="reference vocab.pkl (py2 or py3 pickle)")
    p.add_argument("json_path", help="output vocab.json path")
    args = p.parse_args(argv)

    vocab = Vocabulary.from_reference_pickle(args.pkl_path)
    vocab.save(args.json_path)
    print(f"converted {args.pkl_path} -> {args.json_path} ({len(vocab)} words)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
