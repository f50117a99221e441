"""Caption image files from a trained checkpoint.

Usage::

    python -m show_and_tell_tpu_torch.cli.caption \
        --vocab_path data/vocab.json --load_model_path experiment/u/e \
        --encoder_weights vgg16.pth --beam_size 3 \
        img1.jpg img2.jpg some/dir/

Positional arguments are image files and directories (their jpg, jpeg and
png files, not recursive). It prints one JSON line per image,
``{"image": path, "caption": text}``; a file that does not decode gets
``serve.ERROR_CAPTION`` and an ``"error"`` key, and the run then exits
non-zero. The decode is greedy for ``--beam_size`` 1, else beam search; for
sampling use the ``Captioner`` itself (``temperature``, ``top_k``,
``top_p``). ``--attention_dir DIR`` also writes one attention contact sheet
per image (greedy decode) and adds its path to the line. Files are read by
PIL.

It runs on the GPU and raises without one; ``main(argv, device="cpu")`` runs
on the CPU.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import List, Union

import numpy as np
import torch

from show_and_tell_tpu_torch.config import parse_config
from show_and_tell_tpu_torch.serve import Captioner
from show_and_tell_tpu_torch.utils.logging import setup_logging
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

log = logging.getLogger(__name__)

_EXTS = (".jpg", ".jpeg", ".png")


def _expand(paths: List[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(os.path.join(p, f) for f in sorted(os.listdir(p)) if f.lower().endswith(_EXTS))
        else:
            out.append(p)
    return out


def _split_args(argv: List[str]) -> tuple:
    """Image paths apart from ``--flag value`` pairs. Every config flag takes
    exactly one value, so the split is deterministic; ``--help`` and a
    following ``--flag`` are never taken as values, and a path swallowed as
    one shows up as a missing positional in ``main``."""
    image_args: List[str] = []
    flag_args: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            flag_args.append(a)
        elif a.startswith("--"):
            flag_args.append(a)
            if "=" not in a and i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                flag_args.append(argv[i + 1])
                i += 1
        else:
            image_args.append(a)
        i += 1
    return image_args, flag_args


def _write_sheets(cap: Captioner, paths: List[str], attention_dir: str) -> dict:
    """One contact sheet per decodable image, one largest bucket of files at
    a time, so that neither the images nor their [N, T, L] maps are all in
    memory at once. Returns {index: sheet path}."""
    from show_and_tell_tpu_torch.data.pipeline import _load_image_checked
    from show_and_tell_tpu_torch.utils.visualize import attention_sheet, model_view

    os.makedirs(attention_dir, exist_ok=True)
    sheets, used = {}, set()
    chunk = max(cap.bucket_sizes)
    for s in range(0, len(paths), chunk):
        loaded = [_load_image_checked(p) for p in paths[s : s + chunk]]
        ok_idx = [i for i, (_, ok) in enumerate(loaded) if ok]
        if not ok_idx:
            continue
        imgs = np.stack([loaded[i][0] for i in ok_idx])
        caps, alphas = cap.caption_with_attention(imgs)
        for j, i in enumerate(ok_idx):
            base = os.path.splitext(os.path.basename(paths[s + i]))[0]
            # inputs of one basename in two directories keep a sheet each,
            # and the fallback name is checked again too
            name, k = base + "_attention.png", 0
            while name in used:
                k += 1
                name = f"{base}_{k}_attention.png"
            used.add(name)
            out = os.path.join(attention_dir, name)
            words = caps[j].split() or ["<no caption>"]
            attention_sheet(model_view(imgs[j], cap.cfg.crop_size), alphas[j], words).save(out)
            sheets[s + i] = out
    return sheets


def main(argv=None, device: Union[str, torch.device] = "cuda"):
    argv = list(sys.argv[1:] if argv is None else argv)
    image_args, flag_args = _split_args(argv)
    cfg = parse_config(flag_args)
    setup_logging("caption_log.txt")
    missing = [p for p in image_args if not os.path.exists(p)]
    if missing:
        raise SystemExit(f"no such file or directory: {missing}")
    paths = _expand(image_args)
    if not paths:
        raise SystemExit("no images given (files or directories)")
    vocab = Vocabulary.load(cfg.vocab_path)
    cap = Captioner.from_checkpoint(cfg, cfg.load_model_path, vocab, device=device)
    if cfg.attention_dir and not hasattr(cap.model, "greedy_with_attention"):
        # before any device work
        raise SystemExit(
            f"--attention_dir requires an attention model; {cfg.model!r} exposes no attention maps "
            "(only show_attend_tell does)"
        )
    captions = cap.caption_paths(paths, mode="greedy" if cfg.beam_size <= 1 else "beam")
    failed = {i for i, _ in cap.last_errors}
    sheets = _write_sheets(cap, paths, cfg.attention_dir) if cfg.attention_dir else {}
    results = []
    for i, (path, caption) in enumerate(zip(paths, captions)):
        rec = {"image": path, "caption": caption}
        if i in failed:
            rec["error"] = "image failed to decode"
        if i in sheets:
            rec["attention_sheet"] = sheets[i]
        print(json.dumps(rec))
        results.append(rec)
    if failed:
        # the lines are out; the exit code tells scripts that check only $?
        raise SystemExit(
            f"{len(failed)} of {len(paths)} image(s) failed to decode: "
            + ", ".join(p for _, p in cap.last_errors[:5])
            + ("…" if len(failed) > 5 else "")
        )
    return results


if __name__ == "__main__":
    main()
