"""Offline preprocessing: Karpathy-split COCO JSON -> vocab + caption records.

Behavior parity with the reference pipeline (preprocess.py):
- vocabulary from token counts with ``count >= word_count_threshold``
  (default 5; preprocess.py:71,153), special tokens first in the exact order
  ``<pad>,<start>,<end>,<unk>`` (preprocess.py:75-78),
- caption stats printout (total words, bad-word %, UNK %, length histogram;
  preprocess.py:31-49 — note the reference's stats use ``<=`` for bad words
  while the vocab keeps ``>=``, so threshold-count words appear in both;
  reproduced as-is),
- one output record **per sentence** with
  ``{split, imgid, cocoid, file_path, final_caption, sentids}``
  (preprocess.py:109-128),
- records sorted by caption length ascending (preprocess.py:133) — in this
  build that ordering also seeds the length-bucketing that replaces
  sort+pack,
- optional image resize to 256x256 (preprocess.py:86-101; squash resize,
  not aspect-preserving) through the canonical RGB ingest contract
  (pipeline._load_image), skip-and-report per failed file,
- the COCO-integrity check of 616,767 total captions (preprocess.py:130) is
  a warning rather than a hard assert so non-COCO datasets work.

Outputs are JSON (+Vocabulary JSON), not pickles, byte for byte the JAX
package's for the same input. PIL is imported only where an image is
resized.
"""

from __future__ import annotations

import json
import logging
import os
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

log = logging.getLogger(__name__)

COCO_TOTAL_CAPTIONS = 616767


def print_stats(words: Dict[str, int], sent_lengths: Dict[int, int], threshold: int) -> None:
    total_words = sum(words.values())
    bad_words = [w for w, n in words.items() if n <= threshold]
    vocab_words = [w for w, n in words.items() if n > threshold]
    bad_count = sum(words[w] for w in bad_words)
    log.info("total words: %d", total_words)
    log.info(
        "number of bad words: %d/%d = %.2f%%",
        len(bad_words), len(words), len(bad_words) * 100.0 / max(len(words), 1),
    )
    log.info("number of words in vocab would be %d", len(vocab_words))
    log.info(
        "number of UNKs: %d/%d = %.2f%%",
        bad_count, total_words, bad_count * 100.0 / max(total_words, 1),
    )
    if sent_lengths:
        max_len = max(sent_lengths)
        sum_len = sum(sent_lengths.values())
        log.info("max length sentence in raw data: %d", max_len)
        for i in range(max_len + 1):
            n = sent_lengths.get(i, 0)
            log.info("%2d: %10d   %f%%", i, n, n * 100.0 / sum_len)


def build_vocab(
    caption_json: str, word_count_threshold: int = 5, show_stats: bool = True
) -> Tuple[Vocabulary, List[dict]]:
    """Returns ``(vocab, images)`` from a Karpathy-format caption JSON."""
    if not os.path.exists(caption_json):
        raise FileNotFoundError(caption_json)
    with open(caption_json) as f:
        imgs = json.load(f)["images"]
    log.info("Load annotations from %s", caption_json)

    counter: Counter = Counter()
    sent_lengths: Dict[int, int] = {}
    for img in imgs:
        for sentence in img["sentences"]:
            counter.update(sentence["tokens"])
            n = len(sentence["tokens"])
            sent_lengths[n] = sent_lengths.get(n, 0) + 1

    if show_stats:
        print_stats(dict(counter), sent_lengths, word_count_threshold)

    words = [w for w, cnt in counter.items() if cnt >= word_count_threshold]
    vocab = Vocabulary.from_words(words)
    return vocab, imgs


def resize_image(img_path: str, out_path: str, size: int = 256) -> bool:
    """Squash-resize to size x size RGB via THE canonical ingest contract
    (data/pipeline._load_image — convert('RGB') BEFORE array inspection).

    The former ndim-based grayscale patch-up silently corrupted
    palette-mode (P) PNGs — their 2-D palette INDICES were stacked as if
    they were gray pixel values — and crashed saving LA-mode sources as
    JPEG (review fix, both verified live); PIL's mode conversion handles
    every mode correctly and keeps offline-preprocessed pixels identical
    to the online loader's."""
    try:
        from PIL import Image

        from show_and_tell_tpu_torch.data.pipeline import _load_image

        Image.fromarray(_load_image(img_path, size)).save(out_path)
        return True
    except Exception as e:  # mirror the swallow-and-report contract
        log.warning("resize failed for %s: %s", img_path, e)
        return False


def preprocess(cfg: Config, resize_images: bool = False, data_root: str = "data") -> Tuple[str, str]:
    """Full offline pass. Returns (vocab_path, data_json_path)."""
    vocab, imgs = build_vocab(
        cfg.caption_json, cfg.word_count_threshold, cfg.print_stats
    )

    resized_ok: Dict[str, bool] = {}
    if resize_images:
        # Resize on a thread pool: PIL decode/resize/JPEG-encode release the
        # GIL, so the 123k-image COCO pass scales ~linearly with cores
        # instead of taking hours serially (the reference loop,
        # preprocess.py:109-123, is single-threaded). Records are still
        # assembled in the original sequential order below, so data.json is
        # byte-identical to the serial pass.
        jobs: List[Tuple[str, str]] = []
        for img in imgs:
            src = os.path.join(
                cfg.images_root, img.get("filepath", ""), img["filename"]
            )
            if src not in resized_ok:
                resized_ok[src] = False  # placeholder; keeps jobs deduped
                jobs.append(
                    (src, os.path.join(data_root, img.get("filepath", ""), img["filename"]))
                )
        for d in {os.path.dirname(p) for _, p in jobs}:
            os.makedirs(d or ".", exist_ok=True)
        workers = max(1, int(getattr(cfg, "num_workers", 8)))
        done = 0
        with ThreadPoolExecutor(max_workers=workers) as ex:
            for (src, _), ok in zip(jobs, ex.map(lambda j: resize_image(*j), jobs)):
                resized_ok[src] = ok
                done += 1
                if done % 10000 == 0:
                    log.info("resized %d/%d images", done, len(jobs))

    out: List[dict] = []
    resize_failures: List[str] = []
    for i, img in enumerate(imgs):
        save_path = os.path.join(data_root, img.get("filepath", ""), img["filename"])
        if resize_images:
            src = os.path.join(cfg.images_root, img.get("filepath", ""), img["filename"])
            if not resized_ok[src]:
                # swallow-and-report (the reference's contract,
                # preprocess.py:89-92): one odd file hours into a 123k-image
                # pass must not abort the run and discard completed work
                # (review fix — this used to raise). The image's caption
                # records are dropped with it so data.json never points at
                # a file that was not written.
                resize_failures.append(src)
                continue
        base = {
            "split": img["split"],
            "imgid": img["imgid"],
            "cocoid": img.get("cocoid", img["imgid"]),
            "file_path": save_path,
        }
        for si, sentence in enumerate(img["sentences"]):
            rec = dict(base)
            rec["final_caption"] = sentence["tokens"]
            rec["sentids"] = img["sentids"][si] if "sentids" in img else si
            out.append(rec)

    if resize_failures:
        log.warning(
            "%d image(s) failed to resize and were skipped (with their "
            "caption records): %s%s",
            len(resize_failures), resize_failures[:5],
            "…" if len(resize_failures) > 5 else "",
        )
    # warning-only, always checked (the reference hard-asserts 616,767 at
    # preprocess.py:130; non-COCO datasets legitimately differ)
    if len(out) != COCO_TOTAL_CAPTIONS:
        log.warning(
            "caption count %d != COCO's %d (fine for non-COCO data)",
            len(out), COCO_TOTAL_CAPTIONS,
        )

    out.sort(key=lambda x: len(x["final_caption"]))

    os.makedirs(os.path.dirname(cfg.vocab_path) or ".", exist_ok=True)
    vocab.save(cfg.vocab_path)
    os.makedirs(os.path.dirname(cfg.output_json) or ".", exist_ok=True)
    with open(cfg.output_json, "w") as f:
        json.dump(out, f)
    log.info("saved vocab (%d words) to %s", len(vocab), cfg.vocab_path)
    log.info("saved %d caption records to %s", len(out), cfg.output_json)

    if getattr(cfg, "memmap_dir", None):
        # opt-in decode-free storage (data/memmap.py): decode every record
        # image ONCE here so the training loader never touches a codec
        from show_and_tell_tpu_torch.data.memmap import pack_memmap

        pack_memmap(
            [r["file_path"] for r in out],
            cfg.memmap_dir,
            num_workers=max(1, int(getattr(cfg, "num_workers", 8))),
        )
    return cfg.vocab_path, cfg.output_json
