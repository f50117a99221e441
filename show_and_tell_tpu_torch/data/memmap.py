"""Decode-free dataset storage: pre-decoded uint8 image shards, memory-mapped.

The reference's preprocessing resizes images to 256x256 JPEGs on disk
(preprocess.py:86-101) so that training-time decode is cheap, but it is
still a JPEG decode per image per epoch on the host. Here the images are
decoded ONCE, into raw ``[N, size, size, 3]`` uint8 shards, and training
batches are served by a memory-mapped gather: no codec on the hot path. It
is also how images reach a host without an image codec (the card's host has
no PIL): whoever writes the shards in this layout feeds the loader.

Layout under ``<dir>/`` (the JAX package's, so one directory serves both):
    index.json            {"image_size", "items_per_shard", "shards": [...],
                           "paths": {file_path: global_index}}
    shard_00000.u8        raw uint8, items_per_shard * size*size*3 bytes
    shard_00001.u8        ...

The writer (:func:`pack_memmap`) decodes through the same ingest contract as
the online loader (``pipeline._load_image`` or the C++ batch decoder), so a
memmap-fed batch is bit-identical to a decode-fed one. Images that fail to
decode are left out of the index; the Loader decodes missing keys online,
under its corrupt policy.

Against the JAX package: before reusing an existing index, the writer checks
that every listed shard exists at its expected size (``items_per_shard``
rows for each shard but the last, the remainder for the last). The JAX
writer trusts ``index.json`` alone, so a deleted or truncated shard is
reported as "already covers all images" and fails mid-epoch; here it is
rebuilt.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

INDEX = "index.json"


def _shard_name(i: int) -> str:
    return f"shard_{i:05d}.u8"


def _shards_complete(out_dir: str, index: Dict) -> bool:
    """Every shard the index lists is on disk at the size its rows need;
    raises OSError for a missing one."""
    n = len(index["paths"])
    per = int(index["items_per_shard"])
    item_bytes = int(index["image_size"]) ** 2 * 3
    shards = index["shards"]
    return len(shards) == -(-n // per) and all(
        os.path.getsize(os.path.join(out_dir, name)) == min(per, n - i * per) * item_bytes
        for i, name in enumerate(shards)
    )


def pack_memmap(
    paths: Sequence[str],
    out_dir: str,
    size: int = 256,
    items_per_shard: int = 8192,
    num_workers: int = 8,
    native_decode: Optional[bool] = None,
) -> str:
    """Decode ``paths`` (deduplicated, order-preserving) into uint8 shards
    under ``out_dir``. Returns the index path. Idempotent: an existing index
    for the same size that covers every path, with every shard it lists
    whole, is left untouched."""
    from show_and_tell_tpu_torch.data import pipeline as pipe

    uniq: List[str] = list(dict.fromkeys(paths))
    os.makedirs(out_dir, exist_ok=True)
    index_path = os.path.join(out_dir, INDEX)
    if os.path.exists(index_path):
        try:
            with open(index_path) as f:
                existing = json.load(f)
            if existing.get("image_size") == size and set(existing.get("paths", {})) >= set(uniq):
                if _shards_complete(out_dir, existing):
                    log.info("memmap pack: %s already covers all %d images", index_path, len(uniq))
                    return index_path
                log.warning("memmap pack: a shard listed in %s is short: rebuilding", index_path)
        except (OSError, KeyError, TypeError, ValueError):  # ValueError: bad JSON
            log.warning("memmap pack: %s is torn or a shard it lists is missing: rebuilding", index_path)
        # A rebuild overwrites shard files in place; the old index goes
        # first, or a crash mid-pack leaves a valid-looking index mapping
        # rows into half-rewritten shards. With no index, readers
        # (make_loader) decode until the new index lands below.
        os.remove(index_path)

    item_bytes = size * size * 3
    index: Dict = {"image_size": size, "items_per_shard": items_per_shard, "shards": [], "paths": {}}
    next_idx = 0
    shard_f = None
    use_native = native_decode is not False and pipe._native_available()
    if native_decode and not use_native:
        raise RuntimeError(f"native_decode=True but {pipe.NATIVE_LIB} cannot be built on this host")
    batch = 256
    try:
        for lo in range(0, len(uniq), batch):
            chunk = uniq[lo:lo + batch]
            if use_native:
                images, ok = pipe._native_load_batch(chunk, size, num_workers)
                for i in np.nonzero(~ok)[0]:  # PIL per failure
                    images[i], ok[i] = pipe._load_image_checked(chunk[i], size)
            else:
                loaded = [pipe._load_image_checked(p, size) for p in chunk]
                images = np.stack([im for im, _ in loaded])
                ok = np.array([o for _, o in loaded], dtype=bool)
            for i, p in enumerate(chunk):
                if not ok[i]:
                    log.warning("memmap pack: skipping undecodable %s", p)
                    continue
                if shard_f is None or next_idx % items_per_shard == 0:
                    if shard_f is not None:
                        shard_f.close()
                    name = _shard_name(len(index["shards"]))
                    index["shards"].append(name)
                    shard_f = open(os.path.join(out_dir, name), "wb")
                shard_f.write(images[i].tobytes())
                index["paths"][p] = next_idx
                next_idx += 1
            written = lo + len(chunk)
            if written % 10240 < batch:
                log.info("memmap pack: %d/%d images", written, len(uniq))
    finally:
        if shard_f is not None:
            shard_f.close()
    tmp = index_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(index, f)
    os.replace(tmp, index_path)  # atomic: readers never see a torn index
    log.info("memmap pack: %d images -> %d shard(s) in %s (%.1f GB)",
             next_idx, len(index["shards"]), out_dir, next_idx * item_bytes / 1e9)
    return index_path


class MemmapImages:
    """Read side: O(1) decode-free image lookup by the record ``file_path``.

    Shards open lazily as ``np.memmap`` views and stay open; ``get_batch``
    gathers rows into a fresh contiguous array, so no view of a shard
    escapes into a batch."""

    def __init__(self, dir_path: str):
        self.dir = dir_path
        with open(os.path.join(dir_path, INDEX)) as f:
            idx = json.load(f)
        self.size = int(idx["image_size"])
        self.items_per_shard = int(idx["items_per_shard"])
        self.shard_names: List[str] = idx["shards"]
        self.paths: Dict[str, int] = idx["paths"]
        self._maps: List[Optional[np.memmap]] = [None] * len(self.shard_names)

    def __contains__(self, path: str) -> bool:
        return path in self.paths

    def __len__(self) -> int:
        return len(self.paths)

    def _shard(self, s: int) -> np.memmap:
        m = self._maps[s]
        if m is None:
            item = (self.size, self.size, 3)
            path = os.path.join(self.dir, self.shard_names[s])
            n = os.path.getsize(path) // (self.size * self.size * 3)
            m = np.memmap(path, dtype=np.uint8, mode="r", shape=(n, *item))
            self._maps[s] = m
        return m

    def get(self, path: str) -> np.ndarray:
        g = self.paths[path]
        return self._shard(g // self.items_per_shard)[g % self.items_per_shard]

    def get_batch(self, paths: Sequence[str], out: Optional[np.ndarray] = None) -> np.ndarray:
        if out is None:
            out = np.empty((len(paths), self.size, self.size, 3), np.uint8)
        for i, p in enumerate(paths):
            out[i] = self.get(p)
        return out
