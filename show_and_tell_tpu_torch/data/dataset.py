"""COCO caption dataset with static-shape length bucketing.

The JAX package's dataset, in plain numpy, so that the same records and the
same ``np.random.Generator`` give the same batch plans in both packages.
Replaces the reference's ``CocoDataset`` + sort-by-length ``collate_fn``
(data_loader.py:12-62): instead of sorting and packing each batch,

- records (one per caption, from preprocess) are grouped into
  ``num_buckets`` length buckets with *fixed* padded lengths — a handful of
  static shapes,
- captions are encoded ``<start>`` + ids + ``<end>`` (data_loader.py:36-39)
  and zero-padded with ``<pad>``; per-sample lengths ride along for the loss
  mask (replacing pack),
- batches are drawn bucket-by-bucket so padded-step waste stays small —
  recovering the compute savings the reference got from packing.

Item metadata (imgid for eval dedup, file_path for image loading, cocoid for
pycocoevalcap) matches the reference record schema (preprocess.py:109-128).
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from show_and_tell_tpu_torch.utils.shapes import round_up
from show_and_tell_tpu_torch.utils.vocab import Vocabulary


# bucket edges pad caption lengths to multiples of this
BUCKET_MULTIPLE = 4


class CocoCaptionDataset:
    def __init__(
        self,
        records,  # path to data.json or a list of records
        vocab: Vocabulary,
        split: str = "train",
        max_caption_len: int = 57,
        num_buckets: int = 4,
        host_shard=None,  # (data index, data axis size) for multi-host IO
    ):
        if isinstance(records, str):
            with open(records) as f:
                records = json.load(f)
        self.vocab = vocab
        self.split = split
        self.max_caption_len = max_caption_len
        # split filter: data_loader.py:21
        self.data = [r for r in records if r["split"] == split]
        if host_shard is not None and host_shard[1] > 1:
            idx, n = host_shard
            self.data = self.data[idx::n]  # disjoint record shards per data index
        self._build_buckets(num_buckets)

    def _build_buckets(self, num_buckets: int) -> None:
        # encoded length = tokens + <start> + <end>, capped at max_caption_len
        enc_lens = np.array(
            [min(len(r["final_caption"]) + 2, self.max_caption_len) for r in self.data]
        )
        if len(enc_lens) == 0:
            self.buckets: List[Dict] = []
            return
        qs = np.quantile(enc_lens, np.linspace(0, 1, num_buckets + 1)[1:])
        edges = sorted(set(int(round_up(q, BUCKET_MULTIPLE)) for q in qs))
        edges[-1] = round_up(int(enc_lens.max()), BUCKET_MULTIPLE)
        buckets = []
        assigned = np.zeros(len(enc_lens), bool)
        for edge in edges:
            idx = np.where((enc_lens <= edge) & ~assigned)[0]
            assigned[idx] = True
            if len(idx):
                buckets.append({"pad_len": min(edge, self.max_caption_len), "indices": idx})
        self.buckets = buckets

    def __len__(self) -> int:
        return len(self.data)

    def encode_indices(self, indices: Sequence[int], pad_len: int):
        """Encode records[indices] -> (captions [n, pad_len], lengths [n])."""
        toks = [self.data[i]["final_caption"] for i in indices]
        return self.vocab.encode_batch(toks, pad_len)

    def batch_meta(self, indices: Sequence[int]) -> Dict[str, list]:
        return {
            "imgids": [self.data[i]["imgid"] for i in indices],
            "cocoids": [self.data[i]["cocoid"] for i in indices],
            "paths": [self.data[i]["file_path"] for i in indices],
        }

    def iter_index_batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        rng: Optional[np.random.Generator] = None,
        drop_remainder: bool = False,
    ) -> Iterator[Dict]:
        """Yields {'indices', 'pad_len'} drawn bucket-by-bucket.

        A short final batch is padded by repeating its last index so shapes
        stay static (the duplicate rows are masked out downstream: training
        sees them as extra samples of real data; eval dedups by imgid exactly
        as the reference does, eval.py:112-118).

        ``rng=None`` with ``shuffle=True`` draws FRESH entropy — a fixed
        default seed here made every epoch of a direct caller reuse one
        identical "shuffled" order (review fix); the Loader threads its own
        seeded per-epoch rng for reproducible runs.
        """
        rng = rng or np.random.default_rng()
        plan = []
        for b in self.buckets:
            idx = b["indices"].copy()
            if shuffle:
                rng.shuffle(idx)
            for s in range(0, len(idx), batch_size):
                chunk = idx[s : s + batch_size]
                if len(chunk) < batch_size:
                    if drop_remainder:
                        continue
                    pad = np.full(batch_size - len(chunk), chunk[-1])
                    chunk = np.concatenate([chunk, pad])
                plan.append({"indices": chunk, "pad_len": b["pad_len"]})
        if shuffle:
            rng.shuffle(plan)
        yield from plan

    def num_batches(self, batch_size: int, drop_remainder: bool = False) -> int:
        n = 0
        for b in self.buckets:
            full, rem = divmod(len(b["indices"]), batch_size)
            n += full + (1 if rem and not drop_remainder else 0)
        return n
