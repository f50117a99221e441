"""Host-side input pipeline: image ingest, parallel decode and prefetch.

The JAX package's pipeline, in numpy: for the same dataset, seed and images
the ``Loader`` yields the same batches, key by key and byte for byte. It
replaces torch ``DataLoader(num_workers, collate_fn)`` (data_loader.py:64-77):

- a thread pool builds the *next* batches (decode, memmap gather or feature
  lookup) while the device runs the current step; at most ``prefetch_depth +
  num_workers`` batches are materialized or in flight, with consumer
  backpressure, so a slow consumer never holds the epoch in host memory;
- images leave the host as uint8 (the crop, flip and normalisation run on
  the device, ``data/transforms.py``), captions as int32; the trainer moves
  them to the card;
- batches come from the length-bucketed dataset, so shapes are few and
  fixed;
- a ``features`` source (dict cocoid -> array, or an ``.npz`` path from
  ``cli.extract_features``) bypasses image IO entirely.

The loader is re-iterable: each ``iter()`` is a fresh epoch with a seeded
shuffle (the epoch number folds into the seed). Decoding is PIL's, or the
C++ batch decoder (``csrc/image_loader.cpp``, built by ``utils/native.py``)
when it builds on the host. PIL is imported inside the functions, so
importing this module needs no PIL.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from show_and_tell_tpu_torch.data.dataset import CocoCaptionDataset

log = logging.getLogger(__name__)

NATIVE_LIB = "libimage_loader.so"


def _load_image(src, size: int = 256) -> np.ndarray:
    """Path or raw encoded bytes -> [size, size, 3] uint8 RGB, resized by
    PIL's default filter when it is not already ``size`` square."""
    import io

    from PIL import Image

    fh = io.BytesIO(src) if isinstance(src, (bytes, bytearray)) else src
    img = Image.open(fh).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size))
    return np.asarray(img, dtype=np.uint8)


def _load_image_checked(src, size: int = 256):
    """``(image, ok)``: a corrupt, truncated, empty or unreadable source
    gives ``(zeros, False)`` and a warning instead of an exception, so one
    bad file does not fail a whole batch."""
    try:
        return _load_image(src, size), True
    except Exception as e:  # PIL raises OSError, SyntaxError, ValueError, ...
        desc = src if isinstance(src, str) else f"<{len(src)}-byte request>"
        log.warning("failed to decode image %s: %s", desc, e)
        return np.zeros((size, size, 3), dtype=np.uint8), False


# --- native batch decoder (csrc/image_loader.cpp via ctypes) ----------------
# C++ thread-pool JPEG/PNG decode + bilinear resize, GIL-free: decode
# throughput scales with host cores instead of Python threads. Built by
# utils/native.py into _build/native/, never loaded from csrc/.

_NATIVE_LIB = None


def _configure_native(lib) -> None:
    import ctypes

    lib.load_images_batch.restype = ctypes.c_int
    lib.load_images_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]


def _native_available() -> bool:
    global _NATIVE_LIB
    if _NATIVE_LIB is None:
        from show_and_tell_tpu_torch.utils.native import load_csrc_lib

        _NATIVE_LIB = load_csrc_lib(NATIVE_LIB, _configure_native)
    return _NATIVE_LIB is not None


def _native_load_batch(paths, size: int, n_threads: int):
    """Returns (images [N, size, size, 3] uint8, status [N] bool)."""
    import ctypes

    n = len(paths)
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    out = np.empty((n, size, size, 3), dtype=np.uint8)
    status = np.zeros((n,), dtype=np.uint8)
    _NATIVE_LIB.load_images_batch(
        blob,
        n,
        size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max(1, n_threads),
    )
    return out, status.astype(bool)


class Loader:
    def __init__(
        self,
        dataset: CocoCaptionDataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 2,
        prefetch_depth: int = 2,
        seed: int = 123,
        load_images: bool = True,
        features: Optional[Dict] = None,
        image_size: int = 256,
        drop_remainder: bool = False,
        native_decode: Optional[bool] = None,
        on_corrupt: str = "substitute",
        memmap_images=None,
    ):
        """``native_decode`` selects the C++ batch decoder
        (csrc/image_loader.cpp, a GIL-free thread pool over libjpeg and
        libpng). ``None`` = auto: use it when the library builds on this
        host (probed once, at the loader's first decode); ``True`` requires
        it and raises here without it; ``False`` forces PIL. On images
        already at ``image_size`` (cli.preprocess resizes them) both decode
        the same pixels.

        ``memmap_images`` is a :class:`~show_and_tell_tpu_torch.data.memmap.
        MemmapImages` instance or a shard-directory path (data/memmap.py):
        records whose ``file_path`` is in its index are served by
        decode-free memory-mapped gather; missing records are decoded,
        under the corrupt policy.

        ``on_corrupt`` is the per-item decode-failure policy:
        ``"substitute"`` (default) replaces a corrupt record's whole row
        (image + caption + meta) with a duplicate of a healthy in-batch
        record — the bad record is effectively skipped while every batch
        keeps its static shape — warns per file and counts in
        ``corrupt_skipped``; ``"raise"`` restores fail-fast."""
        if on_corrupt not in ("substitute", "raise"):
            raise ValueError(f"on_corrupt must be 'substitute' or 'raise', got {on_corrupt!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = max(1, prefetch_depth)
        self.seed = seed
        self.load_images = load_images
        if isinstance(features, str):  # .npz from cli/extract_features
            features = np.load(features)
        self.features = features
        # NpzFile lazily reads from one zip handle — not thread-safe under
        # the worker pool; serialise those lookups.
        self._features_lock = (
            threading.Lock() if isinstance(features, np.lib.npyio.NpzFile) else None
        )
        self.image_size = image_size
        self.drop_remainder = drop_remainder
        self.native_decode = native_decode
        # whether batches decode with the C++ library; None until the first
        # decode probes it
        self._use_native: Optional[bool] = None
        if native_decode:
            # fail at construction: raised per batch from a pool worker it
            # would surface mid-epoch from future.result()
            if not _native_available():
                raise RuntimeError(
                    f"native_decode=True but {NATIVE_LIB} cannot be built on this host "
                    "(g++, libjpeg and libpng); use native_decode=None for auto-fallback"
                )
            self._use_native = True
        elif native_decode is False:
            self._use_native = False
        if isinstance(memmap_images, str):
            from show_and_tell_tpu_torch.data.memmap import MemmapImages

            memmap_images = MemmapImages(memmap_images)
        if memmap_images is not None and memmap_images.size != image_size:
            raise ValueError(
                f"memmap shards hold {memmap_images.size}px images but the "
                f"loader wants {image_size}px — repack or drop memmap_images"
            )
        self.memmap_images = memmap_images
        self.on_corrupt = on_corrupt
        self.corrupt_skipped = 0  # decode failures substituted so far
        self._epoch = 0
        self._explicit_epoch: Optional[int] = None
        self._resume_skip = 0
        # The native decoder spawns its own C++ thread pool per call; with
        # num_workers _materialize calls in flight that would oversubscribe
        # the host num_workers^2-fold. Serialize native calls (each gets the
        # full thread budget); batch-level pipelining continues via the pool.
        self._native_decode_lock = threading.Lock()
        # corrupt_skipped is incremented from pool worker threads; +=
        # alone is a non-atomic read-modify-write that loses counts under
        # concurrency (review fix)
        self._stats_lock = threading.Lock()

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle seed to a logical epoch number so a resumed run
        reproduces the original epoch's batch order (the implicit per-process
        counter would restart at 0 after a crash)."""
        self._explicit_epoch = epoch

    def set_resume_skip(self, n: int) -> None:
        """Skip the first ``n`` batch plans of the NEXT epoch only — resume
        replay without paying decode for already-trained batches (the batch
        order past the skip is identical to the original epoch's)."""
        self._resume_skip = n

    def __len__(self) -> int:
        return self.dataset.num_batches(self.batch_size, self.drop_remainder)

    def _features_lookup(self, cocoid):
        src = self.features
        if self._features_lock is not None:
            with self._features_lock:
                key = str(cocoid) if str(cocoid) in src else cocoid
                return np.asarray(src[key])
        key = cocoid if cocoid in src else str(cocoid)  # npz keys are strings
        return np.asarray(src[key])

    def _materialize(self, plan: Dict) -> Dict:
        idx, pad_len = plan["indices"], plan["pad_len"]
        captions, lengths = self.dataset.encode_indices(idx, pad_len)
        meta = self.dataset.batch_meta(idx)
        batch = {
            "captions": captions,
            "lengths": lengths,
            "imgids": meta["imgids"],
            "cocoids": meta["cocoids"],
        }
        if self.features is not None:
            batch["features"] = np.stack(
                [self._features_lookup(c) for c in meta["cocoids"]]
            ).astype(np.float32)
        elif self.load_images:
            mm = self.memmap_images
            if mm is not None:
                paths = meta["paths"]
                hits = [p in mm for p in paths]
                if all(hits):
                    # decode-free fast path: memory-mapped gather (no codec)
                    batch["images"] = mm.get_batch(paths)
                    return batch
                # partial miss (only pack-time-undecodable files miss the
                # index): decode JUST the misses — the rest of the batch
                # stays on the decode-free budget (review fix: this used
                # to decode the whole batch and discard the hit rows)
                size = self.image_size
                images = np.empty((len(paths), size, size, 3), np.uint8)
                ok = np.ones(len(paths), dtype=bool)
                for i, (p, hit) in enumerate(zip(paths, hits)):
                    if hit:
                        images[i] = mm.get(p)
                    else:
                        images[i], ok[i] = _load_image_checked(p, size)
                batch["images"] = images
                if not ok.all():
                    self._apply_corrupt_policy(batch, ok, paths)
                return batch
            if self._use_native is None:
                self._use_native = _native_available()
            if self._use_native:
                with self._native_decode_lock:
                    images, ok = _native_load_batch(
                        meta["paths"], self.image_size, self.num_workers
                    )
                for i in np.nonzero(~ok)[0]:  # PIL fallback per failure
                    images[i], ok[i] = _load_image_checked(
                        meta["paths"][i], self.image_size
                    )
            else:
                loaded = [
                    _load_image_checked(p, self.image_size) for p in meta["paths"]
                ]
                images = np.stack([im for im, _ in loaded])
                ok = np.array([o for _, o in loaded], dtype=bool)
            batch["images"] = images
            if not ok.all():
                self._apply_corrupt_policy(batch, ok, meta["paths"])
        return batch

    def _apply_corrupt_policy(self, batch: Dict, ok: np.ndarray, paths) -> None:
        bad = np.nonzero(~ok)[0]
        if self.on_corrupt == "raise":
            raise RuntimeError(
                f"failed to decode {len(bad)} image(s): "
                f"{[paths[i] for i in bad[:5]]}" + ("…" if len(bad) > 5 else "")
            )
        good = np.nonzero(ok)[0]
        if good.size == 0:
            # nothing healthy to substitute — an all-corrupt batch is a
            # data catastrophe, not a per-item hiccup
            raise RuntimeError(
                f"every image in a batch of {len(ok)} failed to decode "
                f"(first: {paths[0]}); refusing to train on all-zero images"
            )
        for j, i in enumerate(bad):
            src = good[j % good.size]
            for key in ("images", "captions", "lengths", "imgids", "cocoids"):
                batch[key][i] = batch[key][src]  # arrays and meta lists alike
            log.warning(
                "corrupt image skipped (record substituted in-batch): %s", paths[i]
            )
        with self._stats_lock:
            self.corrupt_skipped += len(bad)

    def __iter__(self) -> Iterator[Dict]:
        epoch = (
            self._explicit_epoch if self._explicit_epoch is not None else self._epoch
        )
        rng = np.random.default_rng(self.seed + epoch)
        self._epoch += 1
        plans = list(
            self.dataset.iter_index_batches(
                self.batch_size, self.shuffle, rng, self.drop_remainder
            )
        )
        if self._resume_skip:
            plans = plans[self._resume_skip:]
            self._resume_skip = 0
        if not plans:
            return
        # Bounded prefetch: at most prefetch_depth + num_workers batches are
        # materialized-or-in-flight at once. The semaphore is the backpressure
        # — a slot frees only when the consumer takes a batch — so a slow
        # consumer can never cause the whole epoch's decoded images to pile
        # up in memory, and abandoning the iterator cancels unstarted work.
        max_inflight = self.prefetch_depth + self.num_workers
        sem = threading.Semaphore(max_inflight)
        q: "queue.Queue" = queue.Queue()
        stop = threading.Event()

        def producer():
            pool = ThreadPoolExecutor(self.num_workers)
            try:
                for p in plans:
                    while not sem.acquire(timeout=0.1):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        return
                    q.put(pool.submit(self._materialize, p))
            finally:
                # on abandonment, drop work the pool hasn't started; on
                # normal completion, let the queued tail drain
                pool.shutdown(wait=False, cancel_futures=stop.is_set())
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                batch = item.result()
                sem.release()
                yield batch
        finally:
            stop.set()


def make_loader(
    cfg,
    dataset: CocoCaptionDataset,
    mode: str = "train",
    features: Optional[Dict] = None,
    load_images: bool = True,
) -> Loader:
    """Loader factory mirroring the reference's ``get_loader`` surface
    (data_loader.py:64-77): batch size, workers and shuffle from the config;
    features from ``cfg.features_path``, else images from the memmap shards
    of ``cfg.memmap_dir`` when their index exists, else decoded."""
    if features is None and cfg.features_path:
        features = cfg.features_path  # .npz from cli/extract_features
    memmap_images = None
    mm_dir = cfg.memmap_dir
    if mm_dir and os.path.exists(os.path.join(mm_dir, "index.json")):
        memmap_images = mm_dir  # decode-free shards (data/memmap.py)
    return Loader(
        dataset,
        batch_size=cfg.batch_size,
        shuffle=(mode == "train"),
        num_workers=cfg.num_workers,
        prefetch_depth=cfg.prefetch_depth,
        seed=cfg.random_seed,
        load_images=load_images and features is None,
        features=features,
        drop_remainder=(mode == "train"),
        native_decode=cfg.native_decode,
        on_corrupt=cfg.on_corrupt,
        memmap_images=memmap_images,
    )
