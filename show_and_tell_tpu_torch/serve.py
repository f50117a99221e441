"""Serving front door: uint8 images in, caption strings out.

    captioner = Captioner.from_checkpoint(cfg, "experiment/u/e", vocab)   # on the GPU
    captions = captioner.caption_images(images_u8, mode="beam")
    captions = captioner.caption_paths(["img1.jpg", "img2.jpg"])
    batcher = DynamicBatcher(captioner)                      # one worker thread
    caption = batcher.caption(image_u8, mode="greedy")       # from any thread

Requests are cut into chunks of the bucket sizes, and a short last chunk is
padded to its bucket by repeating its last image, so every batch has one of
a few shapes. Center crop, normalisation, the trunk and the decode all run
on the device. Every surface (captions, n-best lists, attention maps) runs
one chunk loop, ``Captioner._serve``: it decodes chunk i through
``decode.dispatch`` (or the model's attention decode) before it reads chunk
i-1 back. Every entry point holds one re-entrant lock, so threads may share
a Captioner. The ``DynamicBatcher`` coalesces single-image requests from
many threads into bucketed batches on one worker thread.

Over a mesh (``Captioner(..., mesh=make_mesh(...))``, one process per
device) every rank is given the same images, decodes its data index's rows
of each chunk, and returns the whole result, gathered over the data group.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data.transforms import eval_transform
from show_and_tell_tpu_torch.decode.dispatch import decode_ids, decode_nbest
from show_and_tell_tpu_torch.models import quantize
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.obs.profiler import span
from show_and_tell_tpu_torch.parallel import collectives
from show_and_tell_tpu_torch.parallel import mesh as mesh_lib
from show_and_tell_tpu_torch.utils.device import resolve_device
from show_and_tell_tpu_torch.utils.rng import KeyChain
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

log = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 8, 32, 128, 256)

#: the caption of a path whose image could not be decoded (see
#: ``Captioner.caption_paths``); never a real caption, whose words are
#: lowercase vocabulary words
ERROR_CAPTION = "<error: image failed to decode>"


class Captioner:
    def __init__(
        self,
        cfg: Config,
        model,
        params: Optional[Dict[str, torch.Tensor]],
        vocab: Vocabulary,
        device: Union[str, torch.device] = "cuda",
        bucket_sizes: Optional[Sequence[int]] = None,
        mesh: Optional[mesh_lib.Mesh] = None,
    ):
        """``params``: a state dict for ``model`` (e.g. from
        ``ckpt.convert.from_jax_params``), or None to serve the model's own
        weights. The model is moved to ``device``.

        ``mesh``: serving over a mesh of processes (the JAX Captioner's
        ``mesh``), each rank this device's: the trainable weights and
        statistics become rank 0's, each request chunk is split over the
        ``data`` axis, and every rank returns the whole result. Explicit
        ``bucket_sizes`` must be divisible by the data axis; the default
        buckets are rounded up to multiples of it."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device)
        if params is not None:
            self.model.load_state_dict(params)
        self.vocab = vocab
        self.bucket_sizes = sorted(bucket_sizes or DEFAULT_BUCKETS)
        self.mesh = mesh
        if mesh is not None:
            bad = [b for b in self.bucket_sizes if b % mesh.data]
            if bad and bucket_sizes is not None:
                raise ValueError(f"bucket sizes {bad} not divisible by the mesh data axis ({mesh.data})")
            self.bucket_sizes = sorted({-(-b // mesh.data) * mesh.data for b in self.bucket_sizes})
            mesh_lib.replicate(mesh, {**ckpt.trainable_state_dict(self.model), **(self.model.batch_stats or {})})
        # sampling knobs (mode="sample")
        self.temperature = 1.0
        self.top_k = 0
        self.top_p = 1.0  # nucleus mass; 1.0 = off
        self._keys = KeyChain(cfg.random_seed)
        self._sample_count = 0  # images sampled so far: the streams' counter
        # caption_paths calls caption_images under the same lock
        self._lock = threading.RLock()
        # set while warmup's dummies run, so that they never calibrate the
        # int8 trunk
        self._quant_deferred = False
        #: (index, path) of the images that the last caption_paths call could
        #: not decode (their captions are ERROR_CAPTION)
        self.last_errors: List[Tuple[int, str]] = []

    @classmethod
    def from_checkpoint(
        cls,
        cfg: Config,
        expr_dir: Optional[str],
        vocab: Vocabulary,
        device: Union[str, torch.device] = "cuda",
        **kw,
    ) -> "Captioner":
        """A Captioner over trained weights:

        - the model starts from the ``"init"`` stream of ``KeyChain(seed)``;
        - ``cfg.encoder_weights``, a torchvision state dict of the model's
          trunk, sets the frozen trunk;
        - ``cfg.torch_checkpoint``, a reference-format ``model-best.pth``,
          sets the decoder (and the trunk, if it holds one; and for
          Show-and-Tell the BatchNorm's statistics, if it holds the
          encoder's keys) and takes the place of ``expr_dir``;
        - else ``expr_dir``'s ``model-best.pt``, or the JAX package's
          ``model-best.msgpack``, sets the trainable params and the batch
          statistics; a directory with neither raises
          ``FileNotFoundError``; None serves the random decoder.

        Checkpoints hold no trunk, so a decoder over a random trunk is
        warned about."""
        model = build_model(cfg, len(vocab), device=device, generator=KeyChain(cfg.random_seed).generator("init"))
        if cfg.encoder_weights:
            from show_and_tell_tpu_torch.ckpt.torch_import import load_encoder_weights

            load_encoder_weights(cfg, model)
        if cfg.torch_checkpoint:
            from show_and_tell_tpu_torch.ckpt.torch_import import apply_reference_checkpoint

            has_encoder = apply_reference_checkpoint(cfg, model)
            if not has_encoder and not cfg.encoder_weights:
                log.warning(
                    "%s contains no encoder weights and encoder_weights is unset: the frozen "
                    "encoder is randomly initialized and the captions will be garbage. Pass the "
                    "encoder weights the checkpoint was trained with.",
                    cfg.torch_checkpoint,
                )
            return cls(cfg, model, None, vocab, device=device, **kw)
        if expr_dir:
            if not cfg.encoder_weights:
                log.warning(
                    "restoring %s without encoder_weights: the frozen encoder is randomly "
                    "initialized (checkpoints do not store it); pass the encoder weights used "
                    "in training",
                    expr_dir,
                )
            trainable = ckpt.trainable_state_dict(model)
            trunk = {n for n, _ in model.named_parameters() if n.startswith("encoder.")}
            buffers = {n for n, _ in model.named_buffers()}
            assert set(model.state_dict()) - set(trainable) - buffers == trunk, \
                "a checkpoint holds all but the trunk"
            if ckpt.load_best_params(expr_dir, trainable, model.batch_stats) is None:
                raise FileNotFoundError(
                    f"no model-best checkpoint found under {expr_dir!r}: train first, or pass "
                    "expr_dir=None for an untrained Captioner"
                )
        return cls(cfg, model, None, vocab, device=device, **kw)

    # ------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.bucket_sizes:
            if n <= b:
                return b
        return self.bucket_sizes[-1]

    def _chunks(self, images_u8: np.ndarray):
        """(start, chunk padded to its bucket, live rows) over the request."""
        n = images_u8.shape[0]
        i = 0
        while i < n:
            b = self._bucket(n - i)
            chunk = images_u8[i : i + b]
            live = chunk.shape[0]
            if live < b:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], b - live, axis=0)], axis=0)
            yield i, chunk, live
            i += b

    def _features(self, chunk: np.ndarray) -> torch.Tensor:
        """The trunk's features of this rank's rows of a bucket chunk (all of
        them without a mesh)."""
        with span("trunk"):
            chunk = chunk[mesh_lib.batch_rows(self.mesh, chunk.shape[0])]
            with span("trunk.copy"):
                x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            with span("trunk.transform"):
                x = eval_transform(x, self.cfg.crop_size)
            with span("trunk.backbone"):
                return self.model.backbone_features(x)

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """A chunk's result from this rank's rows: every rank's, in order."""
        if self.mesh is None or not self.mesh.distributed:
            return t
        return collectives.all_gather(t, self.mesh.data_group, self.mesh.data_index, self.mesh.data)

    def _decode_pending(self, pending) -> list:
        host, done, live, read = pending
        with span("strings"):
            with span("strings.wait"):
                if done is not None:
                    done.synchronize()
            return read(*(h.numpy()[:live] for h in host))

    def _serve(self, images_u8: np.ndarray, decode: Callable, read: Callable) -> list:
        """The chunk loop of every surface: ``decode(features, start)`` maps
        the chunk at image ``start`` to device tensors, copied back behind
        the work that makes them, and ``read(*arrays)`` their live rows to
        one answer per image. Chunk i is dispatched before chunk i-1 is read
        back, so that the host's work overlaps the device's."""
        with self._lock, span("serve.call"):
            self._ensure_quantized(images_u8)
            out: list = []
            pending = None
            for i, chunk, live in self._chunks(images_u8):
                with span("serve.chunk"):
                    with torch.inference_mode():
                        host = tuple(self._gathered(t) for t in decode(self._features(chunk), i))
                    done = None
                    if host[0].is_cuda:
                        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                                     for t in host)
                        done = torch.cuda.Event()
                        done.record()
                    if pending is not None:
                        out.extend(self._decode_pending(pending))
                pending = (host, done, live, read)
            if pending is not None:
                out.extend(self._decode_pending(pending))
            return out

    # ------------------------------------------------------------------

    def warmup(
        self,
        modes: Sequence[str] = ("beam",),
        buckets: Optional[Sequence[int]] = None,
        calib_images: Optional[np.ndarray] = None,
    ) -> float:
        """Run one dummy batch per (bucket, mode), so that the first request
        pays no kernel build or cuDNN algorithm search. ``modes`` takes the
        decode modes ("beam", "greedy", "sample") and the interactive
        surfaces "nbest" and "attention"; a model without attention maps
        skips "attention". Sampling on the dummies does not move the streams'
        counter. Returns seconds spent.

        With ``cfg.quantize_backbone`` the int8 trunk is calibrated on real
        images only, never on the zero dummies: on ``calib_images``
        ([N, H, W, 3] uint8, a sample of the traffic), or loaded from
        ``cfg.quantized_backbone_path`` when that file exists. Without either,
        warmup warns, warms the float trunk, and leaves the calibration to
        the first real batch."""
        t0 = time.perf_counter()
        buckets = sorted(set(buckets)) if buckets else list(self.bucket_sizes)
        with self._lock:
            if quantize.needs_calibration(self.model, self.cfg):
                path = self.cfg.quantized_backbone_path
                if calib_images is not None:
                    self._ensure_quantized(calib_images)
                elif not (path and os.path.exists(path)):
                    log.warning(
                        "warmup without calib_images and no calibration at quantized_backbone_path: the "
                        "int8 calibration waits for the first real batch; pass calib_images (a sample of "
                        "real traffic) to do it here. Warming the float trunk only."
                    )
                    self._quant_deferred = True
            dummy = np.zeros((buckets[-1], 256, 256, 3), np.uint8)
            count_before = self._sample_count
            try:
                for mode in modes:
                    if mode == "attention" and not hasattr(self.model, "greedy_with_attention"):
                        continue
                    for b in buckets:
                        if mode == "nbest":
                            self.caption_nbest(dummy[:b])
                        elif mode == "attention":
                            self.caption_with_attention(dummy[:b])
                        else:
                            self.caption_images(dummy[:b], mode=mode)
            finally:
                self._quant_deferred = False
                self._sample_count = count_before
        return time.perf_counter() - t0

    def _ensure_quantized(self, images_u8: np.ndarray) -> None:
        """Calibrate the int8 trunk on the first ``min(32, N)`` of these
        images through the eval transform (or load the tree at
        ``cfg.quantized_backbone_path``), once; from then on the model's
        ``backbone_features`` runs it. The chunk loop of every serving surface
        calls this first; during warmup's dummies it does nothing."""
        if self._quant_deferred or not quantize.needs_calibration(self.model, self.cfg) or images_u8.shape[0] == 0:
            return
        x = torch.from_numpy(np.ascontiguousarray(images_u8[:32])).to(self.device)
        quantize.calibrate_model(self.model, self.cfg, x)

    def caption_images(self, images_u8: np.ndarray, mode: str = "beam", rng_offset: int = 0) -> List[str]:
        """images_u8 [N, H, W, 3] uint8 -> N captions; ``mode`` is "beam"
        (beam width ``cfg.beam_size``), "greedy" or "sample" (the
        ``temperature``, ``top_k`` and ``top_p`` attributes).

        Sampling draws each chunk from its own generator,
        ``KeyChain(seed).generator("sample", count + rng_offset + start)``,
        ``count`` being the images sampled before this call and ``start`` the
        chunk's offset in it; rows of a chunk draw independent noise. The
        counter advances per sampled image, so repeated requests differ,
        while a fresh Captioner with the same seed replays them (exactly when
        the chunk boundaries match too). ``rng_offset`` is for a caller that
        rebuilt the Captioner and continues a sequence."""
        with self._lock:
            base = self._sample_count
            if mode == "sample":
                self._sample_count += images_u8.shape[0]

            def decode(features, start):
                gen = None
                if mode == "sample":
                    gen = self._keys.generator("sample", base + rng_offset + start, device=self.device)
                return (decode_ids(self.model, self.cfg, features, mode, generator=gen, temperature=self.temperature,
                                   top_k=self.top_k, top_p=self.top_p, mesh=self.mesh),)

            return self._serve(images_u8, decode, self.vocab.decode_batch)

    def caption_nbest(self, images_u8: np.ndarray) -> List[List[Tuple[str, float]]]:
        """Per image, the ``beam_size`` (caption, score) pairs of the beam,
        best first; the score is the length-normalised log-probability that
        ranks the beams."""

        def read(ids, scores):  # [live, k, T], [live, k]
            return [list(zip(self.vocab.decode_batch(i), map(float, s))) for i, s in zip(ids, scores)]

        return self._serve(images_u8, lambda features, _: decode_nbest(self.model, self.cfg, features), read)

    def caption_with_attention(self, images_u8: np.ndarray) -> Tuple[List[str], np.ndarray]:
        """Greedy captions and each step's attention map: images_u8
        [N, H, W, 3] -> (captions, alphas [N, T, L] fp32) with T =
        ``max_decode_len`` and L the patch grid (196 at 224 px). Raises
        ``ValueError`` for a model without attention."""

        def decode(features, _):
            with span("decode"):
                ids, alphas = self.model.greedy_with_attention(features, max_len=self.cfg.max_decode_len)
            return ids, alphas.float()

        with self._lock:
            model, cfg = self.model, self.cfg
            if not hasattr(model, "greedy_with_attention"):
                raise ValueError(f"model {cfg.model!r} exposes no attention maps (only show_attend_tell does)")
            if images_u8.shape[0] == 0:
                grid = (cfg.crop_size // 16) ** 2  # VGG conv5's stride-16 grid
                return [], np.zeros((0, cfg.max_decode_len, grid), np.float32)
            rows = self._serve(images_u8, decode, lambda ids, alphas: list(zip(self.vocab.decode_batch(ids), alphas)))
            return [c for c, _ in rows], np.stack([a for _, a in rows])

    def caption_paths(self, paths: Sequence[str], mode: str = "beam") -> List[str]:
        """Caption image files, read by PIL and resized to 256 x 256. A file
        that cannot be decoded does not fail the call: its slot is captioned
        from zeros, its caption is ``ERROR_CAPTION``, and ``(index, path)``
        goes into ``last_errors`` (reset per call). Files are read one
        largest bucket at a time; sampling continues the counter across
        those chunks, so the result is that of one call over all images."""
        from show_and_tell_tpu_torch.data.pipeline import _load_image_checked

        with self._lock:
            chunk = max(self.bucket_sizes)
            out: List[str] = []
            self.last_errors = []
            for i in range(0, len(paths), chunk):
                loaded = [_load_image_checked(p) for p in paths[i : i + chunk]]
                caps = self.caption_images(np.stack([im for im, _ in loaded]), mode)
                for j, (_, ok) in enumerate(loaded):
                    if not ok:
                        caps[j] = ERROR_CAPTION
                        self.last_errors.append((i + j, paths[i + j]))
                out.extend(caps)
            return out


# ----------------------------------------------------------------------
# Dynamic batching: many single-image requests, one device batch. Requests
# queue; one worker thread drains up to ``max_batch`` same-mode requests
# (waiting at most ``max_delay_ms`` after the first) and serves them with one
# bucketed ``caption_images`` call. That worker is the only thread of the
# batcher that issues device work.


class QueueFull(RuntimeError):
    """The DynamicBatcher's queue holds ``max_queue`` requests: shed load
    (HTTP 429)."""


class _Ticket:
    """One request in flight; the worker fills in its caption or error."""

    __slots__ = ("image", "mode", "event", "caption", "error", "t_submit", "abandoned")

    def __init__(self, image, mode: str):
        self.image = image
        self.mode = mode
        self.event = threading.Event()
        self.caption: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.abandoned = False  # the client's result() timed out

    def result(self, timeout: Optional[float] = None) -> str:
        if not self.event.wait(timeout):
            # the worker skips an abandoned ticket instead of spending a
            # device slot on a caption nobody reads
            self.abandoned = True
            raise TimeoutError("caption request timed out")
        if self.error is not None:
            raise RuntimeError(f"caption request failed: {self.error}") from self.error
        return self.caption


class DynamicBatcher:
    """Thread-safe request coalescer over a :class:`Captioner`.

    - ``submit(image_u8, mode)`` returns a ticket at once; ``caption(...)``
      is submit and wait.
    - Batches are FIFO runs of same-mode requests: the worker pops the head,
      then appends queued requests of its mode until ``max_batch`` or
      ``max_delay_ms`` after the pop; a request of another mode at the head
      closes the batch and leads the next one.
    - Past ``max_queue`` queued requests (default 8 x ``max_batch``),
      ``submit`` raises ``QueueFull``.
    - ``stats()`` reports requests, batches, mean batch size, the mean queue
      wait per request, errors, rejected and abandoned requests, requests
      per mode, and p50/p95/p99 of submit-to-caption latency over the last
      2,048 served requests.
    - ``close()`` stops the worker; pending tickets fail.
    """

    def __init__(
        self,
        captioner: Captioner,
        max_batch: Optional[int] = None,
        max_delay_ms: float = 10.0,
        autostart: bool = True,
        max_queue: Optional[int] = None,
    ):
        self.captioner = captioner
        self.max_batch = max_batch or max(captioner.bucket_sizes)
        self.max_delay_s = max_delay_ms / 1e3
        # requests queued past this depth would reach the device long after
        # their clients have timed out
        self.max_queue = self.max_batch * 8 if max_queue is None else max_queue
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._running = False
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        self._stats = {
            "requests": 0, "batches": 0, "batch_size_sum": 0,
            "queue_wait_s_sum": 0.0, "errors": 0, "rejected": 0, "abandoned": 0,
        }
        # submit-to-caption seconds of the most recent served requests
        self._latencies: deque = deque(maxlen=2048)
        self._mode_counts = {"beam": 0, "greedy": 0, "sample": 0}
        if autostart:
            self.start()

    def start(self) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._running:
                return
            self._running = True
        self._worker = threading.Thread(target=self._run, name="caption-batcher", daemon=True)
        self._worker.start()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker; pending tickets fail with a closed error."""
        with self._cv:
            self._running = False
            self._closed = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
        with self._cv:
            while self._q:
                t = self._q.popleft()
                t.error = RuntimeError("batcher closed")
                t.event.set()

    def _fail_abandoned(self, tickets) -> None:
        """Count the abandoned tickets and fail them, so that a retried
        ``result()`` raises instead of returning None. Holds ``_cv``."""
        self._stats["abandoned"] += len(tickets)
        for t in tickets:
            t.error = TimeoutError("abandoned: client result() timed out before dispatch")
            t.event.set()

    def submit(self, image_u8, mode: str = "beam") -> _Ticket:
        if mode not in ("beam", "greedy", "sample"):
            raise ValueError(f"unknown mode {mode!r}")
        # tickets are stacked into one batch: a malformed image accepted here
        # would fail every request coalesced with it. Shapes need only match
        # the queued requests (the queue's tail), so a lone odd-shaped
        # request still reaches the model and fails alone.
        image_u8 = np.asarray(image_u8)
        if image_u8.ndim != 3 or image_u8.shape[-1] != 3 or image_u8.dtype != np.uint8:
            raise ValueError(
                f"submit() expects one [H, W, 3] uint8 image, got shape {image_u8.shape} dtype {image_u8.dtype}"
            )
        ticket = _Ticket(image_u8, mode)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._q) >= self.max_queue:
                # abandoned tickets cost no device work: purge them before
                # shedding load
                dead = [t for t in self._q if t.abandoned]
                if dead:
                    self._fail_abandoned(dead)
                    self._q = deque(t for t in self._q if not t.abandoned)
            if len(self._q) >= self.max_queue:
                self._stats["rejected"] += 1
                raise QueueFull(f"caption queue full ({self.max_queue} pending)")
            if self._q and self._q[-1].image.shape != image_u8.shape:
                raise ValueError(
                    f"submit() image shape {image_u8.shape} does not match the queued requests' "
                    f"{self._q[-1].image.shape} — mixed shapes cannot be coalesced into one batch"
                )
            self._q.append(ticket)
            self._stats["requests"] += 1
            self._mode_counts[mode] += 1
            self._cv.notify()
        return ticket

    def caption(self, image_u8, mode: str = "beam", timeout: Optional[float] = 120.0) -> str:
        return self.submit(image_u8, mode).result(timeout)

    def stats(self) -> dict:
        with self._cv:
            s = dict(self._stats)
            s["requests_by_mode"] = dict(self._mode_counts)
            window = list(self._latencies)
        s["mean_batch_size"] = round(s["batch_size_sum"] / max(s["batches"], 1), 2)
        # per request: the wait sum is accumulated per dispatched ticket
        s["mean_queue_wait_ms"] = round(s["queue_wait_s_sum"] / max(s["batch_size_sum"], 1) * 1e3, 2)
        s["latency_ms"] = self._percentiles(window)
        return s

    @staticmethod
    def _percentiles(window) -> dict:
        if not window:
            return {"n": 0, "p50": None, "p95": None, "p99": None}
        q = np.percentile(np.asarray(window, np.float64), [50, 95, 99])
        return {"n": len(window), "p50": round(float(q[0]) * 1e3, 2), "p95": round(float(q[1]) * 1e3, 2),
                "p99": round(float(q[2]) * 1e3, 2)}

    # -- worker ---------------------------------------------------------

    def _pop_live(self, mode: Optional[str] = None) -> Optional[_Ticket]:
        """The first live ticket of the queue, failing the abandoned ones
        before it. With ``mode`` set, a live ticket of another mode stays
        at the head and None is returned: the mode is checked after the
        abandoned ones are skipped, so a skip never pulls a ticket of
        another mode into the batch. Holds ``_cv``."""
        while self._q:
            t = self._q.popleft()
            if t.abandoned:
                self._fail_abandoned([t])
                continue
            if mode is not None and t.mode != mode:
                self._q.appendleft(t)
                return None
            return t
        return None

    def _collect(self) -> List[_Ticket]:
        """Block for the first request, then gather its same-mode run."""
        with self._cv:
            batch: List[_Ticket] = []
            while self._running and not batch:
                head = self._pop_live()
                if head is not None:
                    batch.append(head)
                    break
                if not self._q:
                    self._cv.wait()
            if not self._running:
                return []
            deadline = time.perf_counter() + self.max_delay_s
            while len(batch) < self.max_batch and self._running:
                if self._q:
                    t = self._pop_live(batch[0].mode)
                    if t is not None:
                        batch.append(t)
                        continue
                    if self._q:
                        break  # a live head of another mode: the next round
                    continue  # drained abandoned tickets: check again, or wait
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or not self._cv.wait(remaining):
                    break
            return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                return  # closed
            live = [t for t in batch if not t.abandoned]
            if len(live) < len(batch):  # abandoned while the batch formed
                with self._cv:
                    self._fail_abandoned([t for t in batch if t.abandoned])
                if not live:
                    continue
                batch = live
            t_dispatch = time.perf_counter()
            try:
                caps = self.captioner.caption_images(np.stack([t.image for t in batch]), mode=batch[0].mode)
                for t, c in zip(batch, caps):
                    t.caption = c
            except Exception as e:  # one bad batch must not kill the worker
                log.exception("batcher dispatch failed (%d requests)", len(batch))
                for t in batch:
                    t.error = e
                with self._cv:
                    self._stats["errors"] += len(batch)
            finally:
                t_done = time.perf_counter()
                with self._cv:
                    self._stats["batches"] += 1
                    self._stats["batch_size_sum"] += len(batch)
                    self._stats["queue_wait_s_sum"] += sum(t_dispatch - t.t_submit for t in batch)
                    for t in batch:
                        if t.error is None:
                            self._latencies.append(t_done - t.t_submit)
                for t in batch:
                    t.event.set()
