"""Serving front door: uint8 images in, caption strings out.

    captioner = Captioner.from_checkpoint(cfg, "experiment/u/e", vocab)   # on the GPU
    captions = captioner.caption_images(images_u8, mode="beam")
    captions = captioner.caption_paths(["img1.jpg", "img2.jpg"])

Requests are cut into chunks of the bucket sizes, and a short last chunk is
padded to its bucket by repeating its last image, so every batch has one of
a few shapes. Center crop, normalisation, the VGG16 trunk and the decode all
run on the device. Every entry point holds one re-entrant lock, so threads
may share a Captioner.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data.transforms import eval_transform
from show_and_tell_tpu_torch.decode.beam import beam_search
from show_and_tell_tpu_torch.decode.dispatch import decode_ids
from show_and_tell_tpu_torch.models.registry import build_model
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
    ):
        """``params``: a state dict for ``model`` (e.g. from
        ``ckpt.convert.from_jax_params``), or None to serve the model's own
        weights. The model is moved to ``device``."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device)
        if params is not None:
            self.model.load_state_dict(params)
        self.vocab = vocab
        self.bucket_sizes = sorted(bucket_sizes or DEFAULT_BUCKETS)
        # sampling knobs (mode="sample")
        self.temperature = 1.0
        self.top_k = 0
        self.top_p = 1.0  # nucleus mass; 1.0 = off
        self._keys = KeyChain(cfg.random_seed)
        self._sample_count = 0  # images sampled so far: the streams' counter
        # caption_paths calls caption_images under the same lock
        self._lock = threading.RLock()
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
        - ``cfg.encoder_weights``, a torchvision VGG16 state dict, sets the
          frozen trunk;
        - ``cfg.torch_checkpoint``, a reference-format ``model-best.pth``,
          sets the decoder (and the trunk, if it holds one) and takes the
          place of ``expr_dir``;
        - else ``expr_dir``'s ``model-best.pt``, or the JAX package's
          ``model-best.msgpack``, sets the trainable params; a directory
          with neither raises ``FileNotFoundError``; None serves the random
          decoder.

        Checkpoints hold no trunk, so a decoder over a random trunk is
        warned about."""
        if cfg.quantize_backbone:
            raise NotImplementedError(
                "quantize_backbone: the int8 trunk is not ported to PyTorch yet; see ROADMAP.md A8"
            )
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
            assert set(model.state_dict()) - set(trainable) == trunk, "a checkpoint holds all but the trunk"
            if ckpt.load_best_params(expr_dir, trainable) is None:
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
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        return self.model.backbone_features(eval_transform(x, self.cfg.crop_size))

    @torch.inference_mode()
    def _ids(self, images_u8: np.ndarray, mode: str, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return decode_ids(
            self.model, self.cfg, self._features(images_u8), mode, generator=generator,
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
        )

    @staticmethod
    def _to_host(ids: torch.Tensor):
        """Start the copy of ``ids`` into pinned host memory behind the work
        that makes them; returns (host tensor, event to wait on)."""
        if not ids.is_cuda:
            return ids, None
        host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
        host.copy_(ids, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _decode_pending(self, pending) -> List[str]:
        host, done, live = pending
        if done is not None:
            done.synchronize()
        # cut to the live rows before the string decode
        return self.vocab.decode_batch(host.numpy()[:live])

    # ------------------------------------------------------------------

    def warmup(self, modes: Sequence[str] = ("beam",), buckets: Optional[Sequence[int]] = None) -> float:
        """Run one dummy batch per (bucket, mode), so that the first request
        pays no kernel build or cuDNN algorithm search. ``modes`` takes the
        decode modes ("beam", "greedy", "sample") and the interactive
        surfaces "nbest" and "attention". Sampling on the dummies does not
        move the streams' counter. Returns seconds spent."""
        t0 = time.perf_counter()
        buckets = sorted(set(buckets)) if buckets else list(self.bucket_sizes)
        with self._lock:
            dummy = np.zeros((buckets[-1], 256, 256, 3), np.uint8)
            count_before = self._sample_count
            try:
                for mode in modes:
                    for b in buckets:
                        if mode == "nbest":
                            self.caption_nbest(dummy[:b])
                        elif mode == "attention":
                            self.caption_with_attention(dummy[:b])
                        else:
                            self.caption_images(dummy[:b], mode=mode)
            finally:
                self._sample_count = count_before
        return time.perf_counter() - t0

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
        rebuilt the Captioner and continues a sequence.

        Chunk i is dispatched before chunk i-1's ids are read back and turned
        into strings, so that the host's work overlaps the device's."""
        with self._lock:
            n = images_u8.shape[0]
            base = self._sample_count
            if mode == "sample":
                self._sample_count += n
            out: List[str] = []
            pending = None
            for i, chunk, live in self._chunks(images_u8):
                gen = None
                if mode == "sample":
                    gen = self._keys.generator("sample", base + rng_offset + i, device=self.device)
                host, done = self._to_host(self._ids(chunk, mode, gen))
                if pending is not None:
                    out.extend(self._decode_pending(pending))
                pending = (host, done, live)
            if pending is not None:
                out.extend(self._decode_pending(pending))
            return out

    def caption_nbest(self, images_u8: np.ndarray) -> List[List[Tuple[str, float]]]:
        """Per image, the ``beam_size`` (caption, score) pairs of the beam,
        best first; the score is the length-normalised log-probability that
        ranks the beams."""
        with self._lock:
            model, cfg = self.model, self.cfg
            out: List[List[Tuple[str, float]]] = []
            for _, chunk, live in self._chunks(images_u8):
                with torch.inference_mode():
                    feats = self._features(chunk)
                    step_fn, carry, first, tile = model.decode_state(feats, beam_size=cfg.beam_size)
                    ids, scores = beam_search(
                        step_fn, carry, feats.shape[0], beam_size=cfg.beam_size,
                        max_len=cfg.max_decode_len, length_penalty=cfg.length_penalty,
                        first_logits=first, tile=tile, return_all=True,
                    )
                ids = ids[:live].cpu().numpy()  # [live, k, T]
                scores = scores[:live].float().cpu().numpy()  # [live, k]
                for r in range(live):
                    caps = self.vocab.decode_batch(ids[r])
                    out.append([(c, float(s)) for c, s in zip(caps, scores[r])])
            return out

    def caption_with_attention(self, images_u8: np.ndarray) -> Tuple[List[str], np.ndarray]:
        """Greedy captions and each step's attention map: images_u8
        [N, H, W, 3] -> (captions, alphas [N, T, L] fp32) with T =
        ``max_decode_len`` and L the patch grid (196 at 224 px). Raises
        ``ValueError`` for a model without attention."""
        with self._lock:
            model, cfg = self.model, self.cfg
            if not hasattr(model, "greedy_with_attention"):
                raise ValueError(f"model {cfg.model!r} exposes no attention maps (only show_attend_tell does)")
            if images_u8.shape[0] == 0:
                grid = (cfg.crop_size // 16) ** 2  # VGG conv5's stride-16 grid
                return [], np.zeros((0, cfg.max_decode_len, grid), np.float32)
            caps: List[str] = []
            alphas: List[np.ndarray] = []
            for _, chunk, live in self._chunks(images_u8):
                with torch.inference_mode():
                    ids, alpha = model.greedy_with_attention(self._features(chunk), max_len=cfg.max_decode_len)
                caps.extend(self.vocab.decode_batch(ids[:live].cpu().numpy()))
                alphas.append(alpha[:live].float().cpu().numpy())
            return caps, np.concatenate(alphas, axis=0)

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
