"""Serving front door: uint8 images in, caption strings out.

    model = build_model(cfg, len(vocab))                 # on the GPU
    captioner = Captioner(cfg, model, state_dict, vocab)
    captions = captioner.caption_images(images_u8, mode="beam")

Requests are cut into chunks of the bucket sizes, and a short last chunk is
padded to its bucket by repeating its last image, so every batch has one of
a few shapes. Center crop, normalisation, the VGG16 trunk and the decode all
run on the device.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data.transforms import eval_transform
from show_and_tell_tpu_torch.decode.dispatch import decode_ids
from show_and_tell_tpu_torch.utils.device import resolve_device
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

DEFAULT_BUCKETS = (1, 8, 32, 128, 256)


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

    def _bucket(self, n: int) -> int:
        for b in self.bucket_sizes:
            if n <= b:
                return b
        return self.bucket_sizes[-1]

    @torch.inference_mode()
    def _ids(self, images_u8: np.ndarray, mode: str) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
        feats = self.model.backbone_features(eval_transform(x, self.cfg.crop_size))
        return decode_ids(self.model, self.cfg, feats, mode)

    def caption_images(self, images_u8: np.ndarray, mode: str = "beam") -> List[str]:
        """images_u8 [N, H, W, 3] uint8 -> N captions; ``mode`` is "beam"
        (beam width ``cfg.beam_size``) or "greedy"."""
        n = images_u8.shape[0]
        out: List[str] = []
        i = 0
        while i < n:
            b = self._bucket(n - i)
            chunk = images_u8[i : i + b]
            live = chunk.shape[0]
            if live < b:
                pad = np.repeat(chunk[-1:], b - live, axis=0)
                chunk = np.concatenate([chunk, pad], axis=0)
            ids = self._ids(chunk, mode).cpu().numpy()
            out.extend(self.vocab.decode_batch(ids[:live]))
            i += b
        return out

    def warmup(
        self, modes: Sequence[str] = ("beam",), buckets: Optional[Sequence[int]] = None
    ) -> float:
        """Run one dummy batch per (bucket, mode), so the first request pays
        no kernel build or cuDNN algorithm search. Returns seconds spent."""
        t0 = time.perf_counter()
        buckets = sorted(set(buckets)) if buckets else list(self.bucket_sizes)
        dummy = np.zeros((buckets[-1], 256, 256, 3), np.uint8)
        for mode in modes:
            for b in buckets:
                self.caption_images(dummy[:b], mode=mode)
        return time.perf_counter() - t0
