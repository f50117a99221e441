"""The one traffic generator: every mix is a parameter file
(``perfbench/traffic/<mix>.json``) that this module reads, and every input
it makes comes from ``--seed`` alone.

- ``images``: uint8 [N, H, W, 3] scenes, made on the device in blocks: a
  coarse random colour field, upsampled bicubically, plus fine grain, so that
  they have the smooth regions and edges that photographs have.
- ``caption_lengths`` and ``captions``: word counts from a discretised
  log-normal (COCO's captions: mean about 10.5 words, most 8-15, a long
  tail), cut to the mix's longest caption, and random words.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(mix: str) -> Dict:
    with open(os.path.join(HERE, "traffic", mix + ".json")) as fh:
        return json.load(fh)


def substream(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose of a run (weights, images, captions...)."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), purpose]).generate_state(1, np.uint64)[0] >> 1)


# fixed numbers, so that a seed keeps its inputs
WEIGHTS, IMAGES, CAPTIONS, SAMPLE, CROPS = 0, 1, 4, 5, 6


@torch.no_grad()
def images(n: int, height: int, width: int, seed: int, device, coarse: int = 12, block: int = 256) -> torch.Tensor:
    """uint8 [n, height, width, 3] on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(substream(seed, IMAGES))
    out = torch.empty((n, height, width, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, block):
        b = min(block, n - i)
        field = torch.rand((b, 3, coarse, coarse * width // height), generator=g, device=device)
        x = F.interpolate(field, size=(height, width), mode="bicubic", align_corners=False)
        x = x + 0.08 * torch.rand((b, 3, height, width), generator=g, device=device)
        out[i : i + b] = (x.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1)
    return out


def caption_lengths(n: int, mu: float, sigma: float, lo: int, hi: int, seed: int) -> np.ndarray:
    """Words per caption: round(exp(N(mu, sigma))), within [lo, hi]."""
    rng = np.random.default_rng(substream(seed, CAPTIONS))
    return np.clip(np.rint(np.exp(rng.normal(mu, sigma, n))), lo, hi).astype(np.int64)


def captions(lengths: np.ndarray, vocab_size: int, seed: int, first_word: int = 4):
    """[n, max(lengths) + 2] int64 rows of ``<start>`` w ... w ``<end>``
    ``<pad>``..., and their lengths with both markers, as the port's dataset
    pads a batch."""
    rng = np.random.default_rng(substream(seed, CAPTIONS) ^ 1)
    n, T = lengths.shape[0], int(lengths.max()) + 2
    out = np.zeros((n, T), np.int64)
    out[:, 0] = 1
    for i, L in enumerate(lengths):
        out[i, 1 : L + 1] = rng.integers(first_word, vocab_size, L)
        out[i, L + 1] = 2
    return out, lengths + 2
