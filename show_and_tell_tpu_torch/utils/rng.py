"""Named random streams from one root seed.

``KeyChain(seed).generator(*tags, device=...)`` is a ``torch.Generator``
seeded from the root seed folded with the tags, so every stochastic use
(initialisation, sampling, data order) has its own reproducible stream.
``numpy_rng(*tags)`` is the host-side stream and draws exactly what the JAX
package's ``KeyChain.numpy_rng`` draws for the same seed and tags. The JAX
package's device keys (``jax.random.fold_in``) have no torch counterpart: the
generators here are seeded from the same fold as ``numpy_rng`` instead.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


class KeyChain:
    def __init__(self, seed: int):
        self.seed = int(seed)

    def fold(self, *tags) -> int:
        """The 32-bit seed of a stream: the root seed folded with each tag
        (strings by FNV-1a)."""
        h = self.seed
        for t in tags:
            if isinstance(t, str):
                t = _stable_hash(t)
            h = (h * 1000003 + int(t)) & 0xFFFFFFFF
        return h

    def numpy_rng(self, *tags) -> np.random.Generator:
        return np.random.default_rng(self.fold(*tags))

    def generator(self, *tags, device: Union[str, torch.device] = "cpu") -> torch.Generator:
        return torch.Generator(device=device).manual_seed(self.fold(*tags))


def _stable_hash(s: str) -> int:
    # Python's hash() is salted per process; FNV-1a is stable across runs
    h = 2166136261
    for ch in s.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h
