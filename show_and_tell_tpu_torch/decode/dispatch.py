"""One place that maps a decode mode onto the decode algorithms.

The model-specific part lives behind the model's ``decode_state``."""

from __future__ import annotations

import torch

from show_and_tell_tpu_torch.decode.beam import beam_search
from show_and_tell_tpu_torch.decode.greedy import greedy_decode


def decode_ids(model, cfg, features: torch.Tensor, mode: str = "beam") -> torch.Tensor:
    """features [B, ...] -> ids [B, max_decode_len] by beam or greedy."""
    if mode == "sample":
        raise NotImplementedError(
            "mode 'sample' needs decode/sample.py, which is not ported yet; see ROADMAP.md"
        )
    if mode not in ("beam", "greedy"):
        raise ValueError(f"unknown decode mode {mode!r}")
    B = features.shape[0]
    k = cfg.beam_size if mode == "beam" else 1
    step_fn, carry, first, tile = model.decode_state(features, beam_size=k)
    if mode == "beam":
        ids, _ = beam_search(
            step_fn, carry, B, beam_size=k, max_len=cfg.max_decode_len,
            length_penalty=cfg.length_penalty, first_logits=first, tile=tile,
        )
        return ids
    return greedy_decode(step_fn, carry, B, cfg.max_decode_len, first_logits=first)
