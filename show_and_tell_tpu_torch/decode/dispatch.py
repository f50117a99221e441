"""One place that maps a decode mode onto the decode algorithms, for the
served ids (``decode_ids``) and for every beam (``decode_nbest``).

The model-specific part lives behind the model's ``decode_state``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from show_and_tell_tpu_torch.decode import beam
from show_and_tell_tpu_torch.decode.beam import beam_search
from show_and_tell_tpu_torch.decode.greedy import greedy_decode
from show_and_tell_tpu_torch.decode.sample import sample_decode
from show_and_tell_tpu_torch.obs.profiler import span


def decode_ids(
    model,
    cfg,
    features: torch.Tensor,
    mode: str = "beam",
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    mesh=None,
) -> torch.Tensor:
    """features [B, ...] -> ids [B, max_decode_len] by beam, greedy or
    sample; "sample" draws from ``generator`` (on the features' device) with
    the three knobs of ``decode.sample``, for the global batch when the
    features are this rank's rows over ``mesh``. Beam mode calls this
    module's ``beam_search``."""
    if mode not in ("beam", "greedy", "sample"):
        raise ValueError(f"unknown decode mode {mode!r}")
    if mode == "sample" and generator is None:
        raise ValueError("mode 'sample' needs a torch.Generator on the features' device")
    B = features.shape[0]
    k = cfg.beam_size if mode == "beam" else 1
    with span("decode"):
        with span("decode.prepare"):
            step_fn, carry, first, tile = model.decode_state(features, beam_size=k)
        if mode == "beam":
            ids, _ = beam_search(
                step_fn, carry, B, beam_size=k, max_len=cfg.max_decode_len,
                length_penalty=cfg.length_penalty, first_logits=first, tile=tile,
            )
            return ids
        if mode == "sample":
            return sample_decode(
                step_fn, carry, B, generator, cfg.max_decode_len,
                temperature=temperature, top_k=top_k, top_p=top_p, first_logits=first, mesh=mesh,
            )
        return greedy_decode(step_fn, carry, B, cfg.max_decode_len, first_logits=first)


def decode_nbest(model, cfg, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """features [B, ...] -> every beam, best first, and the length-normalised
    scores that rank them: (ids [B, k, max_decode_len], scores [B, k]). It
    calls ``beam.beam_search``, whatever a caller put in this module's place."""
    k = cfg.beam_size
    with span("decode"):
        with span("decode.prepare"):
            step_fn, carry, first, tile = model.decode_state(features, beam_size=k)
        return beam.beam_search(
            step_fn, carry, features.shape[0], beam_size=k, max_len=cfg.max_decode_len,
            length_penalty=cfg.length_penalty, first_logits=first, tile=tile, return_all=True,
        )
