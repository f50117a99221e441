"""Batched beam search: a start and a selection rule over ``decode.loop``.

- All B images decode together with k beams each; rows are beam-major per
  image (``b*k + j``), so the model step sees one [B*k, ...] batch.
- Candidate expansion is a top-k over the k*V joint continuation scores,
  taken on fp32 log-probabilities.
- At step 0 all beams are identical, so beams 1..k-1 are masked and the
  top-k picks k distinct first tokens from beam 0.
- Finished beams (emitted ``<end>``) may only emit ``<pad>`` at log-prob 0,
  which keeps their score.
- Each selection reorders the carry by this module's ``_gather_beams``.
- Optional GNMT length penalty ``((5+len)/6)**alpha``; ``alpha=0`` ranks by
  the raw sum of log-probs.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from show_and_tell_tpu_torch.decode.loop import carry_device, run
from show_and_tell_tpu_torch.utils.vocab import END_ID, PAD_ID, START_ID

NEG_INF = -1.0e9


def _map(tree: Any, fn: Callable) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _tile_beams(tree: Any, k: int) -> Any:
    """[B, ...] -> [B*k, ...] with each row repeated k times (beam-major)."""
    return _map(
        tree,
        lambda x: x.repeat_interleave(k, dim=0) if torch.is_tensor(x) and x.dim() >= 1 else x,
    )


def _gather_beams(tree: Any, parent: torch.Tensor, B: int, k: int) -> Any:
    """Reorder the [B*k, ...] leaves by parent beam indices [B, k]; leaves
    with another first dimension are left alone."""
    flat_idx = (torch.arange(B, device=parent.device)[:, None] * k + parent).reshape(-1)

    def gather(x):
        if torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == B * k:
            return x.index_select(0, flat_idx)
        return x

    return _map(tree, gather)


def _length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    if alpha == 0.0:
        return torch.ones_like(lengths, dtype=torch.float32)
    return torch.pow((5.0 + lengths.float()) / 6.0, alpha)


class _Beam:
    """Beam search's rule: scores, histories and finished flags [B, k],
    reordered by each step's parents."""

    finished: Optional[torch.Tensor] = None

    def __init__(self, B: int, k: int, max_len: int, dev, length_penalty: float, return_all: bool):
        self.B, self.k, self.max_len, self.dev = B, k, max_len, dev
        self.length_penalty, self.return_all = length_penalty, return_all

    def emitted(self, t: int) -> torch.Tensor:
        return self.tokens[:, :, :t]

    def select(self, carry: Any, logits: torch.Tensor, t: int) -> Tuple[Any, torch.Tensor]:
        B, k, dev = self.B, self.k, self.dev
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, k, V)
        if t == 0:  # the beams are identical: beam 0's candidates only
            beam_mask = torch.full((1, k, 1), NEG_INF, device=dev)
            beam_mask[:, 0] = 0.0
            cand = logp + beam_mask
        else:
            cand = self.scores[:, :, None] + torch.where(self.finished[:, :, None], self.pad_only, logp)
        self.scores, flat = torch.topk(cand.reshape(B, k * V), k, dim=-1)
        parent = torch.div(flat, V, rounding_mode="floor")
        tok = flat % V
        carry = _gather_beams(carry, parent, B, k)
        if t == 0:
            self.finished = tok == END_ID
            self.tokens = torch.full((B, k, self.max_len), PAD_ID, dtype=torch.long, device=dev)
            self.tokens[:, :, 0] = tok
            self.pad_only = torch.full((V,), NEG_INF, device=dev)
            self.pad_only[PAD_ID] = 0.0
        else:
            # histories follow their parents, then take the new column
            tokens = torch.gather(self.tokens, 1, parent[:, :, None].expand(B, k, self.max_len))
            finished = torch.gather(self.finished, 1, parent)
            tokens[:, :, t] = torch.where(finished, PAD_ID, tok)
            self.tokens, self.finished = tokens, finished | (tok == END_ID)
        return carry, tok.reshape(B * k)

    def result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        # Rank by length-normalised score. Lengths count every non-pad token:
        # <end> for finished beams, the full budget for unfinished ones.
        B, k, tokens = self.B, self.k, self.tokens
        lengths = (tokens != PAD_ID).sum(dim=-1)
        norm = self.scores / _length_penalty(lengths, self.length_penalty)
        if self.return_all:
            order = torch.argsort(-norm, dim=-1, stable=True)
            all_ids = torch.gather(tokens, 1, order[:, :, None].expand(B, k, self.max_len))
            return all_ids, torch.gather(norm, 1, order)
        best = norm.argmax(dim=-1)
        return tokens[torch.arange(B, device=self.dev), best], norm[torch.arange(B, device=self.dev), best]


def beam_search(
    step_fn: Callable[[Any, torch.Tensor], Tuple[Any, torch.Tensor]],
    carry: Any,
    batch: int,
    beam_size: int = 3,
    max_len: int = 20,
    length_penalty: float = 0.0,
    first_logits: Optional[torch.Tensor] = None,
    tile: bool = True,
    return_all: bool = False,
    early_stop: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(ids [B, max_len], scores [B])`` for the best beam, or, with
    ``return_all``, the n-best ``(ids [B, k, max_len], scores [B, k])``
    sorted best-first. ``early_stop`` ends the loop once every beam of every
    image has emitted ``<end>``, with the same result as the full loop.

    ``carry`` holds per-image state ``[B, ...]`` and is tiled to
    ``[B*k, ...]`` here; pass ``tile=False`` when it already is per beam."""
    B, k = batch, beam_size
    dev = carry_device(carry)
    if tile:
        carry = _tile_beams(carry, k)
    rule = _Beam(B, k, max_len, dev, length_penalty, return_all)
    if first_logits is not None:
        return run(rule, step_fn, carry, None, 0, max_len, early_stop, first_logits.repeat_interleave(k, dim=0))
    start = torch.full((B * k,), START_ID, dtype=torch.long, device=dev)
    return run(rule, step_fn, carry, start, 0, max_len, early_stop)
