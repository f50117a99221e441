"""Stochastic decoding: temperature, top-k and top-p (nucleus) sampling.

The same step interface as greedy and beam. The filters are the JAX
package's, to the letter:

- top-k keeps every logit >= the k-th largest, so ties with it are kept;
- top-p keeps the smallest prefix of the descending probabilities whose
  mass reaches p: a token is kept while the *exclusive* cumulative sum
  before it is < p, so the top token always is;
- a dropped logit becomes ``NEG_INF`` = -1e9, never -inf.

The draw is a Gumbel-max over the filtered logits, with the noise drawn from
the given ``torch.Generator`` on the logits' device. Like the JAX scan the
loop runs a fixed ``max_len`` steps with no early exit, so it reads nothing
back from the device per step; tokens after a row's ``<end>`` are cut by the
host's string decode.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from show_and_tell_tpu_torch.decode.greedy import carry_device
from show_and_tell_tpu_torch.utils.vocab import START_ID

NEG_INF = -1.0e9


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int, top_p: float = 1.0) -> torch.Tensor:
    """[B, V] -> fp32 [B, V] with the temperature applied and the dropped
    tokens at ``NEG_INF``."""
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        exclusive = torch.cumsum(probs, dim=-1) - probs
        keep = exclusive < top_p
        min_kept = torch.where(keep, sorted_logits, torch.inf).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < min_kept, NEG_INF, logits)
    return logits


def _sample_from_logits(
    generator: torch.Generator, logits: torch.Tensor, temperature: float, top_k: int, top_p: float = 1.0
) -> torch.Tensor:
    """One token per row (int64), drawn from the filtered softmax."""
    logits = filter_logits(logits, temperature, top_k, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return (logits + gumbel).argmax(dim=-1)


def sample_decode(
    step_fn: Callable[[Any, torch.Tensor], Tuple[Any, torch.Tensor]],
    carry: Any,
    batch: int,
    generator: torch.Generator,
    max_len: int = 20,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    first_logits: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns sampled ids ``[batch, max_len]`` (int64). ``first_logits``
    given (Show-and-Tell): token 0 is drawn from it; None (Show-Attend-Tell):
    decoding starts from ``<start>``."""
    toks = []
    if first_logits is not None:
        prev = _sample_from_logits(generator, first_logits, temperature, top_k, top_p)
        toks.append(prev)
    else:
        prev = torch.full((batch,), START_ID, dtype=torch.long, device=carry_device(carry))
    while len(toks) < max_len:
        carry, logits = step_fn(carry, prev)
        prev = _sample_from_logits(generator, logits, temperature, top_k, top_p)
        toks.append(prev)
    if not toks:
        return torch.zeros((batch, 0), dtype=torch.long, device=carry_device(carry))
    return torch.stack(toks, dim=1)
