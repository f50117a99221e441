"""Greedy decoding over a model's step function.

- ``early_stop=True`` (default): stop as soon as every row has emitted
  ``<end>``; positions after a row's ``<end>`` hold ``<pad>``.
- ``early_stop=False``: a fixed ``max_len``-step loop; steps after ``<end>``
  emit argmax tokens that the host truncation discards.

``first_logits`` given (Show-and-Tell): its argmax is token 0. None
(Show-Attend-Tell): decoding starts from ``<start>``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from show_and_tell_tpu_torch.obs import profiler
from show_and_tell_tpu_torch.obs.profiler import span
from show_and_tell_tpu_torch.utils.vocab import END_ID, PAD_ID, START_ID


def carry_device(carry: Any) -> torch.device:
    """The device of the first tensor in a (nested) carry."""
    if torch.is_tensor(carry):
        return carry.device
    values = carry.values() if isinstance(carry, dict) else carry
    for v in values:
        try:
            return carry_device(v)
        except ValueError:
            continue
    raise ValueError("carry holds no tensor")


def count_step(rows: int, live: Optional[Callable] = None, arg: Any = None) -> None:
    """Count one call of a decode's step function over ``rows`` rows in the
    open recording (``obs.profiler``): ``decode.row_steps``, and
    ``decode.live_row_steps``, the rows that had not emitted ``<end>``
    before the call, as ``live(arg)`` when the recording closes (all
    ``rows`` without ``live``)."""
    rec = profiler.active
    rec.counters["decode.row_steps"] += rows
    if live is None:
        rec.counters["decode.live_row_steps"] += rows
    else:
        rec.count_later("decode.live_row_steps", live, arg)


def unended(emitted: torch.Tensor) -> torch.Tensor:
    """How many rows of the tokens ``emitted`` [rows, t] hold no ``<end>``."""
    return (~(emitted == END_ID).any(dim=1)).sum()


def greedy_decode(
    step_fn: Callable[[Any, torch.Tensor], Tuple[Any, torch.Tensor]],
    carry: Any,
    batch: int,
    max_len: int = 20,
    first_logits: Optional[torch.Tensor] = None,
    early_stop: bool = True,
) -> torch.Tensor:
    """Returns ids ``[batch, max_len]`` (int64)."""
    dev = carry_device(carry)
    out = torch.full((batch, max_len), PAD_ID, dtype=torch.long, device=dev)
    if first_logits is not None:
        prev = first_logits.argmax(dim=-1)
        out[:, 0] = prev
        start_pos = 1
    else:
        prev = torch.full((batch,), START_ID, dtype=torch.long, device=dev)
        start_pos = 0
    finished = prev == END_ID if first_logits is not None else torch.zeros(
        batch, dtype=torch.bool, device=dev
    )

    for t in range(start_pos, max_len):
        if early_stop:
            with span("decode.sync"):
                done = bool(finished.all())
            if done:
                break
        if profiler.active is not None:
            count_step(batch, unended, out[:, :t])  # columns before t are final
        with span("decode.step"):
            carry, logits = step_fn(carry, prev)
        with span("decode.select"):
            tok = logits.argmax(dim=-1)
            if early_stop:
                tok = torch.where(finished, PAD_ID, tok)
                finished = finished | (tok == END_ID)
            out[:, t] = tok
        prev = tok
    return out
