"""Greedy decoding: the argmax rule over ``decode.loop``.

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

from show_and_tell_tpu_torch.decode.loop import carry_device, run
from show_and_tell_tpu_torch.utils.vocab import END_ID, PAD_ID, START_ID


class _Greedy:
    """Greedy's selection rule: each step's argmax into column t of ``out``
    [rows, max_len]."""

    def __init__(self, out: torch.Tensor, finished: torch.Tensor, early_stop: bool):
        self.out, self.finished, self.early_stop = out, finished, early_stop

    def emitted(self, t: int) -> torch.Tensor:
        return self.out[:, :t]

    def select(self, carry: Any, logits: torch.Tensor, t: int) -> Tuple[Any, torch.Tensor]:
        tok = logits.argmax(dim=-1)
        if self.early_stop:
            tok = torch.where(self.finished, PAD_ID, tok)
            self.finished = self.finished | (tok == END_ID)
        self.out[:, t] = tok
        return carry, tok

    def result(self) -> torch.Tensor:
        return self.out


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
        finished = prev == END_ID
        start_pos = 1
    else:
        prev = torch.full((batch,), START_ID, dtype=torch.long, device=dev)
        finished = torch.zeros(batch, dtype=torch.bool, device=dev)
        start_pos = 0
    return run(_Greedy(out, finished, early_stop), step_fn, carry, prev, start_pos, max_len, early_stop)
