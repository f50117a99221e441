"""The step loop that beam search, greedy decoding and sampling share, and
the only place that opens ``decode.sync``, ``decode.step`` and
``decode.select`` and counts a step's rows.

Each decode is a start and a selection rule over ``run``: step t feeds
tokens to the model's ``step_fn(carry, tokens) -> (carry, logits)``, and
``rule.select(carry, logits, t) -> (carry, tokens)`` picks the next ones. A
rule also holds ``finished``, the rows that have emitted ``<end>`` (None
while none can have), and gives ``emitted(t)``, the tokens emitted before
step t (ids ``[..., t]``, or their t columns), and ``result()``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from show_and_tell_tpu_torch.obs import profiler
from show_and_tell_tpu_torch.obs.profiler import span
from show_and_tell_tpu_torch.utils.vocab import END_ID


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


def unended(emitted: Any) -> torch.Tensor:
    """How many rows of the tokens ``emitted`` (ids ``[..., t]``, or their t
    columns) hold no ``<end>``."""
    if not torch.is_tensor(emitted):
        emitted = torch.stack(emitted, dim=-1)
    return (~(emitted == END_ID).any(dim=-1)).sum()


def count_step(rows: int, emitted: Any = None) -> None:
    """Count one call of a decode's step function over ``rows`` rows in the
    open recording (``obs.profiler``): ``decode.row_steps``, and
    ``decode.live_row_steps``, the rows that had not emitted ``<end>``
    before the call, as ``unended(emitted)`` when the recording closes (all
    ``rows`` where nothing was emitted yet)."""
    rec = profiler.active
    rec.counters["decode.row_steps"] += rows
    if emitted is None:
        rec.counters["decode.live_row_steps"] += rows
    else:
        rec.count_later("decode.live_row_steps", unended, emitted)


def run(rule: Any, step_fn, carry: Any, tokens: Optional[torch.Tensor], start: int, max_len: int,
        early_stop: bool, logits: Optional[torch.Tensor] = None) -> Any:
    """Steps ``start`` .. ``max_len - 1``, then ``rule.result()``. Given
    ``logits`` (a first word's, which come with the decode's state), the
    first step selects from them without calling ``step_fn``.
    ``early_stop`` ends the loop once every row has finished."""
    for t in range(start, max_len):
        if logits is None:
            if early_stop and rule.finished is not None:
                with span("decode.sync"):
                    done = bool(rule.finished.all())
                if done:
                    break
            if profiler.active is not None:
                # no later selection writes what was emitted before step t
                count_step(len(tokens), rule.emitted(t) if t else None)
            with span("decode.step"):
                carry, logits = step_fn(carry, tokens)
        with span("decode.select"):
            carry, tokens = rule.select(carry, logits, t)
        logits = None
    with span("decode.select"):
        return rule.result()
