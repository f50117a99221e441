"""Loss functions."""

from __future__ import annotations

from typing import Tuple

import torch


def masked_cross_entropy(
    logits: torch.Tensor,  # [B, T, V]
    targets: torch.Tensor,  # [B, T] int
    mask: torch.Tensor,  # [B, T] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(mean_loss, token_count)``: the cross entropy averaged over
    the valid tokens (every valid token weighs the same, whatever its
    caption), with the count at least 1. The log-softmax runs in fp32 even
    when the logits are bf16."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long()).squeeze(-1)
    m = mask.float()
    count = m.sum().clamp(min=1.0)
    return -(ll * m).sum() / count, count
