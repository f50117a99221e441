"""Loss functions."""

from __future__ import annotations

from typing import Tuple

import torch

from show_and_tell_tpu_torch.parallel.collectives import all_reduce


def masked_cross_entropy(
    logits: torch.Tensor,  # [B, T, V]
    targets: torch.Tensor,  # [B, T] int
    mask: torch.Tensor,  # [B, T] bool
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(mean_loss, token_count)``: the cross entropy averaged over
    the valid tokens (every valid token weighs the same, whatever its
    caption), with the count at least 1. The log-softmax runs in fp32 even
    when the logits are bf16.

    Over a mesh the rows are this rank's share of the global batch: the
    count is the global batch's (summed over the data group) and the loss
    is this rank's part of the global mean, so the sum of the ranks' losses
    and of their gradients is the global batch's, whatever tokens each rank
    holds."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long()).squeeze(-1)
    m = mask.float()
    count = m.sum()
    if mesh is not None and mesh.distributed:
        count = all_reduce(count, mesh.data_group)
    count = count.clamp(min=1.0)
    return -(ll * m).sum() / count, count
