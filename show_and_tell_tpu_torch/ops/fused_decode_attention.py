"""Beam-shared fused decode attention: the CUDA kernel's wrapper and its
plain PyTorch version.

For K beams that share one image, with per-beam hidden projections
hp [B, K, D]:

    t_k = tanh(ctx_enc + hp_k[:, None, :]);  e_k = t_k . w_att
    alpha_k = softmax(e_k) (fp32);  context_k = (alpha_k . features) / L

The kernel in ``csrc/additive_attention.cu`` reads ``ctx_enc`` and
``features`` once per image for all K beams. Rows are beam-major per image
(row ``b*K + j``), so the model passes ``h_proj.reshape(B, K, D)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from show_and_tell_tpu_torch.ops.fused_attention import launch_attention


def attention_beam_reference(
    ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (context [B, K, D] in f's dtype, alpha [B, K, L] fp32)."""
    L = ce.shape[1]
    t = torch.tanh(ce[:, None, :, :] + hp[:, :, None, :])  # [B, K, L, D]
    e = torch.einsum("bkld,d->bkl", t, watt)
    alpha = torch.softmax(e.float(), dim=-1)
    ctx = torch.einsum("bkl,bld->bkd", alpha.to(f.dtype), f) / L
    return ctx, alpha


def attention_beam(
    ce: torch.Tensor,  # [B, L, D] per-image encoded context
    f: torch.Tensor,  # [B, L, D] per-image features
    hp: torch.Tensor,  # [B, K, D] per-beam hidden projections (+bias)
    watt: torch.Tensor,  # [D]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(context [B, K, D], alpha [B, K, L]): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ce.is_cuda:
        return launch_attention("attention_beam", ce, f, hp, watt)
    return attention_beam_reference(ce, f, hp, watt)
