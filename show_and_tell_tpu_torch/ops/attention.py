"""Additive (Bahdanau-style) visual attention over the encoder feature grid,
in plain PyTorch.

    ctx_enc = features @ W_img                  [B, L, D]   (once per image)
    h_att   = tanh(ctx_enc + (h @ W_hh + b_hh)[:, None, :])
    e       = h_att @ w_att                     [B, L]
    alpha   = softmax(e, axis=-1)               (fp32)
    context = mean_L(features * alpha[..., None])            [B, D]

The context is a *mean* over L, not a sum: the captioning model this system
reproduces divides by L, and trained weights depend on it.

These are the model's plain attention path. After the h-projection they
run the plain chain that sits beside each CUDA kernel:
``fused_attention.attention_reference`` (one row per image) and
``fused_decode_attention.attention_beam_reference`` (k beams per image), so
the model's plain path and the kernels' plain versions are one code.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from show_and_tell_tpu_torch.ops.fused_attention import attention_reference
from show_and_tell_tpu_torch.ops.fused_decode_attention import attention_beam_reference

Params = Dict[str, torch.Tensor]


def init_attention_params(
    feature_dim: int,
    hidden_size: int,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """``w_img`` [D, D] Xavier-uniform; ``w_hh`` [H, D] and ``b_hh`` [D]
    (zeros); ``w_att`` [D]."""
    s_img = math.sqrt(6.0 / (feature_dim + feature_dim))
    s_hh = 1.0 / math.sqrt(hidden_size)
    s_att = math.sqrt(6.0 / (feature_dim + 1))

    def u(shape, s):
        return torch.rand(*shape, generator=generator, dtype=dtype) * (2 * s) - s

    return {
        "w_img": u((feature_dim, feature_dim), s_img),
        "w_hh": u((hidden_size, feature_dim), s_hh),
        "b_hh": torch.zeros(feature_dim, dtype=dtype),
        "w_att": u((feature_dim,), s_att),
    }


def encode_features(params: Params, features: torch.Tensor) -> torch.Tensor:
    """``ctx_enc = features @ W_img``, once per image before the time loop."""
    return features @ params["w_img"]


def additive_attention(
    params: Params,
    features: torch.Tensor,  # [B, L, D]
    ctx_enc: torch.Tensor,  # [B, L, D]
    hidden: torch.Tensor,  # [B, H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(context [B, D], alpha [B, L])``."""
    h_proj = hidden @ params["w_hh"] + params["b_hh"]  # [B, D]
    return attention_reference(ctx_enc, features, h_proj, params["w_att"])


def additive_attention_beamed(
    params: Params,
    features: torch.Tensor,  # [B, L, D], not tiled over beams
    ctx_enc: torch.Tensor,  # [B, L, D]
    hidden: torch.Tensor,  # [B*k, H], beam-major
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search attention that broadcasts the image tensors over the k
    beams instead of tiling them. Returns ``(context [B*k, D],
    alpha [B*k, L])`` in the tiled row order."""
    B, L, D = features.shape
    h_proj = hidden @ params["w_hh"] + params["b_hh"]  # [B*k, D]
    context, alpha = attention_beam_reference(
        ctx_enc, features, h_proj.reshape(B, k, D), params["w_att"]
    )  # [B, k, D], [B, k, L]
    return context.reshape(B * k, D), alpha.reshape(B * k, L)
