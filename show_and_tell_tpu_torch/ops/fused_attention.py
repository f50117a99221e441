"""Fused additive attention, one row per image: the CUDA kernel's wrapper and
its plain PyTorch version.

The chain (see ``ops/attention.py``) for hidden projections hp [B, D]:

    t = tanh(ctx_enc + hp[:, None, :]);  e = t . w_att
    alpha = softmax(e) (fp32);  context = (alpha . features) / L

runs in one pass of the kernel in ``csrc/additive_attention.cu`` with K = 1:
``ctx_enc`` and ``features`` are each read once and no [B, L, D]
intermediate is written. The h-projection ``hidden @ w_hh + b_hh`` stays a
matrix product outside the kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from show_and_tell_tpu_torch.ops import cuda_lib

Params = Dict[str, torch.Tensor]


def attention_reference(
    ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ce, f [B, L, D]; hp [B, D]; watt [D] ->
    (context [B, D] in f's dtype, alpha [B, L] fp32)."""
    t = torch.tanh(ce + hp[:, None, :])
    e = torch.einsum("bld,d->bl", t, watt)
    alpha = torch.softmax(e.float(), dim=-1)
    ctx = torch.einsum("bl,bld->bd", alpha.to(f.dtype), f) / f.shape[1]
    return ctx, alpha


def launch_attention(
    name: str, ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the additive-attention kernel for K rows per image and count
    the launch under ``name``. ce, f [B, L, D]; hp [B, K, D]; watt [D], all
    one dtype. Returns (context [B, K, D] in that dtype, alpha [B, K, L]
    fp32)."""
    cuda_lib.check_operands(name, ce.device, ce=ce, f=f, hp=hp, watt=watt)
    if ce.dim() != 3 or hp.dim() != 3:
        raise ValueError(f"{name}: ce must be [B, L, D] and hp [B, K, D]")
    B, L, D = ce.shape
    K = hp.shape[1]
    if tuple(f.shape) != (B, L, D) or tuple(hp.shape) != (B, K, D) or tuple(watt.shape) != (D,):
        raise ValueError(
            f"{name}: shapes ce {tuple(ce.shape)} f {tuple(f.shape)} hp {tuple(hp.shape)} "
            f"watt {tuple(watt.shape)} do not agree"
        )
    if not (ce.dtype == f.dtype == hp.dtype == watt.dtype):
        raise TypeError(f"{name}: ce, f, hp, watt dtypes differ")
    code = cuda_lib.dtype_code(ce)
    lib = cuda_lib.library("additive_attention.cu")
    kmax = lib.sat_attention_kmax()
    if not 1 <= K <= kmax:
        raise ValueError(f"{name}: K={K} rows per image, the kernel takes 1..{kmax}")
    ctx = torch.empty((B, K, D), dtype=ce.dtype, device=ce.device)
    alpha = torch.empty((B, K, L), dtype=torch.float32, device=ce.device)
    if B == 0 or L == 0:
        return ctx, alpha
    vec = int(cuda_lib.vectorizable((D,), ce))
    err = lib.sat_additive_attention(
        cuda_lib.ptr(ce), cuda_lib.ptr(f), cuda_lib.ptr(hp), cuda_lib.ptr(watt),
        cuda_lib.ptr(ctx), cuda_lib.ptr(alpha), B, K, L, D, code, vec,
        cuda_lib.stream(ce.device),
    )
    cuda_lib.check(err, name)
    cuda_lib.LAUNCHES[name] += 1
    return ctx, alpha


def fused_attention(
    ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain for hp [B, D]: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if ce.is_cuda:
        ctx, alpha = launch_attention("additive_attention", ce, f, hp[:, None, :], watt)
        return ctx[:, 0], alpha[:, 0]
    return attention_reference(ce, f, hp, watt)


def fused_additive_attention(
    params: Params,
    features: torch.Tensor,  # [B, L, D]
    ctx_enc: torch.Tensor,  # [B, L, D]
    hidden: torch.Tensor,  # [B, H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``ops.attention.additive_attention`` through the kernel.
    Returns ``(context [B, D], alpha [B, L])``."""
    hp = hidden @ params["w_hh"] + params["b_hh"]
    return fused_attention(ctx_enc, features, hp, params["w_att"])
