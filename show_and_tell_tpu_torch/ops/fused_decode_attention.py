"""Beam-shared fused decode attention: the CUDA kernels' wrappers, by
variant name, and their plain PyTorch versions.

For K beams that share one image, with per-beam hidden projections
hp [B, K, D]:

    t_k = tanh(ctx_enc + hp_k[:, None, :]);  e_k = t_k . w_att
    alpha_k = softmax(e_k) (fp32);  context_k = (alpha_k . features) / L

Rows are beam-major per image (row ``b*K + j``), so the model passes
``h_proj.reshape(B, K, D)``.

The names are the JAX package's (``VARIANTS``, ``SCORE_VARIANTS``); each
runs one of four kernels:

- every ``s*_c*`` name (the default ``s16_cmxu``): the fused kernel of
  ``csrc/decode_attention.cu``, a cluster of ``beam_plan`` blocks per
  image, ce and f read once for all K beams;
- ``grid2``: ``csrc/beam_attention.cu``, one block per (image, beam);
- ``st_cmxu``, ``st_cvpu``: ``csrc/beam_attention.cu`` on ce transposed to
  [B, D, L], transposed once per call by the wrapper (a caller that decodes
  many steps can transpose once and call ``attention_beam_st``);
- ``attention_scores`` (every name of ``SCORE_VARIANTS``): scores only, and
  ``attention_beam_hybrid`` adds a plain softmax and context.

The score suffixes (``s32``, ``s16``, ``smxu``) and the context suffixes
(``cvpu``, ``cmxu``) name TPU formulations: a lane reduction or an MXU
matmul, an fp32 or a bf16 product. The kernels here take every product and
sum in fp32, so on Hopper they are one function, and the bf16 roundings of
the TPU's ``s16`` and ``st`` forms are not reproduced. ``block_b``, which
sizes the TPU's VMEM blocks, has no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch

from show_and_tell_tpu_torch.ops import cuda_lib
from show_and_tell_tpu_torch.ops.fused_attention import attention_shapes, launch_attention

# variant = "<score>_<context>": score in {s32, s16, smxu, st}, context in
# {cvpu, cmxu}; "grid2" = the (image, beam) grid
VARIANTS = (
    "s32_cvpu", "smxu_cvpu", "s16_cvpu", "s16_cmxu", "smxu_cmxu", "s32_cmxu",
    "grid2", "st_cmxu", "st_cvpu",
)
SCORE_VARIANTS = ("s32", "s16", "smxu")

# csrc/decode_attention.cu: a block's dynamic shared memory on Hopper, its
# barrier area, the largest cluster, the patch rows that call for one more
# block per image, and how a block gets its ce and f rows (``Mode`` there)
SMEM_LIMIT = 227 * 1024
_BAR_BYTES = 128
_CLUSTER_MAX = 8
_ROWS_PER_BLOCK = 64
BEAM_MODES = ("direct", "f_bulk")


def beam_smem_bytes(K: int, L: int, D: int, C: int, itemsize: int, mode: str) -> int:
    """Shared memory of one block of the beam kernel, C blocks per image;
    the layout of ``smem_bytes`` in ``csrc/decode_attention.cu``."""
    Lc = -(-L // C)
    rows = Lc * D * itemsize if mode == "f_bulk" else 0  # f
    return _BAR_BYTES + rows + 4 * (K * D + D + K * Lc + 2 * K)


def beam_plan(K: int, L: int, D: int, itemsize: int, aligned: bool) -> Tuple[int, str]:
    """(C, mode) for the beam kernel: C blocks per image in a cluster, each
    holding ceil(L / C) patch rows, and how a block gets its rows. C is
    ceil(L / 64), 1 to 4 (4 at L=196), doubled up to 8 while a block's f
    rows overflow shared memory. f arrives by bulk copy into shared memory
    and ce, hp and w_att in 16-byte vectors (``f_bulk``) when rows are
    16-byte multiples, the operands are ``aligned`` and the share fits;
    otherwise the kernel reads them element by element (``direct``)."""
    C = min(4, max(1, -(-L // _ROWS_PER_BLOCK)))
    if not aligned or (D * itemsize) % 16:
        return C, "direct"
    while C < _CLUSTER_MAX and beam_smem_bytes(K, L, D, C, itemsize, "f_bulk") > SMEM_LIMIT:
        C *= 2
    fits = beam_smem_bytes(K, L, D, C, itemsize, "f_bulk") <= SMEM_LIMIT
    return C, "f_bulk" if fits else "direct"


def attention_beam_reference(
    ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (context [B, K, D] in f's dtype, alpha [B, K, L] fp32),
    in the inputs' dtype up to the fp32 softmax, as the JAX model's chain."""
    L = ce.shape[1]
    t = torch.tanh(ce[:, None, :, :] + hp[:, :, None, :])  # [B, K, L, D]
    e = torch.einsum("bkld,d->bkl", t, watt)
    alpha = torch.softmax(e.float(), dim=-1)
    ctx = torch.einsum("bkl,bld->bkd", alpha.to(f.dtype), f) / L
    return ctx, alpha


def attention_scores_reference(
    ce: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> torch.Tensor:
    """Plain version of the scores kernel: e [B, K, L], computed in fp32
    from inputs of either dtype, as the kernel computes it."""
    t = torch.tanh(ce.float()[:, None, :, :] + hp.float()[:, :, None, :])  # [B, K, L, D]
    return torch.einsum("bkld,d->bkl", t, watt.float())


def attention_beam_st_reference(
    cet: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the transposed form: ce^T [B, D, L]."""
    return attention_beam_reference(cet.transpose(1, 2), f, hp, watt)


def _check_variant(variant: str, names) -> None:
    if variant not in names:
        raise ValueError(f"unknown variant {variant!r}; options: {names}")


def attention_beam_st(
    cet: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transposed form on ce^T [B, D, L]: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if not cet.is_cuda:
        return attention_beam_st_reference(cet, f, hp, watt)
    name = "attention_beam_st"
    B, K, L, D = attention_shapes(name, cet, f, hp, watt, transposed=True)
    ctx = torch.empty((B, K, D), dtype=f.dtype, device=f.device)
    alpha = torch.empty((B, K, L), dtype=torch.float32, device=f.device)
    if B == 0 or L == 0:
        return ctx, alpha
    err = cuda_lib.library("beam_attention.cu").sat_attention_beam_st(
        cuda_lib.ptr(cet), cuda_lib.ptr(f), cuda_lib.ptr(hp), cuda_lib.ptr(watt),
        cuda_lib.ptr(ctx), cuda_lib.ptr(alpha), B, K, L, D, cuda_lib.dtype_code(f),
        cuda_lib.stream(f.device),
    )
    cuda_lib.check(err, name)
    cuda_lib.LAUNCHES[name] += 1
    return ctx, alpha


def attention_beam_cluster(
    ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the cluster kernel of ``csrc/decode_attention.cu`` on CUDA
    tensors and count it under ``attention_beam``, by design
    ``cluster<C>-<mode>``."""
    name = "attention_beam"
    B, K, L, D = attention_shapes(name, ce, f, hp, watt)
    ctx = torch.empty((B, K, D), dtype=ce.dtype, device=ce.device)
    alpha = torch.empty((B, K, L), dtype=torch.float32, device=ce.device)
    if B == 0 or L == 0:
        return ctx, alpha
    C, mode = beam_plan(K, L, D, ce.element_size(), cuda_lib.vectorizable((D,), ce, f, hp, watt))
    err = cuda_lib.library("decode_attention.cu").sat_decode_attention(
        cuda_lib.ptr(ce), cuda_lib.ptr(f), cuda_lib.ptr(hp), cuda_lib.ptr(watt),
        cuda_lib.ptr(ctx), cuda_lib.ptr(alpha), B, K, L, D, cuda_lib.dtype_code(ce), C, BEAM_MODES.index(mode),
        cuda_lib.stream(ce.device),
    )
    cuda_lib.check(err, name)
    cuda_lib.count(name, f"cluster{C}-{mode}")
    return ctx, alpha


def attention_beam(
    ce: torch.Tensor,  # [B, L, D] per-image encoded context
    f: torch.Tensor,  # [B, L, D] per-image features
    hp: torch.Tensor,  # [B, K, D] per-beam hidden projections (+bias)
    watt: torch.Tensor,  # [D]
    variant: str = "s16_cmxu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(context [B, K, D], alpha [B, K, L]) by the kernel ``variant`` names
    for CUDA tensors, the plain version for CPU tensors."""
    _check_variant(variant, VARIANTS)
    if not ce.is_cuda:
        return attention_beam_reference(ce, f, hp, watt)
    if variant == "grid2":
        return launch_attention("attention_beam_grid2", ce, f, hp, watt)
    if variant.startswith("st_"):
        return attention_beam_st(ce.transpose(1, 2).contiguous(), f, hp, watt)
    return attention_beam_cluster(ce, f, hp, watt)


def attention_scores(
    ce: torch.Tensor,  # [B, L, D]
    hp: torch.Tensor,  # [B, K, D]
    watt: torch.Tensor,  # [D]
    variant: str = "s16",
) -> torch.Tensor:
    """Raw scores ``e [B, K, L]`` fp32 = tanh(ce + hp_k) . watt: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check_variant(variant, SCORE_VARIANTS)
    if not ce.is_cuda:
        return attention_scores_reference(ce, hp, watt)
    name = "attention_scores"
    # f is not read; ce stands in for it in the shape check
    B, K, L, D = attention_shapes(name, ce, ce, hp, watt)
    e = torch.empty((B, K, L), dtype=torch.float32, device=ce.device)
    if B == 0 or L == 0:
        return e
    vec = int(cuda_lib.vectorizable((D,), ce))
    err = cuda_lib.library("beam_attention.cu").sat_attention_scores(
        cuda_lib.ptr(ce), cuda_lib.ptr(hp), cuda_lib.ptr(watt), cuda_lib.ptr(e),
        B, K, L, D, cuda_lib.dtype_code(ce), vec, cuda_lib.stream(ce.device),
    )
    cuda_lib.check(err, name)
    cuda_lib.LAUNCHES[name] += 1
    return e


def attention_beam_hybrid(
    ce: torch.Tensor,
    f: torch.Tensor,
    hp: torch.Tensor,
    watt: torch.Tensor,
    variant: str = "s16",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scores kernel, then a plain fp32 softmax and the alpha . f
    contraction over L, as the JAX package leaves those two to XLA."""
    L = ce.shape[1]
    e = attention_scores(ce, hp, watt, variant)
    alpha = torch.softmax(e, dim=-1)
    ctx = torch.einsum("bkl,bld->bkd", alpha.to(f.dtype), f) / L
    return ctx, alpha
