"""Fused additive attention, one row per image: the CUDA kernel's wrapper, its
plain PyTorch version, and the autograd Function that training runs.

The chain (see ``ops/attention.py``) for hidden projections hp [B, D]:

    t = tanh(ctx_enc + hp[:, None, :]);  e = t . w_att
    alpha = softmax(e) (fp32);  context = (alpha . features) / L

runs in one kernel of ``csrc/additive_attention.cu``: ``ctx_enc`` and
``features`` are each read once and no [B, L, D] intermediate is written.
The h-projection ``hidden @ w_hh + b_hh`` stays a matrix product outside the
kernel. ``attention_plan`` picks the design from the shape, the type and the
alignment before the launch: ``onepass`` (an image split over a cluster of
blocks, one pass over ce and f under a running max and sum of exp) for rows
of 16-byte multiples, ``direct`` (a block per image, three phases) for the
rest. On a CUDA tensor it never falls back: the launch succeeds or it raises.
The (image, beam) grid of the beam attention (``variant="grid2"``) runs the
same one-pass kernel with K rows of hp per image (``launch_onepass``).

Training: ``FusedAttentionFunction`` runs the kernel forward and, in its
backward, recomputes the plain chain and differentiates it with autograd.
That is the JAX package's own design (``_fused_bwd``, an XLA recompute under
``jax.vjp``; it has no Pallas backward), not a fallback: on CUDA tensors the
forward always launches the kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from show_and_tell_tpu_torch.ops import cuda_lib

Params = Dict[str, torch.Tensor]

ATTENTION_DESIGNS = ("onepass", "direct")
SMEM_LIMIT = 227 * 1024  # a block's dynamic shared memory on Hopper
H100_SMS = 132
# csrc/additive_attention.cu, the one-pass kernel: the largest cluster, the
# vectors per lane it is built for, and the threads per block
_CLUSTER_MAX = 8
_ONEPASS_NV_MAX = 4
_ONEPASS_THREADS = 256
_ONEPASS_STAGES = 4  # rows of ce and of f per warp in flight


def row_vectors(D: int, itemsize: int) -> int:
    """NV of the streaming kernels: the 16-byte vectors per lane that cover a
    row of D elements (1, 2 or 4: rows up to 512, 1024, 2048 bytes)."""
    return next(n for n in (1, 2, 4) if D * itemsize <= n * 512)


def onepass_smem_bytes(L: int, D: int, C: int, threads: int, itemsize: int) -> int:
    """Shared memory of one block of the one-pass kernel, C blocks per
    image; the layout of ``onepass_smem_floats`` in the source: each warp's
    ring of ``_ONEPASS_STAGES`` rows of ce and of f, then the merge area."""
    nw = threads // 32
    ring = nw * _ONEPASS_STAGES * 2 * row_vectors(D, itemsize) * 512
    return ring + 4 * (nw * D + D + 4 + 2 * 32 + -(-L // C))


def blocks_per_image(B: int, L: int, rows_min: int, cap: int, sms: int = H100_SMS) -> int:
    """How many blocks share an image's L patch rows: one where the batch
    alone gives every SM a block (B >= ``sms``: a split only adds blocks that
    start and stop), else the fewest that do, at most ``cap`` and no more
    than ceil(L / ``rows_min``), so that a block of ``rows_min`` warps has a
    row for almost every warp (L=13, rows_min=8: two blocks, of 7 and 6)."""
    return max(1, min(-(-sms // max(B, 1)), cap, -(-L // rows_min)))


def attention_plan(B: int, L: int, D: int, itemsize: int, aligned: bool) -> Tuple[str, int, int]:
    """(design, C, threads) for the per-row attention: ``onepass`` with C
    blocks per image (``blocks_per_image``, 1 to 8 and at most ceil(L / 8): 1
    at B=256) of ``threads`` threads when rows are 16-byte multiples of at most
    128 vectors (D up to 1024 in bf16, 512 in fp32) and the operands are
    ``aligned``; otherwise ``direct``, one block of 256 threads per image."""
    vec = 16 // itemsize
    if not aligned or D % vec or D > _ONEPASS_NV_MAX * 32 * vec:
        return "direct", 1, 256
    return "onepass", blocks_per_image(B, L, _ONEPASS_THREADS // 32, _CLUSTER_MAX), _ONEPASS_THREADS


# launch-count name -> (source, C entry point) of the first (``direct``)
# kernels. Both entry points take (ce, f, hp, watt, ctx, alpha, B, K, L, D,
# dtype, vec, stream); the beam-shared kernel has its own wrapper
# (``fused_decode_attention``).
_ENTRIES = {
    "additive_attention": ("additive_attention.cu", "sat_additive_attention"),
    "attention_beam_grid2": ("beam_attention.cu", "sat_attention_beam_grid2"),
}


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


def attention_shapes(
    name: str, ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor,
    transposed: bool = False,
) -> Tuple[int, int, int, int]:
    """Check a beam-attention kernel's operands: ce [B, L, D] (or [B, D, L]
    with ``transposed``), f [B, L, D], hp [B, K, D], watt [D], one dtype, on
    one CUDA device, contiguous, and K within the kernels' limit. Returns
    (B, K, L, D)."""
    cuda_lib.check_operands(name, ce.device, ce=ce, f=f, hp=hp, watt=watt)
    if ce.dim() != 3 or f.dim() != 3 or hp.dim() != 3:
        raise ValueError(f"{name}: ce and f must be 3-D and hp [B, K, D]")
    B, L, D = f.shape
    K = hp.shape[1]
    ce_want = (B, D, L) if transposed else (B, L, D)
    if tuple(ce.shape) != ce_want or tuple(hp.shape) != (B, K, D) or tuple(watt.shape) != (D,):
        raise ValueError(
            f"{name}: shapes ce {tuple(ce.shape)} f {tuple(f.shape)} hp {tuple(hp.shape)} "
            f"watt {tuple(watt.shape)} do not agree"
        )
    if not (ce.dtype == f.dtype == hp.dtype == watt.dtype):
        raise TypeError(f"{name}: ce, f, hp, watt dtypes differ")
    cuda_lib.dtype_code(ce)
    kmax = cuda_lib.library("decode_attention.cu").sat_attention_kmax()
    if not 1 <= K <= kmax:
        raise ValueError(f"{name}: K={K} rows per image, the kernels take 1..{kmax}")
    return B, K, L, D


def launch_attention(
    name: str, ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the additive-attention kernel ``name`` (a key of ``_ENTRIES``)
    for K rows per image and count the launch under ``name``. ce, f
    [B, L, D]; hp [B, K, D]; watt [D], all one dtype. Returns (context
    [B, K, D] in that dtype, alpha [B, K, L] fp32)."""
    B, K, L, D = attention_shapes(name, ce, f, hp, watt)
    src, entry = _ENTRIES[name]
    ctx = torch.empty((B, K, D), dtype=ce.dtype, device=ce.device)
    alpha = torch.empty((B, K, L), dtype=torch.float32, device=ce.device)
    if B == 0 or L == 0:
        return ctx, alpha
    vec = int(cuda_lib.vectorizable((D,), ce))
    err = getattr(cuda_lib.library(src), entry)(
        cuda_lib.ptr(ce), cuda_lib.ptr(f), cuda_lib.ptr(hp), cuda_lib.ptr(watt),
        cuda_lib.ptr(ctx), cuda_lib.ptr(alpha), B, K, L, D, cuda_lib.dtype_code(ce), vec,
        cuda_lib.stream(ce.device),
    )
    cuda_lib.check(err, name)
    cuda_lib.count(name, "direct")
    return ctx, alpha


def launch_onepass(
    name: str, ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor,
    C: int, threads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the one-pass kernel on checked CUDA tensors (ce, f [B, L, D];
    hp [B, K, D]; C blocks of ``threads`` threads per row of hp, the rows of
    an image together: K > 1 is the (image, beam) grid) and count it under
    ``name`` by design ``onepass<C>``. Returns (context [B, K, D], alpha
    [B, K, L] fp32)."""
    B, L, D = ce.shape
    K = hp.shape[1]
    ctx = torch.empty((B, K, D), dtype=ce.dtype, device=ce.device)
    alpha = torch.empty((B, K, L), dtype=torch.float32, device=ce.device)
    if B == 0 or L == 0:
        return ctx, alpha
    err = cuda_lib.library("additive_attention.cu").sat_additive_attention_onepass(
        cuda_lib.ptr(ce), cuda_lib.ptr(f), cuda_lib.ptr(hp), cuda_lib.ptr(watt),
        cuda_lib.ptr(ctx), cuda_lib.ptr(alpha), B, K, L, D, cuda_lib.dtype_code(ce), C, threads,
        cuda_lib.stream(ce.device),
    )
    cuda_lib.check(err, name)
    cuda_lib.count(name, f"onepass{C}")
    return ctx, alpha


def attention_rows(
    ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-row attention on CUDA tensors (ce, f [B, L, D]; hp [B, D];
    watt [D]) by the design ``attention_plan`` picks: (context [B, D], alpha
    [B, L] fp32). Counts the launch under ``additive_attention``, by design
    ``onepass<C>`` or ``direct`` (``launch_attention``, the first kernel)."""
    name = "additive_attention"
    hp3 = hp[:, None, :]
    B, _, L, D = attention_shapes(name, ce, f, hp3, watt)
    design, C, threads = attention_plan(
        B, L, D, ce.element_size(), cuda_lib.vectorizable((D,), ce, f, hp, watt))
    if design == "direct":
        ctx, alpha = launch_attention(name, ce, f, hp3, watt)
    else:
        ctx, alpha = launch_onepass(name, ce, f, hp3, watt, C, threads)
    return ctx[:, 0], alpha[:, 0]


def _attention_forward(ce, f, hp, watt):
    if ce.is_cuda:
        return attention_rows(ce, f, hp, watt)
    return attention_reference(ce, f, hp, watt)


class FusedAttentionFunction(torch.autograd.Function):
    """The chain with the kernel forward (the plain version on CPU tensors)
    and a recompute backward: autograd over ``attention_reference`` on the
    saved ``(ce, f, hp, watt)``, as the JAX package's ``_fused_bwd`` runs
    ``jax.vjp`` over its XLA reference. Cotangents come back in the inputs'
    dtypes."""

    @staticmethod
    def forward(ctx, ce, f, hp, watt):
        ce, f, hp, watt = (t.contiguous() for t in (ce, f, hp, watt))
        ctx.save_for_backward(ce, f, hp, watt)
        return _attention_forward(ce, f, hp, watt)

    @staticmethod
    def backward(ctx, dctx, dalpha):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            outs = [(o, g) for o, g in zip(attention_reference(*ins), (dctx, dalpha)) if o.requires_grad]
            wrt = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], wrt, [g for _, g in outs], allow_unused=True
            ))
        return tuple(next(grads) if n else None for n in need)


def fused_attention(
    ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain for hp [B, D]: the kernel for CUDA tensors, the plain
    version for CPU tensors; through ``FusedAttentionFunction`` when an
    input requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (ce, f, hp, watt)):
        return FusedAttentionFunction.apply(ce, f, hp, watt)
    return _attention_forward(ce, f, hp, watt)


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
