"""Beam-shared fused decode attention: the CUDA kernels' wrappers, by
variant name, and their plain PyTorch versions.

For K beams that share one image, with per-beam hidden projections
hp [B, K, D]:

    t_k = tanh(ctx_enc + hp_k[:, None, :]);  e_k = t_k . w_att
    alpha_k = softmax(e_k) (fp32);  context_k = (alpha_k . features) / L

Rows are beam-major per image (row ``b*K + j``), so the model passes
``h_proj.reshape(B, K, D)``.

The names are the JAX package's (``VARIANTS``, ``SCORE_VARIANTS``); each
runs one of four kernels, by the design a pure planner picks from the shape,
the type and the alignment (the first kernel, ``direct``, takes the shapes
the newer design does not):

- every ``s*_c*`` name (the default ``s16_cmxu``): the fused kernel of
  ``csrc/decode_attention.cu``, a cluster of ``beam_plan`` blocks per
  image, ce and f read once for all K beams;
- ``grid2``, the (image, beam) grid (``grid2_plan``): ``onepass<C>``, the
  one-pass kernel of ``csrc/additive_attention.cu`` with one row of blocks
  per (image, beam), the beam innermost, ce and f streamed through
  ``cp.async`` rings under a running softmax (the K blocks of an image read
  it close together in time, so the later reads can come from L2); or
  ``direct``, ``csrc/beam_attention.cu``'s block per (image, beam);
- ``st_cmxu``, ``st_cvpu``, on ce transposed to [B, D, L], transposed once
  per call by the wrapper (a caller that decodes many steps can transpose
  once and call ``attention_beam_st``) (``st_plan``): ``cluster<C>``, an
  image over a cluster of C blocks of ``csrc/beam_attention.cu``, each a
  slice of l, lanes along l, ce^T streamed through ``cp.async`` rings in
  8-byte vectors (a row of L=196 bf16 is 392 bytes: no padding) and f by one
  bulk copy, the blocks merged once under a running-softmax rescale; or
  ``direct``, a block per image in three phases;
- ``attention_scores`` (every name of ``SCORE_VARIANTS``): scores only, by
  the design ``scores_plan`` picks (``stream``: a grid of (image, slice of
  L), rows in 16-byte vectors; ``direct``: a block per image, for the shapes
  ``stream`` does not take), and ``attention_beam_hybrid`` adds a plain
  softmax and context.

The score suffixes (``s32``, ``s16``, ``smxu``) and the context suffixes
(``cvpu``, ``cmxu``) name TPU formulations: a lane reduction or an MXU
matmul, an fp32 or a bf16 product. The kernels here take every product and
sum in fp32, so on Hopper they are one function, and the bf16 products and
sums of the TPU's ``s16`` and ``st`` forms are not reproduced. ``block_b``, which
sizes the TPU's VMEM blocks, has no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch

from show_and_tell_tpu_torch.obs.profiler import span
from show_and_tell_tpu_torch.ops import cuda_lib
from show_and_tell_tpu_torch.ops.fused_attention import (
    SMEM_LIMIT, attention_plan, attention_shapes, launch_attention, launch_onepass, row_vectors,
)

# variant = "<score>_<context>": score in {s32, s16, smxu, st}, context in
# {cvpu, cmxu}; "grid2" = the (image, beam) grid
VARIANTS = (
    "s32_cvpu", "smxu_cvpu", "s16_cvpu", "s16_cmxu", "smxu_cmxu", "s32_cmxu",
    "grid2", "st_cmxu", "st_cvpu",
)
SCORE_VARIANTS = ("s32", "s16", "smxu")

# csrc/decode_attention.cu: its barrier area, the largest cluster, the patch
# rows that call for one more block per image, and how a block gets its ce and
# f rows (``Mode`` there); a block's shared memory stays within SMEM_LIMIT
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


SCORE_DESIGNS = ("stream", "direct")
# csrc/beam_attention.cu, the streaming scores kernel: the vectors per lane
# it is built for, the patch rows that call for one more block per image, and
# the threads per block
_STREAM_NV_MAX = 4
_STREAM_ROWS_PER_BLOCK = 28
_STREAM_THREADS = 128


def scores_smem_bytes(K: int, D: int, itemsize: int, threads: int = _STREAM_THREADS) -> int:
    """Shared memory of one block of the streaming scores kernel: each warp's
    ring of rows in flight (8 rows of up to 1 KB, 4 of 2 KB), then hp[b] as
    it is, unless its K * NV vectors per lane stay in registers (at most 8)."""
    nv = row_vectors(D, itemsize)
    ring = (threads // 32) * (4 if nv == 4 else 8) * nv * 512
    return ring + (0 if K * nv <= 8 else K * D * itemsize)


def scores_plan(K: int, L: int, D: int, itemsize: int, aligned: bool) -> Tuple[str, int, int]:
    """(design, S, threads) for the scores kernel: ``stream`` with S blocks
    per image (ceil(L / 28): 7 at L=196) of ``threads`` threads when rows are
    16-byte multiples of at most 128 vectors (D up to 1024 in bf16, 512 in
    fp32) and the operands are ``aligned``; otherwise ``direct``, one block of
    256 threads per image. The tanh sets this kernel's pace, not the bytes,
    so it runs as many short blocks: the more warps an SM holds, the busier
    its special-function units."""
    vec = 16 // itemsize
    if not aligned or D % vec or D > _STREAM_NV_MAX * 32 * vec:
        return "direct", 1, 256
    return "stream", max(1, -(-L // _STREAM_ROWS_PER_BLOCK)), _STREAM_THREADS


def grid2_plan(B: int, K: int, L: int, D: int, itemsize: int, aligned: bool) -> Tuple[str, int, int]:
    """(design, C, threads) for the (image, beam) grid: the per-row
    attention's plan (``attention_plan``) over its B * K rows, since the
    grid runs the one-pass kernel with one row of hp per block row:
    ``onepass`` with C blocks per row (1 at B=256, K=3: 768 rows fill the
    card) for rows of 16-byte multiples and ``aligned`` operands, else
    ``direct``, one block of 256 threads per (image, beam)."""
    return attention_plan(B * K, L, D, itemsize, aligned)


ST_DESIGNS = ("cluster", "direct")
# csrc/beam_attention.cu, the cluster kernel of the transposed form: the
# largest cluster, the ring stages per warp, the 8-byte ce^T vectors per lane
# per stage, the barrier area, and the threads per block
_ST_CLUSTER_MAX = 8
_ST_STAGES = 4
_ST_VECS = 2
_ST_BAR_BYTES = 16
_ST_THREADS = 256


def st_smem_bytes(K: int, L: int, D: int, C: int, itemsize: int) -> int:
    """Shared memory of one block of the transposed form's cluster kernel, C
    blocks per image; the layout of ``st_smem_bytes`` in the source: the
    barriers, the block's rows of f, the ce^T ring (reused by the partial
    scores, then the partial context), hp and w_att, then in fp32 the
    scores, the block's statistics and the cluster's weights."""
    ve = 8 // itemsize  # elements of an 8-byte vector
    Lc = -(-(L // ve) // C) * ve
    nw = _ST_THREADS // 32
    reuse = max(nw * _ST_STAGES * _ST_VECS * 32 * 8, 4 * nw * K * Lc, 4 * K * D)
    return (_ST_BAR_BYTES + Lc * D * itemsize + reuse + (K + 1) * D * itemsize
            + 4 * (K * Lc + 2 * K + K * _ST_CLUSTER_MAX))


def st_plan(K: int, L: int, D: int, itemsize: int, aligned: bool) -> Tuple[str, int]:
    """(design, C) for the transposed form: ``cluster`` with C blocks per
    image when a ce^T row is a multiple of 8 bytes (L a multiple of 4 in
    bf16, of 2 in fp32; L=196 is, unpadded), a row of f a multiple of 16
    bytes, and the operands are ``aligned`` (ce^T to 8 bytes, f, hp and w_att
    to 16); otherwise ``direct``, one block per image. Block r takes Vc =
    ceil(nvec / C) of the image's nvec 8-byte vectors of l, and a warp covers
    R = 32 // Vc rows of ce^T per instruction, so the image costs C *
    ceil(D / 8 / R) warp steps: C is the cluster (1 to 8, every block with
    rows, within shared memory) that costs fewest, the smaller on a tie (5 at
    L=196 in bf16: 10 vectors, 30 of 32 lanes busy)."""
    ve = 8 // itemsize
    if not aligned or L % ve or (D * itemsize) % 16:
        return "direct", 1
    nvec, rows = L // ve, -(-D // (_ST_THREADS // 32))
    best = None
    for C in range(1, min(_ST_CLUSTER_MAX, nvec) + 1):
        vc = -(-nvec // C)
        if vc > 32 or (C - 1) * vc >= nvec or st_smem_bytes(K, L, D, C, itemsize) > SMEM_LIMIT:
            continue
        cost = C * -(-rows // (32 // vc))
        if best is None or cost < best[0]:
            best = (cost, C)
    return ("cluster", best[1]) if best else ("direct", 1)


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
    """Plain version of the scores kernel: e [B, K, L] fp32. ce + hp and its
    tanh are formed in the inputs' dtype, as the JAX kernel's body forms them
    and as the kernel does; the products with w_att and the sum are fp32."""
    t = torch.tanh(ce[:, None, :, :] + hp[:, :, None, :])  # [B, K, L, D]
    return torch.einsum("bkld,d->bkl", t.float(), watt.float())


def attention_beam_st_reference(
    cet: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the transposed form: ce^T [B, D, L]."""
    return attention_beam_reference(cet.transpose(1, 2), f, hp, watt)


def _check_variant(variant: str, names) -> None:
    if variant not in names:
        raise ValueError(f"unknown variant {variant!r}; options: {names}")


def _launch_st(cet, f, hp, watt, dims, design: str, C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the transposed form on checked CUDA tensors of ``dims`` (B, K,
    L, D) by ``design`` (``cluster`` with C blocks per image, or ``direct``)
    and count it under ``attention_beam_st``, by design ``cluster<C>`` or
    ``direct``."""
    name = "attention_beam_st"
    B, K, L, D = dims
    ctx = torch.empty((B, K, D), dtype=f.dtype, device=f.device)
    alpha = torch.empty((B, K, L), dtype=torch.float32, device=f.device)
    if B == 0 or L == 0:
        return ctx, alpha
    lib = cuda_lib.library("beam_attention.cu")
    operands = (cuda_lib.ptr(cet), cuda_lib.ptr(f), cuda_lib.ptr(hp), cuda_lib.ptr(watt),
                cuda_lib.ptr(ctx), cuda_lib.ptr(alpha), B, K, L, D, cuda_lib.dtype_code(f))
    if design == "direct":
        err = lib.sat_attention_beam_st(*operands, cuda_lib.stream(f.device))
    else:
        err = lib.sat_attention_beam_st_cluster(*operands, C, cuda_lib.stream(f.device))
        design = f"cluster{C}"
    cuda_lib.check(err, name)
    cuda_lib.count(name, design)
    return ctx, alpha


def attention_beam_st_direct(
    cet: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transposed form on CUDA tensors by the ``direct`` design (the
    first kernel, a block per image) whatever the shape: what ``st_plan``
    falls back to, and the baseline the cluster design is timed against."""
    dims = attention_shapes("attention_beam_st", cet, f, hp, watt, transposed=True)
    return _launch_st(cet, f, hp, watt, dims, "direct", 1)


def attention_beam_st(
    cet: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transposed form on ce^T [B, D, L]: the kernel for CUDA tensors, by
    the design ``st_plan`` picks, counted under ``attention_beam_st`` by
    design ``cluster<C>`` or ``direct``; the plain version for CPU tensors."""
    if not cet.is_cuda:
        return attention_beam_st_reference(cet, f, hp, watt)
    dims = B, K, L, D = attention_shapes("attention_beam_st", cet, f, hp, watt, transposed=True)
    aligned = cet.data_ptr() % 8 == 0 and cuda_lib.vectorizable((D,), f, hp, watt)
    return _launch_st(cet, f, hp, watt, dims, *st_plan(K, L, D, f.element_size(), aligned))


def attention_beam_grid2(
    ce: torch.Tensor, f: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (image, beam) grid on CUDA tensors by the design ``grid2_plan``
    picks, counted under ``attention_beam_grid2`` by design ``onepass<C>``
    or ``direct`` (``launch_attention``, the first kernel, which also runs
    it by name)."""
    name = "attention_beam_grid2"
    B, K, L, D = attention_shapes(name, ce, f, hp, watt)
    design, C, threads = grid2_plan(B, K, L, D, ce.element_size(), cuda_lib.vectorizable((D,), ce, f, hp, watt))
    if design == "direct":
        return launch_attention(name, ce, f, hp, watt)
    return launch_onepass(name, ce, f, hp, watt, C, threads)


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
    with span("op.attention_beam"):
        if not ce.is_cuda:
            return attention_beam_reference(ce, f, hp, watt)
        if variant == "grid2":
            return attention_beam_grid2(ce, f, hp, watt)
        if variant.startswith("st_"):
            return attention_beam_st(ce.transpose(1, 2).contiguous(), f, hp, watt)
        return attention_beam_cluster(ce, f, hp, watt)


def _scores_shapes(ce, hp, watt) -> Tuple[int, int, int, int]:
    # f is not read; ce stands in for it in the shape check
    return attention_shapes("attention_scores", ce, ce, hp, watt)


def _launch_scores(ce, hp, watt, dims, design: str, S: int, threads: int) -> torch.Tensor:
    """Launch the scores kernel on checked CUDA tensors of ``dims`` (B, K, L,
    D) by ``design`` (``stream`` with S blocks of ``threads`` threads per
    image, or ``direct``) and count it under ``attention_scores``, by design
    ``stream<S>`` or ``direct``."""
    name = "attention_scores"
    B, K, L, D = dims
    e = torch.empty((B, K, L), dtype=torch.float32, device=ce.device)
    if B == 0 or L == 0:
        return e
    lib = cuda_lib.library("beam_attention.cu")
    operands = (cuda_lib.ptr(ce), cuda_lib.ptr(hp), cuda_lib.ptr(watt), cuda_lib.ptr(e), B, K, L, D)
    if design == "direct":
        vec = int(cuda_lib.vectorizable((D,), ce))
        err = lib.sat_attention_scores(*operands, cuda_lib.dtype_code(ce), vec, cuda_lib.stream(ce.device))
    else:
        err = lib.sat_attention_scores_stream(
            *operands, cuda_lib.dtype_code(ce), S, threads, cuda_lib.stream(ce.device))
        design = f"stream{S}"
    cuda_lib.check(err, name)
    cuda_lib.count(name, design)
    return e


def attention_scores_direct(ce: torch.Tensor, hp: torch.Tensor, watt: torch.Tensor) -> torch.Tensor:
    """The scores on CUDA tensors by the ``direct`` design (the first kernel,
    a block per image) whatever the shape: what ``scores_plan`` falls back
    to, and the baseline the streaming design is timed against."""
    return _launch_scores(ce, hp, watt, _scores_shapes(ce, hp, watt), "direct", 1, 256)


def attention_scores(
    ce: torch.Tensor,  # [B, L, D]
    hp: torch.Tensor,  # [B, K, D]
    watt: torch.Tensor,  # [D]
    variant: str = "s16",
) -> torch.Tensor:
    """Raw scores ``e [B, K, L]`` fp32 = tanh(ce + hp_k) . watt: the kernel
    for CUDA tensors, by the design ``scores_plan`` picks, counted under
    ``attention_scores`` by design ``stream<S>`` or ``direct``; the plain
    version for CPU tensors."""
    _check_variant(variant, SCORE_VARIANTS)
    if not ce.is_cuda:
        return attention_scores_reference(ce, hp, watt)
    dims = B, K, L, D = _scores_shapes(ce, hp, watt)
    plan = scores_plan(K, L, D, ce.element_size(), cuda_lib.vectorizable((D,), ce, hp, watt))
    return _launch_scores(ce, hp, watt, dims, *plan)


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
