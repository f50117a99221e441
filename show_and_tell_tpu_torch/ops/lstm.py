"""Fused LSTM cell: the plain PyTorch version and the CUDA kernel's wrapper.

Math (torch gate order i, f, g, o; one fused bias b = b_ih + b_hh):

    z = [x, h] @ W + b            W: [I+H, 4H]
    i, f, o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)
    c' = f*c + i*g;  h' = o*tanh(c')

``lstm_cell`` launches a kernel of ``csrc/lstm_cell.cu`` for CUDA tensors
and runs ``lstm_cell_reference`` for CPU tensors. ``cell_design`` picks the
kernel from the shape, the type and the alignment before the launch: the
Hopper designs fed by TMA for the shapes TMA can take, by batch regime:

- up to ``SKINNY_MAX_B`` rows, ``skinny``, a matrix-vector form that reads
  W once over H / 8 blocks (bf16 and fp32);
- bf16 between the two, up to ``MCAST_MAX_B`` rows, ``mcast``: a cluster
  of four blocks, one per gate, over 64 hidden columns and 64 batch rows,
  that read W's rows 128 bytes at a time and share [x|h]'s tiles by TMA
  multicast, then meet through distributed shared memory for the gates;
- above, ``wgmma`` for bf16 (a GEMM) and ``tf32x3`` for fp32 (three TF32
  products on the tensor cores, at fp32 accuracy; fp32 has no middle form);

and the shared-memory tiled GEMM for the rest. On a CUDA tensor it never
falls back: the launch succeeds or it raises.

``tf32x3`` reads W^T split into TF32 parts (``tf32x3_weight``), made once
per weight version by ``prepared_weight`` and kept beside the weight, out
of any ``state_dict`` (2 x 33.6 MB for the serving model's W). While a CUDA
graph is captured the split is made afresh instead (``fresh_splits``), so
that it is work of the graph and follows the weight at every replay.

Training: when an input requires grad, ``lstm_cell`` goes through
``LSTMCellFunction``, whose forward is that same kernel (or plain cell) and
whose backward recomputes the gates from the saved inputs and forms the
gradients in plain PyTorch. That is the JAX package's own design
(``_fused_cell_bwd``, an XLA recompute; it has no Pallas backward), not a
fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import weakref
from typing import Dict, Optional, Tuple

import torch

from show_and_tell_tpu_torch.obs.profiler import span
from show_and_tell_tpu_torch.ops import cuda_lib

Params = Dict[str, torch.Tensor]

CELL_DESIGNS = ("skinny", "mcast", "wgmma", "tf32x3", "tiled")
H100_SMS = 132
_WGMMA_BM = (64, 128, 192)  # batch rows per block: one to three consumer warpgroups
_WGMMA_BN = 32  # hidden columns per gate per block
# tf32x3: one consumer warpgroup of 64 rows, whose two partial sums and total
# take the registers a second would need
_TF32X3_BM = 64
# skinny: 8 hidden columns of each gate per block (H / 8 blocks, 128 at
# H=1024) and the smallest of these batch tiles that holds B, the largest
# giving B / 64 row blocks above it
_SKINNY_BN = 8
_SKINNY_BT = (8, 16, 32, 64)
# The largest batch that ``skinny`` runs, per type: the crossover of phase 4's
# sweep in chip_smoke.py (NVIDIA H100 80GB HBM3, 700.00 W; ms by name, skinny
# against the design above it, I=1024 and 512, H=1024). bf16: B=64 0.0216
# against wgmma 0.0250 and 0.0189 against 0.0220; B=80 0.0304 against 0.0256
# and 0.0258 against 0.0223. fp32: B=32 0.0313 against tf32x3 0.0586 and
# 0.0254 against 0.0490; B=48 0.0849 against 0.0588 and 0.0665 against 0.0492
# (past 32 rows the FMA path waits on its shared-memory reads of [x|h]).
SKINNY_MAX_B = {torch.bfloat16: 64, torch.float32: 32}
# mcast: 64 batch rows by 64 hidden columns of one gate per block (W's rows
# read 128 bytes at a time), a cluster of the four gates' blocks sharing
# [x|h]'s tiles: 4 x H / 64 blocks per row block, 128 at B = 65-128 and 192
# at B = 129-192 (two blocks per SM fit)
_MCAST_BM = 64
_MCAST_BN = 64
_MCAST_GATES = 4
# The largest bf16 batch that ``mcast`` runs: the crossover to ``wgmma`` of
# phase 4's sweep in chip_smoke.py (NVIDIA H100 80GB HBM3, 700.00 W; ms by
# name, mcast against wgmma and torch.lstm_cell, I=1024 and 512, H=1024).
# B=192 (three row blocks, 48 clusters) 0.0235 against 0.0260 and 0.0267,
# 0.0203 against 0.0225 and 0.0241; B=256 (four: 64 clusters, past the 62
# that fit at once) 0.0359 against 0.0272 and 0.0288, 0.0307 against 0.0234
# and 0.0271. skinny keeps B <= 64, though mcast ran 3-4 % faster at B=48
# and 64 (0.0209 against 0.0217, 0.0213 against 0.0219 at I=1024).
MCAST_MAX_B = 192


def cell_design(
    B: int, I: int, H: int, dtype: torch.dtype, aligned: bool, sms: int = H100_SMS
) -> Tuple[str, int]:
    """Which kernel of ``csrc/lstm_cell.cu`` runs a cell of this shape, and its
    batch rows per block, for operands that are 16-byte ``aligned`` (what TMA
    takes): for bf16 with I and H multiples of 8 and fp32 with I and H
    multiples of 4, ``("skinny", BT)`` up to ``SKINNY_MAX_B[dtype]`` rows,
    bf16 above it ``("mcast", 64)`` up to ``MCAST_MAX_B`` rows and
    ``("wgmma", BM)`` past that, fp32 ``("tf32x3", 64)``; else ``("tiled",
    64)``."""
    if I <= 0 or not aligned:
        return "tiled", 64
    if dtype == torch.float32 and I % 4 == 0 and H % 4 == 0:
        if B <= SKINNY_MAX_B[dtype]:
            return "skinny", skinny_rows(B)
        return "tf32x3", _TF32X3_BM
    if dtype != torch.bfloat16 or I % 8 or H % 8:
        return "tiled", 64
    if B <= SKINNY_MAX_B[dtype]:
        return "skinny", skinny_rows(B)
    if B <= MCAST_MAX_B:
        return "mcast", _MCAST_BM
    return "wgmma", wgmma_rows(B, H, sms)


def skinny_rows(B: int) -> int:
    """The ``skinny`` batch tile: the smallest of 8, 16, 32 and 64 that
    holds B, else 64 (B / 64 row blocks)."""
    return next((t for t in _SKINNY_BT if B <= t), _SKINNY_BT[-1])


def wgmma_rows(B: int, H: int, sms: int = H100_SMS) -> int:
    """The ``wgmma`` BM: the one of 64, 128 and 192 whose blocks fill
    ``sms`` SMs in the fewest rows of work per SM (waves x BM), the larger
    on a tie: the larger the tile, the fewer times W is read. B=768: 192
    (128 blocks, one wave); B=256: 64 (128 blocks)."""
    n_tiles = -(-H // _WGMMA_BN)

    def rows_per_sm(bm: int) -> int:
        blocks = -(-B // bm) * n_tiles
        return -(-blocks // sms) * bm

    return min(_WGMMA_BM, key=lambda bm: (rows_per_sm(bm), -bm))


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds (the low 13 bits zero);
    inf and NaN pass."""
    r = ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(t), r, t)


def tf32x3_weight(w: torch.Tensor) -> torch.Tensor:
    """The ``tf32x3`` kernel's W operand: [2, 4H, I+H] fp32, W^T rounded to
    TF32 (big), then the TF32 rounding of W^T - big (small). W^T because
    ``wgmma`` takes 32-bit operands K-major only."""
    with torch.no_grad():
        wt = w.t().contiguous()
        big = tf32_round(wt)
        return torch.stack([big, tf32_round(wt - big)])


# id(w) -> (weakref to w, its key, tf32x3_weight(w))
_PREPARED: Dict[int, tuple] = {}
# id(w) -> (w, its key, tf32x3_weight(w)) inside ``fresh_splits``, else None
_FRESH: Optional[Dict[int, tuple]] = None


@contextlib.contextmanager
def fresh_splits():
    """Inside, ``prepared_weight`` splits each weight version once for the
    scope and neither reads nor fills the memo. Around the capture of a CUDA
    graph, the split is then work of the graph, made again from the weight
    at every replay, where a memo hit would replay the split of the version
    seen at capture."""
    global _FRESH
    outer, _FRESH = _FRESH, {}
    try:
        yield
    finally:
        _FRESH = outer


def weight_key(w: torch.Tensor) -> tuple:
    """What a prepared copy of ``w`` is valid for: its storage, shape and
    version counter (an in-place update, an optimizer step or a
    ``load_state_dict`` copy, bumps the version)."""
    return w.data_ptr(), tuple(w.shape), w._version


def prepared_weight(w: torch.Tensor) -> torch.Tensor:
    """``tf32x3_weight(w)``, made once per weight version and kept while
    ``w`` lives. An inference tensor has no version counter: it is split at
    every call. Under stream capture it is split at every call too, or once
    per ``fresh_splits`` scope, and the memo is left alone."""
    if w.is_inference():
        return tf32x3_weight(w)
    key = weight_key(w)
    if _FRESH is not None or (w.is_cuda and torch.cuda.is_current_stream_capturing()):
        scope = {} if _FRESH is None else _FRESH
        entry = scope.get(id(w))
        if entry is None or entry[0] is not w or entry[1] != key:
            entry = scope[id(w)] = (w, key, tf32x3_weight(w))
        return entry[2]
    entry = _PREPARED.get(id(w))
    if entry is not None and entry[0]() is w and entry[1] == key:
        return entry[2]

    def forget(ref, i=id(w)):
        if _PREPARED.get(i, (None,))[0] is ref:
            del _PREPARED[i]

    prepared = tf32x3_weight(w)
    _PREPARED[id(w)] = (weakref.ref(w, forget), key, prepared)
    return prepared


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def init_lstm_params(
    input_size: int,
    hidden_size: int,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """U(-1/sqrt(H), 1/sqrt(H)) init (torch nn.LSTM's default)."""
    k = 1.0 / math.sqrt(hidden_size)

    def u(*shape):
        return torch.rand(*shape, generator=generator, dtype=dtype) * (2 * k) - k

    return {"w": u(input_size + hidden_size, 4 * hidden_size), "b": u(4 * hidden_size)}


def lstm_cell_reference(
    params: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version. h comes back in h's dtype, c in c's dtype."""
    hx = torch.cat([x, h], dim=-1)
    z = hx @ params["w"] + params["b"]
    zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
    i = torch.sigmoid(zi)
    f = torch.sigmoid(zf)
    g = torch.tanh(zg)
    o = torch.sigmoid(zo)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def _cell_shapes(params: Params, x, h, c) -> Tuple[int, int, int]:
    """(B, I, H) of checked CUDA operands; raises on what no kernel takes."""
    w, b = params["w"], params["b"]
    what = "lstm_cell"
    cuda_lib.check_operands(what, x.device, x=x, h=h, c=c, w=w, b=b)
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError(f"{what}: x and h must be 2-D, got {tuple(x.shape)}, {tuple(h.shape)}")
    B, I = x.shape
    H = h.shape[1]
    if h.shape[0] != B or tuple(c.shape) != (B, H):
        raise ValueError(f"{what}: batch mismatch x {tuple(x.shape)} h {tuple(h.shape)} c {tuple(c.shape)}")
    if tuple(w.shape) != (I + H, 4 * H) or tuple(b.shape) != (4 * H,):
        raise ValueError(f"{what}: W {tuple(w.shape)} / b {tuple(b.shape)} do not fit I={I}, H={H}")
    if not (x.dtype == h.dtype == w.dtype):
        raise TypeError(f"{what}: x, h, W dtypes differ: {x.dtype}, {h.dtype}, {w.dtype}")
    if b.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"{what}: b and c must be float32, got {b.dtype}, {c.dtype}")
    cuda_lib.dtype_code(x)
    return B, I, H


def _aligned(params: Params, x, h, c, I: int, H: int) -> bool:
    """Whether TMA takes the operands: row lengths of 16-byte multiples and
    every pointer on a 16-byte boundary."""
    w, b = params["w"], params["b"]
    return cuda_lib.vectorizable((I, H), x, h, w) and b.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0


def lstm_cell_cuda(
    params: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused cell kernel that ``cell_design`` picks. x, h and W
    share one dtype (float32 or bfloat16); b and c are float32. Returns (h'
    in h's dtype, c' float32)."""
    B, I, H = _cell_shapes(params, x, h, c)
    aligned = _aligned(params, x, h, c, I, H)
    design, bm = cell_design(B, I, H, x.dtype, aligned, _sm_count(x.device.index or 0))
    return _launch(design, bm, params, x, h, c, B, I, H)


def lstm_cell_by(
    design: str, params: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel of ``design`` by name, whatever the plan says, with the
    tile its own rule gives at this shape: for timing a design beside the
    one the plan picks (``tiled`` beside ``tf32x3``, ``wgmma`` and
    ``tf32x3`` beside ``skinny`` at small batches, ``skinny`` and ``wgmma``
    beside ``mcast``, each past its crossover). Nothing on the main path
    calls it. Raises ValueError where the design does not take the
    shape."""
    B, I, H = _cell_shapes(params, x, h, c)
    if design == "tiled":
        return _launch("tiled", 64, params, x, h, c, B, I, H)
    fp32 = x.dtype == torch.float32
    align = 4 if fp32 else 8
    takes = {"skinny": True, "mcast": not fp32, "wgmma": not fp32, "tf32x3": fp32}
    if design not in takes:
        raise ValueError(f"lstm_cell_by: no design {design!r}; designs {CELL_DESIGNS}")
    if not (takes[design] and I % align == 0 and H % align == 0 and _aligned(params, x, h, c, I, H)):
        raise ValueError(f"lstm_cell_by: {design} does not take B={B} I={I} H={H} {x.dtype}")
    sms = _sm_count(x.device.index or 0)
    bm = {
        "skinny": skinny_rows(B), "mcast": _MCAST_BM, "wgmma": wgmma_rows(B, H, sms),
        "tf32x3": _TF32X3_BM,
    }[design]
    return _launch(design, bm, params, x, h, c, B, I, H)


def mcast_stream(
    params: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``mcast`` kernel's loads alone, for timing its parts: the same
    grid, clusters and TMA ring, with consumers that wait for each stage and
    hand it back without a product. h' and c' are not the cell's. Counted as
    design ``mcast_stream``; nothing on the main path calls it. bf16, the
    shapes ``mcast`` takes; raises on CPU tensors."""
    B, I, H = _cell_shapes(params, x, h, c)
    if x.dtype != torch.bfloat16 or I % 8 or H % 8 or not _aligned(params, x, h, c, I, H):
        raise ValueError(f"mcast_stream: mcast does not take B={B} I={I} H={H} {x.dtype}")
    return _launch("mcast_stream", _MCAST_BM, params, x, h, c, B, I, H)


def mcast_clusters() -> Tuple[int, int]:
    """How many ``mcast`` clusters of four run at once on the current card
    (``cudaOccupancyMaxActiveClusters``): with the kernel's own shared
    memory, two blocks per SM, and with one block per SM's worth. A query,
    not a launch; needs the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("mcast_clusters: the query needs a CUDA card")
    at_two, at_one = ctypes.c_int(0), ctypes.c_int(0)
    err = cuda_lib.library("lstm_cell.cu").sat_lstm_cell_mcast_clusters(
        ctypes.addressof(at_two), ctypes.addressof(at_one))
    cuda_lib.check(err, "mcast_clusters")
    return at_two.value, at_one.value


def _launch(design, bm, params, x, h, c, B, I, H):
    w, b = params["w"], params["b"]
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    if B == 0:
        return h_out, c_out
    lib = cuda_lib.library("lstm_cell.cu")
    stream = cuda_lib.stream(x.device)
    if design == "tf32x3":
        w = prepared_weight(w)
    operands = (
        cuda_lib.ptr(x), cuda_lib.ptr(h), cuda_lib.ptr(w), cuda_lib.ptr(b),
        cuda_lib.ptr(c), cuda_lib.ptr(h_out), cuda_lib.ptr(c_out), B, I, H,
    )
    if design == "skinny":
        err = lib.sat_lstm_cell_skinny(*operands, bm, cuda_lib.dtype_code(x), stream)
    elif design in ("mcast", "mcast_stream"):
        err = lib.sat_lstm_cell_mcast(*operands, int(design == "mcast_stream"), stream)
    elif design == "wgmma":
        err = lib.sat_lstm_cell_sm90(*operands, bm, stream)
    elif design == "tf32x3":
        err = lib.sat_lstm_cell_tf32x3(*operands, stream)
    else:
        vec = int(cuda_lib.vectorizable((I, H), x, h, w))
        err = lib.sat_lstm_cell(*operands, cuda_lib.dtype_code(x), vec, stream)
    cuda_lib.check(err, "lstm_cell")
    cuda_lib.count("lstm_cell", design)
    return h_out, c_out


def _cell_forward(params: Params, x, h, c):
    if x.is_cuda:
        return lstm_cell_cuda(params, x, h, c)
    return lstm_cell_reference(params, x, h, c)


class LSTMCellFunction(torch.autograd.Function):
    """``(w, b, x, h, c) -> (h', c')`` with the kernel forward (the plain
    cell on CPU tensors) and the recompute backward of the JAX package's
    ``_fused_cell_bwd``: the gates from the saved ``(w, b, x, h, c, c')``,
    then ``dz``, ``dz @ w^T``, ``[x, h]^T @ dz`` and the bias sum. Mixed
    dtypes promote to fp32 as JAX promotes them (bf16 W against the fp32
    dz), and the cotangents come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, w, b, x, h, c):
        h_new, c_new = _cell_forward({"w": w, "b": b}, x, h, c)
        ctx.save_for_backward(w, b, x, h, c, c_new)
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        w, b, x, h, c, c_new = ctx.saved_tensors
        I = x.shape[-1]
        hx = torch.cat([x, h], dim=-1)
        z = hx @ w + b
        zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
        i = torch.sigmoid(zi)
        f = torch.sigmoid(zf)
        g = torch.tanh(zg)
        o = torch.sigmoid(zo)
        tc = torch.tanh(c_new)
        do = dh_new * tc
        dc = dc_new + dh_new * o * (1.0 - tc * tc)
        dz = torch.cat(
            [
                dc * g * i * (1.0 - i),
                dc * c * f * (1.0 - f),
                dc * i * (1.0 - g * g),
                do * o * (1.0 - o),
            ],
            dim=-1,
        )
        dc_prev = dc * f
        dhx = dz @ w.to(dz.dtype).t()
        dw = hx.to(dz.dtype).t() @ dz
        db = dz.sum(dim=0)
        return (
            dw.to(w.dtype),
            db.to(b.dtype),
            dhx[:, :I].to(x.dtype),
            dhx[:, I:].to(h.dtype),
            dc_prev.to(c.dtype),
        )


def lstm_cell(
    params: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; through ``LSTMCellFunction`` when an input requires
    grad."""
    w, b = params["w"], params["b"]
    with span("op.lstm_cell"):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (w, b, x, h, c)):
            return LSTMCellFunction.apply(w, b, x, h, c)
        return _cell_forward(params, x, h, c)
