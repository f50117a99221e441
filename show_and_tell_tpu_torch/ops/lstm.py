"""Fused LSTM cell: the plain PyTorch version and the CUDA kernel's wrapper.

Math (torch gate order i, f, g, o; one fused bias b = b_ih + b_hh):

    z = [x, h] @ W + b            W: [I+H, 4H]
    i, f, o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)
    c' = f*c + i*g;  h' = o*tanh(c')

``lstm_cell`` launches a kernel of ``csrc/lstm_cell.cu`` for CUDA tensors
and runs ``lstm_cell_reference`` for CPU tensors. ``cell_design`` picks the
kernel from the shape, the type and the alignment before the launch: the
Hopper design (``wgmma`` fed by TMA) for bf16 shapes that TMA can take, the
shared-memory tiled GEMM for the rest. On a CUDA tensor it never falls back:
the launch succeeds or it raises.

Training: when an input requires grad, ``lstm_cell`` goes through
``LSTMCellFunction``, whose forward is that same kernel (or plain cell) and
whose backward recomputes the gates from the saved inputs and forms the
gradients in plain PyTorch. That is the JAX package's own design
(``_fused_cell_bwd``, an XLA recompute; it has no Pallas backward), not a
fallback.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from show_and_tell_tpu_torch.ops import cuda_lib

Params = Dict[str, torch.Tensor]

CELL_DESIGNS = ("wgmma", "tiled")
H100_SMS = 132
_WGMMA_BM = (64, 128, 192)  # batch rows per block: one to three consumer warpgroups
_WGMMA_BN = 32  # hidden columns per gate per block


def cell_design(
    B: int, I: int, H: int, dtype: torch.dtype, aligned: bool, sms: int = H100_SMS
) -> Tuple[str, int]:
    """Which kernel of ``csrc/lstm_cell.cu`` runs a cell of this shape, and its
    batch rows per block: ``("wgmma", BM)`` for bf16 with I and H multiples of
    8 and 16-byte aligned operands (what TMA takes), else ``("tiled", 64)``.

    BM is the one of 64, 128 and 192 whose blocks fill ``sms`` SMs in the
    fewest rows of work per SM (waves x BM), the larger on a tie: the larger
    the tile, the fewer times W is read. B=768: 192 (128 blocks, one wave);
    B=256: 64 (128 blocks)."""
    if dtype != torch.bfloat16 or I <= 0 or I % 8 or H % 8 or not aligned:
        return "tiled", 64
    n_tiles = -(-H // _WGMMA_BN)

    def rows_per_sm(bm: int) -> int:
        blocks = -(-B // bm) * n_tiles
        return -(-blocks // sms) * bm

    return "wgmma", min(_WGMMA_BM, key=lambda bm: (rows_per_sm(bm), -bm))


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


def lstm_cell_cuda(
    params: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused cell kernel. x, h and W share one dtype (float32 or
    bfloat16); b and c are float32. Returns (h' in h's dtype, c' float32)."""
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
    code = cuda_lib.dtype_code(x)
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    if B == 0:
        return h_out, c_out
    lib = cuda_lib.library("lstm_cell.cu")
    aligned = cuda_lib.vectorizable((I, H), x, h, w) and b.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0
    design, bm = cell_design(B, I, H, x.dtype, aligned, _sm_count(x.device.index or 0))
    operands = (
        cuda_lib.ptr(x), cuda_lib.ptr(h), cuda_lib.ptr(w), cuda_lib.ptr(b),
        cuda_lib.ptr(c), cuda_lib.ptr(h_out), cuda_lib.ptr(c_out), B, I, H,
    )
    if design == "wgmma":
        err = lib.sat_lstm_cell_sm90(*operands, bm, cuda_lib.stream(x.device))
    else:
        vec = int(cuda_lib.vectorizable((I, H), x, h, w))
        err = lib.sat_lstm_cell(*operands, code, vec, cuda_lib.stream(x.device))
    cuda_lib.check(err, what)
    cuda_lib.count(what, design)
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (w, b, x, h, c)):
        return LSTMCellFunction.apply(w, b, x, h, c)
    return _cell_forward(params, x, h, c)
