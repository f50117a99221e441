"""The yardstick's arithmetic: published H100 peaks and the least time of a
kernel call from its shapes. A model's FLOPs are its plug-in's
(``perfbench/models``).

``cell_bound``, ``attention_bound`` and ``_bound`` are frozen copies of
``chip_smoke.py``'s (the kernel table of ``PERF.md`` uses them): each input
is read once and each output written once, the operations at their pipe's
published rate. They return the least milliseconds of one call.
"""

from __future__ import annotations

import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
# tanh, exp and reciprocal on the special-function units: 16 per clock per
# SM, 132 SMs, at the 1.98 GHz boost clock
PEAK_SFU_PER_S = 16 * 132 * 1.98e9
#: the peak that every ``mfu`` metric divides by: dense bf16 tensor cores
MFU_PEAK = PEAK_FLOPS[torch.bfloat16]


def _bound(ops, nbytes, op_dtype, sfu=0.0) -> float:
    """The largest of the bytes at the memory rate, the plain operations at
    their pipe's rate and the special-function operations at theirs (ms)."""
    t_ops = ops / PEAK_FLOPS[op_dtype] * 1e3
    t_sfu = sfu / PEAK_SFU_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_sfu, t_bytes)


def _size(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def cell_bound(B, I, H, dtype) -> float:
    """One LSTM cell call ``(x [B, I], h [B, H], W [I + H, 4H], b, c) ->
    (h', c')``. fp32 at fp32 accuracy runs as three TF32 products (the
    ``tf32x3`` design), counted three times at 495 TFLOP/s."""
    es = _size(dtype)
    flops = 2.0 * B * (I + H) * 4 * H
    nbytes = (B * I + B * H + (I + H) * 4 * H) * es + 4 * H * 4 + B * H * 4  # in: x h W b c
    nbytes += B * H * es + B * H * 4  # out: h' c'
    if dtype != torch.float32:
        return _bound(flops, nbytes, dtype)
    return _bound(3 * flops, nbytes, "tf32")


def attention_bound(B, K, L, D, dtype) -> float:
    """One beam attention call: ce, f [B, L, D], hp [B, K, D], w_att [D] ->
    (context [B, K, D], alpha [B, K, L] fp32)."""
    es = _size(dtype)
    # per (b, k, l, d): an add and a multiply-add for the score and a
    # multiply-add for the context; a tanh per (b, k, l, d) and an exp per
    # (b, k, l) on the special-function units
    ops = 5.0 * B * K * L * D
    sfu = 1.0 * B * K * L * D + B * K * L
    nbytes = (2 * B * L * D + B * K * D + D) * es  # in: ce f hp w_att
    nbytes += B * K * D * es + B * K * L * 4  # out: ctx alpha
    return _bound(ops, nbytes, torch.float32, sfu)


# --- one call of a kernel's entry point, from its arguments -------------------


def lstm_cell_call(params, x, h, c) -> float:
    """``cell_bound`` of one ``ops.lstm.lstm_cell(params, x, h, c)`` call."""
    B, I = x.shape
    return cell_bound(B, I, h.shape[1], x.dtype)


def attention_beam_call(ce, f, hp, w_att, *args, **kw) -> float:
    """``attention_bound`` of one ``ops.fused_decode_attention.attention_beam``
    call: ce, f [B, L, D], hp [B, K, D]."""
    B, L, D = ce.shape
    return attention_bound(B, hp.shape[1], L, D, ce.dtype)
