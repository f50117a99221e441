"""The yardstick's arithmetic: published H100 peaks, the least time of a
kernel call from its shapes, and the model FLOPs of the work a window did.

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


# --- model FLOPs (multiply-adds count 2) ----------------------------------------

_VGG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512]


def vgg16_conv5_2_flops(crop: int) -> float:
    """One image through VGG16 to conv5_2."""
    total, cin, side = 0.0, 3, crop
    for ch in _VGG:
        if ch == "M":
            side //= 2
            continue
        total += 2.0 * side * side * ch * cin * 9
        cin = ch
    return total


def resnet152_flops(crop: int) -> float:
    """One image through ResNet-152 (v1, stride on the 3x3) to the pool."""
    side = (crop + 2 * 3 - 7) // 2 + 1
    total = 2.0 * side * side * 64 * 3 * 49
    side = (side + 2 - 3) // 2 + 1
    cin = 64
    for li, (n, width) in enumerate(zip((3, 8, 36, 3), (64, 128, 256, 512))):
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            out_side = (side - 1) // stride + 1
            total += 2.0 * side * side * cin * width  # conv1 1x1
            total += 2.0 * out_side * out_side * width * width * 9  # conv2 3x3
            total += 2.0 * out_side * out_side * width * width * 4  # conv3 1x1
            if stride != 1 or cin != width * 4:
                total += 2.0 * out_side * out_side * cin * width * 4
            cin, side = width * 4, out_side
    return total


def trunk_flops(cfg) -> float:
    if cfg.model == "show_attend_tell":
        return vgg16_conv5_2_flops(cfg.crop_size)
    return resnet152_flops(cfg.crop_size)


def grid(cfg) -> int:
    return (cfg.crop_size // 16) ** 2


def image_flops(cfg, vocab: int) -> float:
    """Once per image before the first word: SAT's ctx_enc and h0, c0;
    Show-and-Tell's projection."""
    E, H = cfg.embed_size, cfg.hidden_size
    if cfg.model == "show_attend_tell":
        L, D = grid(cfg), 512
        return 2.0 * L * D * D + 2 * 2.0 * D * H
    return 2.0 * 2048 * E


def step_flops(cfg, vocab: int) -> float:
    """One decoder step of one row (one word): attention, the cells, the
    head."""
    E, H, V = cfg.embed_size, cfg.hidden_size, vocab
    if cfg.model == "show_attend_tell":
        L, D = grid(cfg), 512
        attention = 2.0 * H * D + 5.0 * L * D
        cell = 2.0 * (E + D + H) * 4 * H
        head = 2.0 * D * E + 2.0 * H * E + 2.0 * E * V
        return attention + cell + head
    cells = sum(2.0 * ((E if i == 0 else H) + H) * 4 * H for i in range(cfg.num_layers))
    return cells + 2.0 * H * V
