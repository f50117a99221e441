"""The control's precision: the reference computed one step below the
configurations' bfloat16. The operands of every product and convolution,
and what each produces, are rounded to float8 (e4m3) under a per-tensor
scale, as a program that computes and stores its tensors in fp8 holds them
(``reference/models.py`` applies it; the cell state c stays float32)."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under its own scale; the gradient passes straight
    through the rounding, as a fake-quantised product's does."""
    with torch.no_grad():
        scale = x.abs().amax().float().clamp(min=1e-30) / E4M3_MAX
        rounded = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - x).detach() if x.requires_grad else rounded
