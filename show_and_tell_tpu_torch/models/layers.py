"""Small functional layer library on nested dicts of tensors.

Parameters keep the JAX package's layouts where a public function sees them:
dense weights are [in, out] (``y = x @ w + b``). Convolution weights are in
PyTorch's [out, in, kh, kw] layout and activations are NCHW inside the
trunk; ``ckpt/convert.py`` moves the JAX package's HWIO weights across.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict


def uniform_dense(
    nin: int, nout: int, generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    s = 1.0 / math.sqrt(nin)

    def u(*shape):
        return torch.rand(*shape, generator=generator, dtype=dtype) * (2 * s) - s

    return {"w": u(nin, nout), "b": u(nout)}


def init_conv(
    kh: int, kw: int, cin: int, cout: int, generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Kaiming-normal weight [cout, cin, kh, kw] and a zero bias."""
    std = math.sqrt(2.0 / (kh * kw * cin))
    w = torch.randn(cout, cin, kh, kw, generator=generator, dtype=dtype) * std
    return {"w": w, "b": torch.zeros(cout, dtype=dtype)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with w and b cast to x's dtype."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def conv2d(p: Params, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NCHW convolution, weights and bias cast to x's dtype."""
    b = p["b"].to(x.dtype) if "b" in p else None
    return F.conv2d(x, p["w"].to(x.dtype), b, stride=stride, padding=padding)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, padding)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table)


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating-point tensor of a nested dict/list to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``; the identity at rate 0 or without a
    generator. The mask comes from ``generator``, which must be on x's
    device."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
