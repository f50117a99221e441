"""Small functional layer library on nested dicts of tensors.

Parameters keep the JAX package's layouts where a public function sees them:
dense weights are [in, out] (``y = x @ w + b``). Convolution weights are in
PyTorch's [out, in, kh, kw] layout and activations are NCHW inside the
trunk (``conv2d``, ``conv_bn``, the pools); ``ckpt/convert.py`` moves the
JAX package's HWIO weights across. BatchNorm parameters are ``{scale, bias,
mean, var}``; ``batch_norm_inference`` and ``batch_norm_train`` normalise
the last axis, as the JAX package's do.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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
    dtype: torch.dtype = torch.float32, bias: bool = True,
) -> Params:
    """Kaiming-normal weight [cout, cin, kh, kw], and a zero bias unless
    ``bias`` is False."""
    std = math.sqrt(2.0 / (kh * kw * cin))
    p = {"w": torch.randn(cout, cin, kh, kw, generator=generator, dtype=dtype) * std}
    if bias:
        p["b"] = torch.zeros(cout, dtype=dtype)
    return p


def init_bn(c: int, dtype: torch.dtype = torch.float32) -> Params:
    return {
        "scale": torch.ones(c, dtype=dtype),
        "bias": torch.zeros(c, dtype=dtype),
        "mean": torch.zeros(c, dtype=dtype),
        "var": torch.ones(c, dtype=dtype),
    }


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


def _bn_affine(p: Params, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frozen statistics as one fp32 multiply-add: (scale, bias)."""
    inv = torch.rsqrt(p["var"].float() + eps)
    scale = p["scale"].float() * inv
    return scale, p["bias"].float() - p["mean"].float() * scale


def batch_norm_inference(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Frozen-statistics BatchNorm over the last axis; the affine is formed
    in fp32 and applied in x's dtype."""
    scale, bias = _bn_affine(p, eps)
    return x * scale.to(x.dtype) + bias.to(x.dtype)


def batch_norm_train(
    p: Params, x: torch.Tensor, momentum: float = 0.01, eps: float = 1e-5
) -> Tuple[torch.Tensor, Params]:
    """Batch-statistics BatchNorm over all axes but the last: ``(y,
    new_stats)``. The statistics and the normalisation run in fp32 whatever
    x's dtype, y comes back in x's dtype. ``momentum`` is the weight of the
    new statistic (torch's BatchNorm1d convention) and the running variance
    takes the unbiased n / (n - 1) variance. Nothing is written: the caller
    commits ``new_stats``."""
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, correction=0)
    inv = torch.rsqrt(var + eps)
    y = ((xf - mean) * inv * p["scale"].float() + p["bias"].float()).to(x.dtype)
    n = float(math.prod(x.shape[a] for a in axes))
    unbiased = var * (n / max(n - 1.0, 1.0))
    new_stats = {
        "scale": p["scale"],
        "bias": p["bias"],
        "mean": (1 - momentum) * p["mean"] + momentum * mean,
        "var": (1 - momentum) * p["var"] + momentum * unbiased,
    }
    return y, new_stats


def conv_bn(conv: Params, bn: Params, x: torch.Tensor, stride=1, padding=0, eps: float = 1e-5) -> torch.Tensor:
    """``batch_norm_inference(bn, conv2d(conv, x))`` on NCHW for a conv
    without bias (the ResNet and Inception trunks), with the
    frozen BatchNorm folded into the convolution: weights scaled per output
    channel in fp32, then cast to x's dtype in x's memory format, and the
    BatchNorm's shift as the bias. One cuDNN call instead of a convolution
    and two passes over its output; the same function up to rounding."""
    scale, bias = _bn_affine(bn, eps)
    w = (conv["w"].float() * scale[:, None, None, None]).to(x.dtype)
    if x.is_contiguous(memory_format=torch.channels_last):
        w = w.contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, bias.to(x.dtype), stride=stride, padding=padding)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, padding)


def avg_pool(
    x: torch.Tensor, window: int, stride: int, padding: int = 0, count_include_pad: bool = True
) -> torch.Tensor:
    """NCHW average pool. ``count_include_pad`` (the default, torchvision
    Inception-v3's branch pool) divides by window² everywhere, else by the
    cells inside the image."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [N, C], the mean over the spatial axes."""
    return x.mean(dim=(2, 3))


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
