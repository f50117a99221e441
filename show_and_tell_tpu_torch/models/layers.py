"""Small functional layer library on nested dicts of tensors.

Parameters keep the JAX package's layouts where a public function sees them:
dense weights are [in, out] (``y = x @ w + b``). Convolution weights are in
PyTorch's [out, in, kh, kw] layout and activations are NCHW inside the
trunk (``conv2d``, ``conv_bn``, ``conv_relu``, the pools);
``ckpt/convert.py`` moves the JAX package's HWIO weights across. BatchNorm
parameters are ``{scale, bias, mean, var}``; ``batch_norm_inference`` and
``batch_norm_train`` normalise the last axis, as the JAX package's do.

Under a mesh (``parallel/mesh.py``) the embedding and the output head may
hold this rank's slice of the vocabulary (``embedding_lookup``,
``vocab_dense``), the train-mode BatchNorm takes the statistics of the
global batch, and dropout draws its mask for the global batch.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from show_and_tell_tpu_torch.obs import profiler
from show_and_tell_tpu_torch.parallel import collectives
from show_and_tell_tpu_torch.parallel.mesh import rand_rows

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
    p: Params, x: torch.Tensor, momentum: float = 0.01, eps: float = 1e-5, mesh=None
) -> Tuple[torch.Tensor, Params]:
    """Batch-statistics BatchNorm over all axes but the last: ``(y,
    new_stats)``. The statistics and the normalisation run in fp32 whatever
    x's dtype, y comes back in x's dtype. ``momentum`` is the weight of the
    new statistic (torch's BatchNorm1d convention) and the running variance
    takes the unbiased n / (n - 1) variance. Nothing is written: the caller
    commits ``new_stats``.

    Over a mesh with a data axis > 1 the statistics are the global batch's,
    as one device computes them: the sums and n are summed over the data
    group (the sum, then the squared deviations from the global mean), and
    their gradients flow back to every rank's rows."""
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    n = float(math.prod(x.shape[a] for a in axes))
    if mesh is not None and mesh.data > 1:
        total = collectives.sum_over_data(torch.cat([xf.sum(dim=axes), xf.new_full((1,), n)]), mesh)
        n = float(total[-1].detach())
        mean = total[:-1] / n
        var = collectives.sum_over_data(((xf - mean) ** 2).sum(dim=axes), mesh) / n
    else:
        mean = xf.mean(dim=axes)
        var = xf.var(dim=axes, correction=0)
    inv = torch.rsqrt(var + eps)
    y = ((xf - mean) * inv * p["scale"].float() + p["bias"].float()).to(x.dtype)
    unbiased = var * (n / max(n - 1.0, 1.0))
    new_stats = {
        "scale": p["scale"],
        "bias": p["bias"],
        "mean": (1 - momentum) * p["mean"] + momentum * mean,
        "var": (1 - momentum) * p["var"] + momentum * unbiased,
    }
    return y, new_stats


def folded_conv_bn(conv: Params, bn: Params, x: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frozen BatchNorm folded into a convolution without bias: ``(w,
    shift)``, the weight scaled per output channel in fp32, then cast to x's
    dtype in x's memory format, and the BatchNorm's shift, still in fp32."""
    scale, shift = _bn_affine(bn, eps)
    w = (conv["w"].float() * scale[:, None, None, None]).to(x.dtype)
    if channels_last(x):
        w = w.contiguous(memory_format=torch.channels_last)
    return w, shift


def conv_bn(conv: Params, bn: Params, x: torch.Tensor, stride=1, padding=0, eps: float = 1e-5) -> torch.Tensor:
    """``batch_norm_inference(bn, conv2d(conv, x))`` on NCHW for a conv
    without bias (the ResNet and Inception trunks), with the
    frozen BatchNorm folded into the convolution (``folded_conv_bn``) and
    its shift as the bias. One cuDNN call instead of a convolution and two
    passes over its output; the same function up to rounding."""
    w, shift = folded_conv_bn(conv, bn, x, eps)
    return F.conv2d(x, w, shift.to(x.dtype), stride=stride, padding=padding)


def fuses_epilogue(x: torch.Tensor, *tensors: Optional[torch.Tensor]) -> bool:
    """Whether ``conv_relu`` on these tensors takes cuDNN's fused call: x
    lies on a CUDA card and autograd does not need the call (the fused ops
    have no derivative)."""
    if not x.is_cuda:
        return False
    return not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, *tensors)))


#: what cuDNN's errors say where it has no fused engine for a call: the
#: frontend's "unable to find an engine" and the legacy API's status
_NO_ENGINE = ("unable to find an engine", "CUDNN_STATUS_NOT_SUPPORTED")


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv_relu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride=1, padding=0, z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``relu(conv2d(x, w, b) + z)`` on NCHW (``z``, the residual, optional),
    with w, b and z in x's dtype.

    Where ``fuses_epilogue`` holds, one cuDNN call applies the bias, the
    residual add and the ReLU in the convolution's epilogue, while the
    output is still in registers (``torch.cudnn_convolution_relu``,
    ``torch.cudnn_convolution_add_relu``; both read cuDNN's TF32 setting as
    ``F.conv2d`` does). Elsewhere, and for a call for which cuDNN has no
    fused engine (a ``RuntimeWarning`` names its shapes; any other error
    propagates), the convolution with its bias, then the add and the ReLU
    as passes of their own. Inside a recording (``obs.profiler``) each call
    counts ``trunk.convs``, and ``trunk.fused_convs`` when it fused."""
    fused = fuses_epilogue(x, w, b, z)
    if fused:
        try:
            if z is None:
                y = torch.cudnn_convolution_relu(x, w, b, _pair(stride), _pair(padding), (1, 1), 1)
            else:
                y = torch.cudnn_convolution_add_relu(x, w, z, 1.0, b, _pair(stride), _pair(padding), (1, 1), 1)
        except RuntimeError as e:
            if not any(m in str(e) for m in _NO_ENGINE):
                raise
            warnings.warn(
                f"cuDNN has no fused engine for conv_relu on {x.dtype} {tuple(x.shape)} by {tuple(w.shape)}, "
                f"stride {stride}, padding {padding}, residual {z is not None}: it runs as separate passes",
                RuntimeWarning,
            )
            fused = False
    rec = profiler.active
    if rec is not None:
        rec.counters["trunk.convs"] += 1
        rec.counters["trunk.fused_convs"] += int(fused)
    if fused:
        return y
    y = F.conv2d(x, w, b, stride=stride, padding=padding)
    if z is not None:
        y = y.add_(z)
    return torch.relu_(y)


def prepared(memo: Optional[Dict], key, make: Callable[[], Tuple]) -> Tuple:
    """``make()``, a convolution's weights in the form it takes them. With
    ``memo`` (``encoders.PreparedTrunk``'s, valid for the frozen weights'
    present versions) the result made by the first call under ``key`` is
    kept there and returned to every later one. It is made outside inference
    mode, in the caller's grad mode, so that a copy made under
    ``torch.inference_mode()`` serves a ``no_grad`` call and the other way
    round."""
    if memo is None:
        return make()
    out = memo.get(key)
    if out is None:
        grad = torch.is_grad_enabled()
        with torch.inference_mode(False), torch.set_grad_enabled(grad):
            out = memo[key] = make()
    return out


def channels_last(x: torch.Tensor) -> bool:
    return x.is_contiguous(memory_format=torch.channels_last)


def conv_bn_relu(
    conv: Params, bn: Params, x: torch.Tensor, stride=1, padding=0, eps: float = 1e-5, memo: Optional[Dict] = None,
) -> torch.Tensor:
    """``relu(conv_bn(conv, bn, x))`` through ``conv_relu``; the folded
    weight and its cast shift ``prepared`` in ``memo``, by x's dtype and
    memory format."""

    def make():
        w, shift = folded_conv_bn(conv, bn, x, eps)
        return w, shift.to(x.dtype)

    w, b = prepared(memo, (id(conv["w"]), x.dtype, channels_last(x)), make)
    return conv_relu(x, w, b, stride, padding)


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


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """``table[ids]``. With ``mesh`` (a model axis > 1) ``table`` is this
    rank's slice of the vocabulary's rows: ids outside it give zero rows, and
    the sum over the model group is the full lookup."""
    if mesh is None:
        return F.embedding(ids, table)
    n = table.shape[0]
    local = ids - mesh.model_index * n
    inside = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table) * inside[..., None].to(table.dtype)
    return collectives.reduce_from_model(rows, mesh)


def vocab_dense(p: Params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The output head ``dense(p, x)`` [..., V]. With ``mesh`` (a model axis
    > 1) ``p`` holds this rank's columns of the vocabulary: the input's
    gradient is summed over the model group, and the logits are gathered
    whole."""
    if mesh is None:
        return dense(p, x)
    return collectives.gather_from_model(dense(p, collectives.copy_to_model(x, mesh)), mesh)


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating-point tensor of a nested dict/list to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float, mesh=None) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``; the identity at rate 0 or without a
    generator. The mask comes from ``generator``, which must be on x's
    device; over a mesh it is drawn for the global batch (x's leading
    dimension), this rank's rows kept."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = rand_rows(generator, x.shape, x.device, mesh) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
