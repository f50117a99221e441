"""Int8 post-training quantization of the frozen trunk (the JAX package's
``models/quantize.py``, function for function, with its tree keys).

The trunk is frozen, so its convolutions quantize once after training:

- weights: symmetric per output channel, ``sw[co] = max(absmax / 127,
  1e-12)``, ``wq = clip(round(w / sw), -127, 127)`` in int8;
- activations: one static scale per conv input, calibrated on real images
  with 1.1 headroom, ``xq = clip(round(x / sx), -127, 127)``;
- the first conv (VGG16's conv0, ResNet-152's 7x7 stem, Inception-v3's
  ``Conv2d_1a_3x3``) stays in fp32: its input is the image;
- ResNet-152's and Inception-v3's frozen BatchNorms fold into their convs
  (eps 1e-5 and 1e-3) before the weights quantize.

Trees: VGG16 ``{"conv0", "qconvs": [...]}``, ResNet-152 ``{"stem_conv",
"stem_bn", "qlayers": [[{"q1", "q2", "q3"[, "qdown"]}]]}``, Inception-v3
``{"qinception": <the trunk's tree, each BasicConv2d node int8>}``; an int8
conv is ``{"wq", "sw", "sx", "b"}``. ``wq`` keeps the JAX package's HWIO
shape [kh, kw, ci, co], laid out so that its [kh*kw*ci, co] reshape is the
column-major operand of the GEMM; the float convs keep the port's
[co, ci, kh, kw].

The int8 conv (``_qconv_s``) is the JAX package's int8
``conv_general_dilated`` with an int32 accumulator: the activation is
quantized, the kh*kw strided slices of its zero-padded NHWC copy are
stacked into a [B*Ho*Wo, kh*kw*ci] int8 matrix (zero padding is exact in
the quantized domain; the copies move the channels packed eight to a
word), ``torch._int_mm`` multiplies it by ``wq`` into int32 (on the card
cuBLASLt's int8 tensor-core GEMM, on the CPU exact), and the epilogue is
``y * (sx * sw) + b`` in fp32. Images go through in chunks, so
that the im2col matrix stays under ``_IM2COL_BYTES``. A quantized layer never
runs as a float conv, and a failed GEMM raises. The int8 trunk runs and
returns fp32 whatever the model's compute dtype, as the JAX package's does.

Calibrated trees persist through ``save_quantized`` (``torch.save``, written
atomically) and ``load_quantized``, which also reads a tree that the JAX
package's ``save_quantized`` wrote (flax msgpack, told apart by content).
"""

from __future__ import annotations

import os
import zipfile
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from show_and_tell_tpu_torch.data.transforms import eval_transform
from show_and_tell_tpu_torch.models import encoders
from show_and_tell_tpu_torch.models.layers import conv2d, conv_bn, global_avg_pool, max_pool

Params = Dict

_QMAX = 127.0
QUANTIZABLE_ENCODERS = ("vgg16", "resnet152", "inception_v3")
_BN_EPS = 1e-5
_INCEPTION_BN_EPS = 1e-3
#: the largest im2col matrix of one chunk of images, in bytes
_IM2COL_BYTES = 1 << 30
#: cuBLASLt's int8 GEMM takes more than 16 rows (``torch._int_mm``); a
#: shorter matrix is padded with zero rows
_MIN_ROWS = 17
#: int8 GEMMs run ("int_mm") and, of them, those padded to ``_MIN_ROWS``
#: rows ("padded")
GEMMS: Counter = Counter()


def is_quantized(frozen) -> bool:
    return isinstance(frozen, dict) and ("qconvs" in frozen or "qlayers" in frozen or "qinception" in frozen)


def _quantized_kind(q: Params) -> str:
    if "qlayers" in q:
        return "resnet152"
    if "qinception" in q:
        return "inception_v3"
    return "vgg16"


def _scale(absmax: float, headroom: float) -> float:
    """The activation scale, in float64 as the JAX package computes it."""
    return absmax * headroom / _QMAX


def _scalar(v: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(max(v, 1e-12)), device=device)


# ---------------------------------------------------------------------------
# the int8 conv
# ---------------------------------------------------------------------------


def _gemm_weight(wq: torch.Tensor) -> torch.Tensor:
    """``wq`` [kh, kw, ci, co] -> the [kh*kw*ci, co] column-major operand."""
    kh, kw, ci, co = wq.shape
    wm = wq.reshape(kh * kw * ci, co)
    return wm if wm.stride(0) == 1 else wm.t().contiguous().t()


def gemm_layout(wq: torch.Tensor) -> torch.Tensor:
    """An HWIO int8 weight, laid out as ``_gemm_weight`` reads it (memory
    [co, kh, kw, ci])."""
    return wq.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def _wide(xq: torch.Tensor) -> torch.Tensor:
    """An int8 NHWC tensor viewed with its channels packed into the widest
    integer that divides them (8 int8 into one int64 where ``ci % 8 == 0``):
    the padding copy and the im2col move whole words, not bytes."""
    ci = xq.shape[-1]
    for dtype, size in ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2)):
        if ci % size == 0:
            return xq.view(dtype)
    return xq


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    GEMMS["int_mm"] += 1
    m = a.shape[0]
    if m >= _MIN_ROWS:
        return torch._int_mm(a, b)
    GEMMS["padded"] += 1
    return torch._int_mm(torch.cat([a, a.new_zeros(_MIN_ROWS - m, a.shape[1])]), b)[:m]


def _qconv_s(q: Params, x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
    """x [B, C, H, W] float (in the trunks an NCHW view of channels-last
    memory) -> int8 conv -> int32 -> fp32 ``y * (sx * sw) + b``, returned as
    an NCHW view of NHWC memory. ``padding`` is an int or (ph, pw)."""
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    kh, kw, ci, co = q["wq"].shape
    k = kh * kw * ci
    if k % 8 or co % 8:
        raise ValueError(f"int8 conv {kh}x{kw}x{ci}->{co}: the GEMM needs K and N multiples of 8")
    b, c, h, w = x.shape
    assert c == ci, (c, ci)
    ho, wo = (h + 2 * ph - kh) // stride + 1, (w + 2 * pw - kw) // stride + 1
    wm = _gemm_weight(q["wq"])
    scale = q["sx"] * q["sw"]
    x = x.permute(0, 2, 3, 1)
    out = torch.empty((b, ho, wo, co), dtype=torch.float32, device=x.device)
    step = max(1, _IM2COL_BYTES // (ho * wo * k))
    for i in range(0, b, step):
        t = torch.div(x[i : i + step].float(), q["sx"])
        xq = _wide(t.round_().clamp_(-_QMAX, _QMAX).to(torch.int8).contiguous())
        n = xq.shape[0]
        if ph or pw:
            padded = xq.new_zeros((n, h + 2 * ph, w + 2 * pw, xq.shape[-1]))
            padded[:, ph : ph + h, pw : pw + w] = xq
            xq = padded
        if kh == kw == 1:
            a = xq[:, ::stride, ::stride].contiguous()
        else:
            cols = [xq[:, r : r + stride * (ho - 1) + 1 : stride, s : s + stride * (wo - 1) + 1 : stride]
                    for r in range(kh) for s in range(kw)]
            a = torch.stack(cols, dim=3)
        a = a.view(torch.int8).reshape(n * ho * wo, k)
        o = out[i : i + n].view(n * ho * wo, co)
        torch.mul(_int_mm(a, wm), scale, out=o)
        o.add_(q["b"])
    return out.permute(0, 3, 1, 2)


def _qconv(q: Params, x: torch.Tensor) -> torch.Tensor:
    """VGG's 3x3, stride 1, padding 1 case of ``_qconv_s``."""
    return _qconv_s(q, x, stride=1, padding=1)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _fold_conv_bn(conv: Params, bn: Params, eps: float = _BN_EPS) -> Params:
    """BN(conv(x) + b_conv) as one conv: ``w * s`` and ``(b_conv - mean) * s
    + bias`` with ``s = scale / sqrt(var + eps)``, in fp32 in the JAX
    package's order (a bias-free conv folds a zero bias). The square root
    is taken in fp64 and rounded to fp32, which is the correctly rounded
    fp32 root that numpy gives; torch's vectorised fp32 root on the CPU can
    sit one ulp off it."""
    w = conv["w"].detach().float()
    s = bn["scale"].float() / torch.sqrt((bn["var"].float() + eps).double()).float()
    b_conv = conv["b"].float() if "b" in conv else torch.zeros((), device=w.device)
    b = (b_conv - bn["mean"].float()) * s + bn["bias"].float()
    return {"w": w * s[:, None, None, None], "b": b.detach()}


def _quant_folded(folded: Params, sx: float) -> Params:
    w = folded["w"]  # [co, ci, kh, kw]
    sw = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / _QMAX, 1e-12)
    wq = torch.clamp(torch.round(w / sw[:, None, None, None]), -_QMAX, _QMAX).to(torch.int8)
    return {"wq": gemm_layout(wq.permute(2, 3, 1, 0)), "sw": sw, "sx": _scalar(sx, w.device), "b": folded["b"]}


def _float(tree):
    """A float part of a quantized tree: the model's tensors, detached."""
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tree.detach()


def _absmax(tracked: List[torch.Tensor]) -> List[float]:
    """The calibration replay's per-conv input absmax, in one read."""
    return torch.stack(tracked).tolist()


# ---------------------------------------------------------------------------
# VGG16
# ---------------------------------------------------------------------------


@torch.no_grad()
def _collect_vgg_conv_inputs(frozen: Params, images: torch.Tensor) -> List[float]:
    """Per-conv input absmax over a calibration batch (fp32 trunk replay)."""
    tracked = []
    x = images.permute(0, 3, 1, 2)
    ci = 0
    for ch in encoders._VGG_CHANNELS:
        if ch == "M":
            x = max_pool(x, 2, 2)
        else:
            tracked.append(x.abs().amax())
            x = torch.relu(conv2d(frozen["convs"][ci], x, stride=1, padding=1))
            ci += 1
    return _absmax(tracked)


@torch.no_grad()
def quantize_vgg16(frozen: Params, calib_images: torch.Tensor, headroom: float = 1.1) -> Params:
    """The fp32 VGG16 trunk and calibration images (normalised NHWC, what
    ``backbone_features`` takes) -> ``{"conv0", "qconvs"}``."""
    absmax = _collect_vgg_conv_inputs(frozen, calib_images.float())
    qconvs = []
    for i, conv in enumerate(frozen["convs"]):
        if i == 0:
            continue  # conv0 stays float
        w, b = conv["w"].detach().float(), conv["b"].detach().float()
        qconvs.append(_quant_folded({"w": w, "b": b}, _scale(absmax[i], headroom)))
    return {"conv0": _float(frozen["convs"][0]), "qconvs": qconvs}


@torch.no_grad()
def vgg16_features_q(qparams: Params, images: torch.Tensor) -> torch.Tensor:
    """The int8 mirror of ``encoders.vgg16_features``: [B, (H/16)*(W/16), 512]
    fp32."""
    x = torch.relu(conv2d(qparams["conv0"], images.float().permute(0, 3, 1, 2), stride=1, padding=1))
    qi = 0
    first = True
    for ch in encoders._VGG_CHANNELS:
        if ch == "M":
            x = max_pool(x, 2, 2)
        elif first:
            first = False  # conv0 ran above
        else:
            x = torch.relu_(_qconv(qparams["qconvs"][qi], x))
            qi += 1
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


# ---------------------------------------------------------------------------
# ResNet-152: BatchNorm folding and the same recipe; the 7x7 stem stays float
# ---------------------------------------------------------------------------


@torch.no_grad()
def _collect_resnet(frozen: Params, images: torch.Tensor) -> List[float]:
    tracked = []

    def track(x):
        tracked.append(x.abs().amax())
        return x

    x = images.permute(0, 3, 1, 2)
    x = torch.relu_(conv_bn(frozen["stem_conv"], frozen["stem_bn"], x, stride=2, padding=3))
    x = max_pool(x, 3, 2, padding=1)
    for li, blocks in enumerate(frozen["layers"]):
        for bi, blk in enumerate(blocks):
            stride = 2 if (li > 0 and bi == 0) else 1
            y = torch.relu_(conv_bn(blk["conv1"], blk["bn1"], track(x)))
            y = torch.relu_(conv_bn(blk["conv2"], blk["bn2"], track(y), stride=stride, padding=1))
            y = conv_bn(blk["conv3"], blk["bn3"], track(y))
            if "down_conv" in blk:
                x = conv_bn(blk["down_conv"], blk["down_bn"], track(x), stride=stride)
            x = torch.relu_(y.add_(x))
    return _absmax(tracked)


@torch.no_grad()
def quantize_resnet152(frozen: Params, calib_images: torch.Tensor, headroom: float = 1.1) -> Params:
    """The fp32 ResNet-152 trunk -> ``{"stem_conv", "stem_bn", "qlayers"}``,
    each conv folded with its BatchNorm (the stem stays float)."""
    absmax = iter(_collect_resnet(frozen, calib_images.float()))

    def quant(conv, bn):
        return _quant_folded(_fold_conv_bn(conv, bn), _scale(next(absmax), headroom))

    qlayers = []
    for blocks in frozen["layers"]:
        qblocks = []
        for blk in blocks:
            qb = {"q1": quant(blk["conv1"], blk["bn1"]), "q2": quant(blk["conv2"], blk["bn2"]),
                  "q3": quant(blk["conv3"], blk["bn3"])}
            if "down_conv" in blk:
                qb["qdown"] = quant(blk["down_conv"], blk["down_bn"])
            qblocks.append(qb)
        qlayers.append(qblocks)
    return {"stem_conv": _float(frozen["stem_conv"]), "stem_bn": _float(frozen["stem_bn"]), "qlayers": qlayers}


@torch.no_grad()
def resnet152_features_q(qparams: Params, images: torch.Tensor) -> torch.Tensor:
    """The int8 mirror of ``encoders.resnet152_features``: [B, 2048] fp32."""
    x = images.float().permute(0, 3, 1, 2)
    x = torch.relu_(conv_bn(qparams["stem_conv"], qparams["stem_bn"], x, stride=2, padding=3))
    x = max_pool(x, 3, 2, padding=1)
    for li, blocks in enumerate(qparams["qlayers"]):
        for bi, qb in enumerate(blocks):
            stride = 2 if (li > 0 and bi == 0) else 1
            y = torch.relu_(_qconv_s(qb["q1"], x))
            y = torch.relu_(_qconv_s(qb["q2"], y, stride=stride, padding=1))
            y = _qconv_s(qb["q3"], y)
            if "qdown" in qb:
                x = _qconv_s(qb["qdown"], x, stride=stride)
            x = torch.relu_(y.add_(x))
    return global_avg_pool(x)


# ---------------------------------------------------------------------------
# Inception-v3: every BasicConv2d node but the stem, through the trunk's own
# wiring (``encoders.inception_v3_features``'s ``basic`` hook)
# ---------------------------------------------------------------------------


@torch.no_grad()
def quantize_inception_v3(frozen: Params, calib_images: torch.Tensor, headroom: float = 1.1) -> Params:
    """The fp32 Inception-v3 trunk -> ``{"qinception": <mirrored tree>}``.

    One replay of the real wiring records each BasicConv2d node's input
    absmax in the order the nodes run; the scales map back to the nodes by
    identity, so ``frozen`` must be the one tree object walked both times."""
    order: list = []
    tracked: list = []

    def tracking(node, x, stride=1, padding=0):
        order.append(node)
        tracked.append(x.abs().amax())
        return _float_basic(node, x, stride, padding)

    encoders.inception_v3_features(frozen, calib_images.float(), basic=tracking)
    absmax = _absmax(tracked)
    assert len(order) == len(absmax), (len(order), len(absmax))
    scale_of = {id(n): _scale(a, headroom) for n, a in zip(order, absmax)}
    stem = frozen["Conv2d_1a_3x3"]

    def qmap(node):
        if isinstance(node, dict) and "conv" in node and "bn" in node:
            if node is stem:
                return {"conv": _float(node["conv"]), "bn": _float(node["bn"])}  # float stem
            return _quant_folded(_fold_conv_bn(node["conv"], node["bn"], eps=_INCEPTION_BN_EPS), scale_of[id(node)])
        return {k: qmap(v) for k, v in node.items()}

    return {"qinception": qmap(frozen)}


def _float_basic(node: Params, x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
    """A float BasicConv2d as separate passes (``conv_bn``, then ReLU): the
    int8 trunk keeps them out of cuDNN's fused epilogue."""
    return torch.relu_(conv_bn(node["conv"], node["bn"], x, stride, padding, eps=_INCEPTION_BN_EPS))


def _qbasic(node: Params, x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
    """An int8 BasicConv2d: the folded int8 conv, the rescale, ReLU. The
    float stem falls through to ``_float_basic``."""
    if "wq" not in node:
        return _float_basic(node, x, stride, padding)
    return torch.relu_(_qconv_s(node, x, stride=stride, padding=padding))


@torch.no_grad()
def inception_v3_features_q(qparams: Params, images: torch.Tensor) -> torch.Tensor:
    """The int8 mirror of ``encoders.inception_v3_features``: the same wiring
    with ``_qbasic``; [B, 2048] fp32."""
    return encoders.inception_v3_features(qparams["qinception"], images.float(), basic=_qbasic)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def quantize_backbone(encoder_name: str, frozen: Params, calib_images: torch.Tensor) -> Params:
    """The calibration by trunk name, as serving, the Trainer and
    ``cli.evaluate`` call it."""
    if encoder_name == "vgg16":
        return quantize_vgg16(frozen, calib_images)
    if encoder_name == "resnet152":
        return quantize_resnet152(frozen, calib_images)
    if encoder_name == "inception_v3":
        return quantize_inception_v3(frozen, calib_images)
    raise ValueError(f"no int8 recipe for encoder {encoder_name!r}")


def backbone_features_q(qparams: Params, images: torch.Tensor) -> torch.Tensor:
    fn = {
        "resnet152": resnet152_features_q,
        "inception_v3": inception_v3_features_q,
        "vgg16": vgg16_features_q,
    }[_quantized_kind(qparams)]
    return fn(qparams, images)


def to_device(tree, device):
    """A quantized tree's tensors on ``device`` (their layouts kept)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def needs_calibration(model, cfg) -> bool:
    """Whether ``model`` is to run an int8 trunk (``cfg.quantize_backbone``
    and a trunk with a recipe) that it does not hold yet."""
    return cfg.quantize_backbone and model.encoder_name in QUANTIZABLE_ENCODERS and model.quantized is None


def calibrate_model(model, cfg, images_u8: torch.Tensor) -> None:
    """Set ``model.quantized``: the int8 trunk calibrated on the first 32 of
    ``images_u8`` ([N, H, W, 3] uint8 on the model's device) through the eval
    transform, or read from ``cfg.quantized_backbone_path`` when that file
    exists. The Captioner, the Trainer and ``cli.evaluate`` call this."""
    calib = eval_transform(images_u8[:32], cfg.crop_size)
    model.quantized = obtain_quantized(model.encoder_name, model.frozen_tree(), calib,
                                       path=cfg.quantized_backbone_path)


def obtain_quantized(encoder_name: str, frozen: Params, calib_images: torch.Tensor, path=None) -> Params:
    """The tree at ``path`` when that file exists (on the calibration
    images' device), else a calibration on ``calib_images``, saved to
    ``path`` when one is given: so every replica shares one calibration
    (``Config.quantized_backbone_path``). A file calibrated for another
    trunk raises."""
    if path and os.path.exists(path):
        q = load_quantized(path)
        kind = _quantized_kind(q)
        if kind != encoder_name:
            raise ValueError(
                f"quantized tree at {path} was calibrated for {kind}, but this model's encoder is "
                f"{encoder_name}; delete the file or point quantized_backbone_path elsewhere"
            )
        return to_device(q, calib_images.device)
    q = quantize_backbone(encoder_name, frozen, calib_images)
    if path:
        save_quantized(path, q)
    return q


def save_quantized(path: str, qparams: Params) -> None:
    """``torch.save`` of the tree on the CPU, written to ``path + ".tmp"``
    and renamed: a replica that starts meanwhile never reads a torn file."""
    tmp = path + ".tmp"
    torch.save(to_device(qparams, "cpu"), tmp)
    os.replace(tmp, path)


def load_quantized(path: str) -> Params:
    """A tree written by ``save_quantized``, or by the JAX package's (flax
    msgpack, converted by ``ckpt.convert.from_jax_quantized``), on the CPU."""
    if zipfile.is_zipfile(path):
        q = torch.load(path, map_location="cpu", weights_only=True)
    else:
        from show_and_tell_tpu_torch.ckpt.convert import from_jax_quantized
        from show_and_tell_tpu_torch.ckpt.jax_msgpack import read_msgpack

        q = from_jax_quantized(read_msgpack(path))
    if not is_quantized(q):
        raise ValueError(f"{path} is not a quantized backbone tree")
    return q


def _cosine(f: np.ndarray, g: np.ndarray) -> float:
    f2 = f.reshape(-1, f.shape[-1])
    g2 = g.reshape(-1, g.shape[-1])
    num = (f2 * g2).sum(-1)
    den = np.linalg.norm(f2, axis=-1) * np.linalg.norm(g2, axis=-1) + 1e-9
    return float(np.mean(num / den))


@torch.no_grad()
def feature_agreement(frozen: Params, qparams: Params, images: torch.Tensor) -> float:
    """Mean cosine between the fp32 trunk's features and the int8 trunk's,
    by the quantized tree's kind."""
    f32_fn = encoders.encoder_apply(_quantized_kind(qparams))
    f = f32_fn(frozen, images.float()).float().cpu().numpy()
    g = backbone_features_q(qparams, images).float().cpu().numpy()
    return _cosine(f, g)
