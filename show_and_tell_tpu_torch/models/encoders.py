"""The frozen CNN trunks: VGG16, ResNet-152 and Inception-v3.

- VGG16 (config D) truncated after conv5_2 + ReLU: 224 px images give a
  14x14x512 grid, flattened to [B, 196, 512] patches in NHWC row-major
  order (Show-Attend-Tell's encoder).
- ResNet-152 (bottleneck v1, blocks [3, 8, 36, 3], the stride on the 3x3
  conv) -> a pooled [B, 2048] (Show-and-Tell's encoder).
- Inception-v3 (torchvision's BasicConv2d, BatchNorm eps 1e-3, the branch
  pool an average with ``count_include_pad``) -> a pooled [B, 2048] (the
  scaled Show-and-Tell configuration).

Trees and names are the JAX package's (``models/encoders.py``); conv
weights are [out, in, kh, kw]. The convolutions run NCHW through cuDNN; the
input arrives NHWC, so its NCHW view is channels-last in memory, and the
ResNet and Inception convolutions take their frozen BatchNorm folded in
(``layers.conv_bn``). Each trunk has one wiring definition; Inception's
takes a ``basic=`` hook, how each BasicConv2d node is applied, which the
int8 trunk's calibration replay and forward (``models/quantize.py``) fill.

``frozen_module`` holds a trunk's tree in a module as frozen parameters and
``module_tree`` gives the tree back, so a trunk's state-dict names are its
tree's paths under ``encoder.``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from show_and_tell_tpu_torch.models.layers import (
    avg_pool,
    conv2d,
    conv_bn,
    global_avg_pool,
    init_bn,
    init_conv,
    max_pool,
)

Params = Dict
Gen = Optional[torch.Generator]


def frozen_module(tree) -> nn.Module:
    """A nested dict/list of tensors -> ModuleDict/ModuleList/ParameterDict
    of parameters that do not require grad."""
    if isinstance(tree, list):
        return nn.ModuleList(frozen_module(t) for t in tree)
    if all(torch.is_tensor(v) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})
    return nn.ModuleDict({k: frozen_module(v) for k, v in tree.items()})


def module_tree(m: nn.Module):
    """The inverse of ``frozen_module``: the module's tensors as the tree."""
    if isinstance(m, nn.ModuleList):
        return [module_tree(c) for c in m]
    if isinstance(m, nn.ParameterDict):
        return dict(m.items())
    return {k: module_tree(c) for k, c in m.items()}


# ---------------------------------------------------------------------------
# VGG16 conv trunk (config D), truncated after conv5_2 + ReLU
# ---------------------------------------------------------------------------

_VGG_CHANNELS = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512]
# torchvision ``features`` module indices of the 12 kept convs
_VGG_TORCH_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26]


def init_vgg16(generator: Gen = None, dtype: torch.dtype = torch.float32) -> Params:
    convs = []
    cin = 3
    for ch in _VGG_CHANNELS:
        if ch == "M":
            continue
        convs.append(init_conv(3, 3, cin, ch, generator, dtype))
        cin = ch
    return {"convs": convs}


def vgg16_features(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC) -> feature grid [B, (H/16)*(W/16), 512]."""
    x = images.permute(0, 3, 1, 2)
    ci = 0
    for ch in _VGG_CHANNELS:
        if ch == "M":
            x = max_pool(x, 2, 2)
        else:
            x = torch.relu(conv2d(params["convs"][ci], x, stride=1, padding=1))
            ci += 1
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def from_torch_vgg16(sd: Dict[str, torch.Tensor]) -> Params:
    """A torchvision ``vgg16().state_dict()`` -> trunk params."""
    return {
        "convs": [
            {"w": torch.as_tensor(sd[f"features.{i}.weight"]),
             "b": torch.as_tensor(sd[f"features.{i}.bias"])}
            for i in _VGG_TORCH_IDX
        ]
    }


def to_torch_vgg16(params: Params) -> Dict[str, torch.Tensor]:
    """Trunk params -> a torchvision VGG16 ``features.<i>.*`` state dict on
    the CPU: the inverse of ``from_torch_vgg16``, a file for
    ``load_torch_encoder``."""
    sd: Dict[str, torch.Tensor] = {}
    for conv, i in zip(params["convs"], _VGG_TORCH_IDX):
        sd[f"features.{i}.weight"] = _cpu(conv["w"])
        sd[f"features.{i}.bias"] = _cpu(conv["b"])
    return sd


# ---------------------------------------------------------------------------
# torchvision names, both ways
# ---------------------------------------------------------------------------


def _cpu(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu()


def _t_conv(sd, name) -> Params:
    return {"w": torch.as_tensor(sd[f"{name}.weight"])}


def _t_bn(sd, name) -> Params:
    return {
        "scale": torch.as_tensor(sd[f"{name}.weight"]),
        "bias": torch.as_tensor(sd[f"{name}.bias"]),
        "mean": torch.as_tensor(sd[f"{name}.running_mean"]),
        "var": torch.as_tensor(sd[f"{name}.running_var"]),
    }


def _to_t_conv(p: Params, name: str, out: Dict) -> None:
    out[f"{name}.weight"] = _cpu(p["w"])


def _to_t_bn(p: Params, name: str, out: Dict) -> None:
    out[f"{name}.weight"] = _cpu(p["scale"])
    out[f"{name}.bias"] = _cpu(p["bias"])
    out[f"{name}.running_mean"] = _cpu(p["mean"])
    out[f"{name}.running_var"] = _cpu(p["var"])


# ---------------------------------------------------------------------------
# ResNet-152 (bottleneck v1, blocks [3, 8, 36, 3])
# ---------------------------------------------------------------------------

_RESNET152_BLOCKS = [3, 8, 36, 3]
_RESNET_WIDTHS = [64, 128, 256, 512]


def _init_bottleneck(g: Gen, cin: int, width: int, stride: int, dtype) -> Params:
    p = {
        "conv1": init_conv(1, 1, cin, width, g, dtype, bias=False),
        "bn1": init_bn(width, dtype),
        "conv2": init_conv(3, 3, width, width, g, dtype, bias=False),
        "bn2": init_bn(width, dtype),
        "conv3": init_conv(1, 1, width, width * 4, g, dtype, bias=False),
        "bn3": init_bn(width * 4, dtype),
    }
    if stride != 1 or cin != width * 4:
        p["down_conv"] = init_conv(1, 1, cin, width * 4, g, dtype, bias=False)
        p["down_bn"] = init_bn(width * 4, dtype)
    return p


def init_resnet152(generator: Gen = None, dtype: torch.dtype = torch.float32) -> Params:
    layers: List[List[Params]] = []
    cin = 64
    for li, (n, width) in enumerate(zip(_RESNET152_BLOCKS, _RESNET_WIDTHS)):
        blocks = []
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            blocks.append(_init_bottleneck(generator, cin, width, stride, dtype))
            cin = width * 4
        layers.append(blocks)
    return {
        "stem_conv": init_conv(7, 7, 3, 64, generator, dtype, bias=False),
        "stem_bn": init_bn(64, dtype),
        "layers": layers,
    }


def _bottleneck(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    y = torch.relu_(conv_bn(p["conv1"], p["bn1"], x))
    y = torch.relu_(conv_bn(p["conv2"], p["bn2"], y, stride=stride, padding=1))
    y = conv_bn(p["conv3"], p["bn3"], y)
    if "down_conv" in p:
        x = conv_bn(p["down_conv"], p["down_bn"], x, stride=stride)
    return torch.relu_(y.add_(x))


def resnet152_features(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC, 224 px) -> pooled [B, 2048]."""
    x = images.permute(0, 3, 1, 2)
    x = torch.relu_(conv_bn(params["stem_conv"], params["stem_bn"], x, stride=2, padding=3))
    x = max_pool(x, 3, 2, padding=1)
    for li, blocks in enumerate(params["layers"]):
        for bi, blk in enumerate(blocks):
            x = _bottleneck(blk, x, 2 if (li > 0 and bi == 0) else 1)
    return global_avg_pool(x)


def from_torch_resnet152(sd: Dict[str, torch.Tensor]) -> Params:
    """A torchvision ``resnet152().state_dict()`` -> trunk params."""
    layers = []
    for li, n in enumerate(_RESNET152_BLOCKS, start=1):
        blocks = []
        for bi in range(n):
            pre = f"layer{li}.{bi}"
            blk = {}
            for j in (1, 2, 3):
                blk[f"conv{j}"] = _t_conv(sd, f"{pre}.conv{j}")
                blk[f"bn{j}"] = _t_bn(sd, f"{pre}.bn{j}")
            if f"{pre}.downsample.0.weight" in sd:
                blk["down_conv"] = _t_conv(sd, f"{pre}.downsample.0")
                blk["down_bn"] = _t_bn(sd, f"{pre}.downsample.1")
            blocks.append(blk)
        layers.append(blocks)
    return {"stem_conv": _t_conv(sd, "conv1"), "stem_bn": _t_bn(sd, "bn1"), "layers": layers}


def to_torch_resnet152(params: Params) -> Dict[str, torch.Tensor]:
    """Trunk params -> torchvision ResNet-152 names on the CPU (the trunk's
    keys; no ``fc``): the inverse of ``from_torch_resnet152``."""
    sd: Dict[str, torch.Tensor] = {}
    _to_t_conv(params["stem_conv"], "conv1", sd)
    _to_t_bn(params["stem_bn"], "bn1", sd)
    for li, blocks in enumerate(params["layers"], start=1):
        for bi, blk in enumerate(blocks):
            pre = f"layer{li}.{bi}"
            for j in (1, 2, 3):
                _to_t_conv(blk[f"conv{j}"], f"{pre}.conv{j}", sd)
                _to_t_bn(blk[f"bn{j}"], f"{pre}.bn{j}", sd)
            if "down_conv" in blk:
                _to_t_conv(blk["down_conv"], f"{pre}.downsample.0", sd)
                _to_t_bn(blk["down_bn"], f"{pre}.downsample.1", sd)
    return sd


# ---------------------------------------------------------------------------
# Inception-v3
# ---------------------------------------------------------------------------


def init_inception_v3(generator: Gen = None, dtype: torch.dtype = torch.float32) -> Params:
    def basic(kh, kw, cin, cout):
        return {"conv": init_conv(kh, kw, cin, cout, generator, dtype, bias=False), "bn": init_bn(cout, dtype)}

    p: Params = {
        "Conv2d_1a_3x3": basic(3, 3, 3, 32),
        "Conv2d_2a_3x3": basic(3, 3, 32, 32),
        "Conv2d_2b_3x3": basic(3, 3, 32, 64),
        "Conv2d_3b_1x1": basic(1, 1, 64, 80),
        "Conv2d_4a_3x3": basic(3, 3, 80, 192),
    }
    # InceptionA (Mixed_5b/5c/5d): pool features 32, 64, 64; cin 192, 256, 288
    for name, cin, pf in [("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64), ("Mixed_5d", 288, 64)]:
        p[name] = {
            "branch1x1": basic(1, 1, cin, 64),
            "branch5x5_1": basic(1, 1, cin, 48),
            "branch5x5_2": basic(5, 5, 48, 64),
            "branch3x3dbl_1": basic(1, 1, cin, 64),
            "branch3x3dbl_2": basic(3, 3, 64, 96),
            "branch3x3dbl_3": basic(3, 3, 96, 96),
            "branch_pool": basic(1, 1, cin, pf),
        }
    # InceptionB (Mixed_6a): cin 288
    p["Mixed_6a"] = {
        "branch3x3": basic(3, 3, 288, 384),
        "branch3x3dbl_1": basic(1, 1, 288, 64),
        "branch3x3dbl_2": basic(3, 3, 64, 96),
        "branch3x3dbl_3": basic(3, 3, 96, 96),
    }
    # InceptionC (Mixed_6b..6e): c7 = 128, 160, 160, 192; cin 768
    for name, c7 in [("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)]:
        p[name] = {
            "branch1x1": basic(1, 1, 768, 192),
            "branch7x7_1": basic(1, 1, 768, c7),
            "branch7x7_2": basic(1, 7, c7, c7),
            "branch7x7_3": basic(7, 1, c7, 192),
            "branch7x7dbl_1": basic(1, 1, 768, c7),
            "branch7x7dbl_2": basic(7, 1, c7, c7),
            "branch7x7dbl_3": basic(1, 7, c7, c7),
            "branch7x7dbl_4": basic(7, 1, c7, c7),
            "branch7x7dbl_5": basic(1, 7, c7, 192),
            "branch_pool": basic(1, 1, 768, 192),
        }
    # InceptionD (Mixed_7a): cin 768
    p["Mixed_7a"] = {
        "branch3x3_1": basic(1, 1, 768, 192),
        "branch3x3_2": basic(3, 3, 192, 320),
        "branch7x7x3_1": basic(1, 1, 768, 192),
        "branch7x7x3_2": basic(1, 7, 192, 192),
        "branch7x7x3_3": basic(7, 1, 192, 192),
        "branch7x7x3_4": basic(3, 3, 192, 192),
    }
    # InceptionE (Mixed_7b/7c): cin 1280, 2048
    for name, cin in [("Mixed_7b", 1280), ("Mixed_7c", 2048)]:
        p[name] = {
            "branch1x1": basic(1, 1, cin, 320),
            "branch3x3_1": basic(1, 1, cin, 384),
            "branch3x3_2a": basic(1, 3, 384, 384),
            "branch3x3_2b": basic(3, 1, 384, 384),
            "branch3x3dbl_1": basic(1, 1, cin, 448),
            "branch3x3dbl_2": basic(3, 3, 448, 384),
            "branch3x3dbl_3a": basic(1, 3, 384, 384),
            "branch3x3dbl_3b": basic(3, 1, 384, 384),
            "branch_pool": basic(1, 1, cin, 192),
        }
    return p


def _basic(p: Params, x: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """torchvision BasicConv2d: conv (no bias) -> BatchNorm (eps 1e-3) -> ReLU."""
    return torch.relu_(conv_bn(p["conv"], p["bn"], x, stride, padding, eps=1e-3))


def _branch_pool(p: Params, x: torch.Tensor, basic=_basic) -> torch.Tensor:
    return basic(p["branch_pool"], avg_pool(x, 3, 1, 1))


def _inc_a(p, x, basic=_basic):
    b1 = basic(p["branch1x1"], x)
    b5 = basic(p["branch5x5_2"], basic(p["branch5x5_1"], x), padding=2)
    b3 = basic(p["branch3x3dbl_1"], x)
    b3 = basic(p["branch3x3dbl_2"], b3, padding=1)
    b3 = basic(p["branch3x3dbl_3"], b3, padding=1)
    return torch.cat([b1, b5, b3, _branch_pool(p, x, basic)], dim=1)


def _inc_b(p, x, basic=_basic):
    b3 = basic(p["branch3x3"], x, stride=2)
    bd = basic(p["branch3x3dbl_1"], x)
    bd = basic(p["branch3x3dbl_2"], bd, padding=1)
    bd = basic(p["branch3x3dbl_3"], bd, stride=2)
    return torch.cat([b3, bd, max_pool(x, 3, 2)], dim=1)


def _inc_c(p, x, basic=_basic):
    b1 = basic(p["branch1x1"], x)
    b7 = basic(p["branch7x7_1"], x)
    b7 = basic(p["branch7x7_2"], b7, padding=(0, 3))
    b7 = basic(p["branch7x7_3"], b7, padding=(3, 0))
    bd = basic(p["branch7x7dbl_1"], x)
    bd = basic(p["branch7x7dbl_2"], bd, padding=(3, 0))
    bd = basic(p["branch7x7dbl_3"], bd, padding=(0, 3))
    bd = basic(p["branch7x7dbl_4"], bd, padding=(3, 0))
    bd = basic(p["branch7x7dbl_5"], bd, padding=(0, 3))
    return torch.cat([b1, b7, bd, _branch_pool(p, x, basic)], dim=1)


def _inc_d(p, x, basic=_basic):
    b3 = basic(p["branch3x3_2"], basic(p["branch3x3_1"], x), stride=2)
    b7 = basic(p["branch7x7x3_1"], x)
    b7 = basic(p["branch7x7x3_2"], b7, padding=(0, 3))
    b7 = basic(p["branch7x7x3_3"], b7, padding=(3, 0))
    b7 = basic(p["branch7x7x3_4"], b7, stride=2)
    return torch.cat([b3, b7, max_pool(x, 3, 2)], dim=1)


def _inc_e(p, x, basic=_basic):
    b1 = basic(p["branch1x1"], x)
    b3 = basic(p["branch3x3_1"], x)
    b3 = torch.cat([basic(p["branch3x3_2a"], b3, padding=(0, 1)),
                    basic(p["branch3x3_2b"], b3, padding=(1, 0))], dim=1)
    bd = basic(p["branch3x3dbl_1"], x)
    bd = basic(p["branch3x3dbl_2"], bd, padding=1)
    bd = torch.cat([basic(p["branch3x3dbl_3a"], bd, padding=(0, 1)),
                    basic(p["branch3x3dbl_3b"], bd, padding=(1, 0))], dim=1)
    return torch.cat([b1, b3, bd, _branch_pool(p, x, basic)], dim=1)


def inception_v3_features(params: Params, images: torch.Tensor, basic=_basic) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC, 299 px) -> pooled [B, 2048]. ``basic(node,
    x, stride, padding)`` applies each BasicConv2d node (``padding`` an int or
    (ph, pw)); the int8 trunk passes its own."""
    x = images.permute(0, 3, 1, 2)
    x = basic(params["Conv2d_1a_3x3"], x, stride=2)
    x = basic(params["Conv2d_2a_3x3"], x)
    x = basic(params["Conv2d_2b_3x3"], x, padding=1)
    x = max_pool(x, 3, 2)
    x = basic(params["Conv2d_3b_1x1"], x)
    x = basic(params["Conv2d_4a_3x3"], x)
    x = max_pool(x, 3, 2)
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _inc_a(params[name], x, basic)
    x = _inc_b(params["Mixed_6a"], x, basic)
    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _inc_c(params[name], x, basic)
    x = _inc_d(params["Mixed_7a"], x, basic)
    for name in ("Mixed_7b", "Mixed_7c"):
        x = _inc_e(params[name], x, basic)
    return global_avg_pool(x)


def from_torch_inception_v3(sd: Dict[str, torch.Tensor]) -> Params:
    """A torchvision ``inception_v3().state_dict()`` -> trunk params (the
    auxiliary classifier and ``fc`` are skipped)."""
    p: Params = {}
    blocks: Dict[str, List[str]] = {}
    for key in sd:
        if not key.endswith(".conv.weight"):
            continue
        block, branch = key.split(".")[0], key.split(".")[1]
        if block.startswith("AuxLogits") or block == "fc":
            continue
        if block.startswith("Conv2d"):
            p[block] = {"conv": _t_conv(sd, f"{block}.conv"), "bn": _t_bn(sd, f"{block}.bn")}
        else:
            blocks.setdefault(block, []).append(branch)
    for block, branches in blocks.items():
        p[block] = {
            br: {"conv": _t_conv(sd, f"{block}.{br}.conv"), "bn": _t_bn(sd, f"{block}.{br}.bn")}
            for br in branches
        }
    return p


def to_torch_inception_v3(params: Params) -> Dict[str, torch.Tensor]:
    """Trunk params -> torchvision Inception-v3 names on the CPU: the
    inverse of ``from_torch_inception_v3``."""
    sd: Dict[str, torch.Tensor] = {}
    for block, bp in params.items():
        branches = {"": bp} if "conv" in bp else bp
        for br, cp in branches.items():
            name = f"{block}.{br}" if br else block
            _to_t_conv(cp["conv"], f"{name}.conv", sd)
            _to_t_bn(cp["bn"], f"{name}.bn", sd)
    return sd


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

ENCODERS = {
    "vgg16": (init_vgg16, vgg16_features, from_torch_vgg16, 512),
    "resnet152": (init_resnet152, resnet152_features, from_torch_resnet152, 2048),
    "inception_v3": (init_inception_v3, inception_v3_features, from_torch_inception_v3, 2048),
}


def init_encoder(name: str, generator: Gen = None, dtype: torch.dtype = torch.float32) -> Params:
    return ENCODERS[name][0](generator, dtype)


def encoder_apply(name: str):
    return ENCODERS[name][1]


def encoder_feature_dim(name: str) -> int:
    return ENCODERS[name][3]


def load_torch_encoder(name: str, path: str) -> Params:
    """A torchvision ``state_dict`` of trunk ``name`` saved at ``path`` ->
    trunk params."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return ENCODERS[name][2](sd)
