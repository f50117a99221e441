"""VGG16 conv trunk (config D), truncated after conv5_2 + ReLU.

224 px images give a 14x14x512 grid, flattened to [B, 196, 512] patches in
NHWC row-major order, as in the JAX package. The convolutions run NCHW
through cuDNN; the input arrives NHWC, so its NCHW view is channels-last in
memory.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from show_and_tell_tpu_torch.models.layers import conv2d, init_conv, max_pool

Params = Dict

_VGG_CHANNELS = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512]
# torchvision ``features`` module indices of the 12 kept convs
_VGG_TORCH_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26]


def init_vgg16(
    generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32
) -> Params:
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
