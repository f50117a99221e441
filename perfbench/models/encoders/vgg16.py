"""VGG16 (Simonyan and Zisserman 2015, configuration D) to conv5_2 and its
ReLU: the 14 x 14 grid of 512 channels at 224 px that Show-Attend-Tell
attends over (the source's ``features[:-3]``). The reference trunk and one
image's FLOPs (``harness.plugins`` says what a trunk plug-in gives)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512]


def features(net, x: torch.Tensor) -> torch.Tensor:
    """NCHW in, the grid out as [B, H * W, 512] in row-major order."""
    ci = 0
    for ch in PLAN:
        if ch == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = torch.relu(net.conv(x, f"encoder.convs.{ci}", padding=1))
            ci += 1
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def flops(cfg) -> float:
    """One image through the convolutions (multiply-adds count 2)."""
    total, cin, side = 0.0, 3, cfg.crop_size
    for ch in PLAN:
        if ch == "M":
            side //= 2
            continue
        total += 2.0 * side * side * ch * cin * 9
        cin = ch
    return total
