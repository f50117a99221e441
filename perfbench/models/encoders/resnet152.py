"""ResNet-152 (He et al. 2016; bottleneck v1, the stride on the 3x3),
BatchNorm on its running statistics, to the global average pool: [B, 2048].
The reference trunk and one image's FLOPs (``harness.plugins`` says what a
trunk plug-in gives)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCKS = (3, 8, 36, 3)
WIDTHS = (64, 128, 256, 512)


def features(net, x: torch.Tensor) -> torch.Tensor:
    def cbn(x, name, bn, stride=1, padding=0):
        return net.bn(net.conv(x, name, stride, padding, bias=False), bn)

    x = torch.relu(cbn(x, "encoder.stem_conv", "encoder.stem_bn", 2, 3))
    x = F.max_pool2d(x, 3, 2, 1)
    for li, n in enumerate(BLOCKS):
        for bi in range(n):
            p = f"encoder.layers.{li}.{bi}."
            stride = 2 if (li > 0 and bi == 0) else 1
            y = torch.relu(cbn(x, p + "conv1", p + "bn1"))
            y = torch.relu(cbn(y, p + "conv2", p + "bn2", stride, 1))
            y = cbn(y, p + "conv3", p + "bn3")
            if p + "down_conv.w" in net.w:
                x = cbn(x, p + "down_conv", p + "down_bn", stride)
            x = torch.relu(y + x)
    return x.mean(dim=(2, 3))


def flops(cfg) -> float:
    """One image to the pool (multiply-adds count 2)."""
    side = (cfg.crop_size + 2 * 3 - 7) // 2 + 1
    total = 2.0 * side * side * 64 * 3 * 49
    side = (side + 2 - 3) // 2 + 1
    cin = 64
    for li, (n, width) in enumerate(zip(BLOCKS, WIDTHS)):
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
