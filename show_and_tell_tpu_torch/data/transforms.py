"""Device-side eval transform: center crop and ImageNet normalisation of a
uint8 NHWC batch.

The host hands over uint8 images (4x fewer bytes than fp32); the crop and
the normalisation run batched on the device. Input is divided by 255, then
normalised in fp32, then cast to the requested dtype.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8/float [B, H, W, 3] -> normalised [B, H, W, 3]."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def center_crop(images: torch.Tensor, crop: int) -> torch.Tensor:
    _, H, W, _ = images.shape
    top, left = (H - crop) // 2, (W - crop) // 2
    return images[:, top : top + crop, left : left + crop, :]


def eval_transform(
    images_u8: torch.Tensor, crop: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """CenterCrop + Normalize, [B, H, W, 3] uint8 -> [B, crop, crop, 3]."""
    return normalize(center_crop(images_u8, crop), dtype)
