"""Device-side image transforms of a uint8 NHWC batch: crops, flips,
bilinear resize and ImageNet normalisation.

The host hands over uint8 images (4x fewer bytes than fp32); everything
here runs batched on the device, with no Python loop over the images. Input
is divided by 255, then normalised in fp32, then cast to the requested
dtype. The random crop and flip draw from an explicit ``torch.Generator`` on
the images' device; its numbers differ from the JAX package's keys, so the
two are compared on properties, not values. Over a mesh they are drawn for
the global batch and each rank keeps its rows' (``parallel.mesh.rand_rows``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from show_and_tell_tpu_torch.parallel.mesh import rand_rows

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


def random_crop_flip(generator: torch.Generator, images: torch.Tensor, crop: int, mesh=None) -> torch.Tensor:
    """Per-image random crop and horizontal flip, [B, H, W, C] ->
    [B, crop, crop, C], as one gather. ``images`` are this rank's rows of
    the global batch over ``mesh``."""
    B, H, W, _ = images.shape
    dev = images.device
    tops = rand_rows(generator, (B,), dev, mesh, 0, H - crop + 1)
    lefts = rand_rows(generator, (B,), dev, mesh, 0, W - crop + 1)
    flips = rand_rows(generator, (B,), dev, mesh) < 0.5
    ar = torch.arange(crop, device=dev)
    rows = tops[:, None] + ar
    cols = lefts[:, None] + torch.where(flips[:, None], crop - 1 - ar, ar)
    b = torch.arange(B, device=dev)[:, None, None]
    return images[b, rows[:, :, None], cols[:, None, :]]


def train_transform(
    generator: torch.Generator, images_u8: torch.Tensor, crop: int,
    dtype: torch.dtype = torch.float32, mesh=None,
) -> torch.Tensor:
    """RandomCrop + HFlip + Normalize, [B, H, W, 3] uint8 -> [B, crop, crop, 3]."""
    return normalize(random_crop_flip(generator, images_u8, crop, mesh), dtype)


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """Batched bilinear resize to size x size, [B, H, W, C] -> fp32
    [B, size, size, C], keeping the input's value range. Half-pixel centres
    and an antialiasing triangle filter when shrinking, as
    ``jax.image.resize(method="bilinear")``."""
    x = images.float().permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def resize_transform(
    images: torch.Tensor, size: int, crop: int, train: bool = False,
    generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Resize, then a random (train) or centre crop, then normalise. Takes
    uint8 (0..255) or already-0..1 float images."""
    x = resize_bilinear(images, size)
    if images.dtype == torch.uint8:
        x = x / 255.0
    if train:
        return normalize(random_crop_flip(generator, x, crop), dtype)
    return normalize(center_crop(x, crop), dtype)
