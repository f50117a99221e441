"""Plain reference of Show-Attend-Tell's training step.

A uint8 batch gets a random crop and a horizontal flip (per image: a top
and a left offset, then a coin; drawn from the caller's generator in that
order, as the step's seeded transform draws them) and the ImageNet
normalisation; the frozen trunk gives the features; the decoder is teacher
forced over the caption (step t reads word t and is scored on word t + 1,
under the mask t < length - 1); the loss is the cross entropy averaged over
the scored words. Every gradient is clamped to +-grad_clip, then Adam (b1
0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected) steps by
-lr. Imports torch and ``reference.models`` only: the network is the model
plug-in's reference, which the caller hands over.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from reference import models as ref

B1, B2, EPS = 0.9, 0.999, 1e-8


def crop_flip(images: torch.Tensor, crop: int, g: torch.Generator) -> torch.Tensor:
    B, H, W, _ = images.shape
    dev = images.device
    tops = torch.randint(0, H - crop + 1, (B,), generator=g, device=dev)
    lefts = torch.randint(0, W - crop + 1, (B,), generator=g, device=dev)
    flips = torch.rand((B,), generator=g, device=dev) < 0.5
    out = torch.empty((B, crop, crop, 3), dtype=images.dtype, device=dev)
    for i in range(B):
        x = images[i, tops[i] : tops[i] + crop, lefts[i] : lefts[i] + crop]
        out[i] = x.flip(1) if bool(flips[i]) else x
    return out


def loss_of(net: ref.Net, feats: torch.Tensor, captions: torch.Tensor, lengths: torch.Tensor):
    B, T = captions.shape
    image, (h, c) = net.start(feats)
    logits = []
    for t in range(T - 1):
        (h, c), lg = net.step(image, (h, c), captions[:, t], 1)
        logits.append(lg)
    logp = torch.log_softmax(torch.stack(logits, 1), -1)
    ll = logp.gather(-1, captions[:, 1:, None]).squeeze(-1)
    mask = (torch.arange(T - 1, device=captions.device)[None] < (lengths[:, None] - 1)).float()
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


def train(net_of: Callable[[Dict[str, torch.Tensor], Optional[Callable]], ref.Net],
          weights: Dict[str, torch.Tensor], batches: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
          g: torch.Generator, crop: int, lr: float, clip: float, q=None):
    """Follow the step over ``batches`` of (uint8 images, captions, lengths)
    from ``weights``, with the network ``net_of(params, q)`` (the model
    plug-in's reference) over the leaves themselves, so that gradients reach
    them. Returns (losses, the first step's clamped gradients, the trainable
    tensors after the last step)."""
    params = {k: v.detach().clone().float().requires_grad_(not k.startswith("encoder."))
              for k, v in weights.items()}
    trainable = [k for k, v in params.items() if v.requires_grad]
    mu = {k: torch.zeros_like(params[k]) for k in trainable}
    nu = {k: torch.zeros_like(params[k]) for k in trainable}
    losses, first = [], None
    for n, (images, captions, lengths) in enumerate(batches, start=1):
        net = net_of(params, q)
        with torch.no_grad():
            feats = net.features(ref.normalize_nchw(crop_flip(images, crop, g)))
        loss = loss_of(net, feats, captions, lengths)
        grads = torch.autograd.grad(loss, [params[k] for k in trainable])
        losses.append(loss.item())
        with torch.no_grad():
            clamped = {k: gr.clamp(-clip, clip) for k, gr in zip(trainable, grads)}
            if first is None:
                first = clamped
            bc1, bc2 = 1 - B1**n, 1 - B2**n
            for k in trainable:
                mu[k].mul_(B1).add_((1 - B1) * clamped[k])
                nu[k].mul_(B2).add_((1 - B2) * clamped[k] ** 2)
                params[k] -= lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
    return losses, first, {k: params[k].detach() for k in trainable}
