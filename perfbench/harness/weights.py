"""Seeded weights for both sides, made on the device in one draw.

The benchmark, not the program, owns the weights: ``make(shapes, seed,
device)`` fills every tensor of a state dict's names and shapes from one
``torch.Generator`` on the device with one uniform draw, each tensor a slice
of it scaled by a rule on its name. The program loads them
(``load_state_dict``); the reference reads the same dict.

The rules keep a random network's activations in range, as a trained one's
are: He-scaled convolutions, dense layers at 1/sqrt(fan-in), BatchNorm
statistics near identity, and the last BatchNorm of each residual branch
small, so that ResNet-152's 50 residual additions do not grow the stream
by 2^50. The classifier is scaled up so that the next-word distribution is
peaked as a trained captioner's is (logits spread by a few nats), and not
flat over 10,000 words: a flat one leaves every beam a near-tie, which
rounding of any precision flips. By how much is the configuration's own
choice (``head_gain`` under ``weights`` in its file).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Shapes = Dict[str, Tuple[int, ...]]

# (low, high) of a uniform draw, by name
_BN = {"scale": (0.5, 1.0), "bias": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 1.5)}
_BRANCH_END_SCALE = (0.1, 0.3)
NEVER = -1.0e4  # the output bias of words the model never predicts


def _interval(name: str, shape: Tuple[int, ...], head_gain: float) -> Tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    parent = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if "bn" in parent and leaf in _BN:
        if leaf == "scale" and parent in ("bn3", "down_bn"):
            return _BRANCH_END_SCALE
        return _BN[leaf]
    if len(shape) == 4:  # conv [out, in, kh, kw]: He, as a uniform
        s = math.sqrt(6.0 / (shape[1] * shape[2] * shape[3]))
        return -s, s
    if name == "embed":
        return -0.1, 0.1
    if name == "att.w_att":
        s = math.sqrt(6.0 / (shape[0] + 1))
        return -s, s
    if leaf == "b" and name.startswith("encoder."):
        return -0.05, 0.05
    if len(shape) == 2:  # dense [in, out], the LSTM's [I + H, 4H]
        s = 1.0 / math.sqrt(shape[0])
        if name.startswith(("classifier.", "out.")):
            s *= head_gain
        return -s, s
    # biases of dense layers and the attention's b_hh
    return -0.05, 0.05


def shapes_of(state_dict: Dict[str, torch.Tensor]) -> Shapes:
    return {k: tuple(v.shape) for k, v in state_dict.items() if v.is_floating_point()}


@torch.no_grad()
def make(shapes: Shapes, seed: int, device, head_gain: float = 1.0) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from ``seed`` alone; the output
    layer's weights ``head_gain`` times 1/sqrt(fan-in)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for n, part in zip(names, torch.split(flat, sizes)):
        lo, hi = _interval(n, shapes[n], head_gain)
        out[n] = part.view(shapes[n]).mul_(hi - lo).add_(lo)
        if n in ("classifier.b", "out.b"):
            # <pad> and <start> are never predicted, as by a trained model:
            # a served string cannot show them, so neither may be served
            out[n][:2] = NEVER
    return out
