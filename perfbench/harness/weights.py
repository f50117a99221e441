"""Seeded weights for both sides, made on the device.

The benchmark, not the program, owns the weights. By default ``make(shapes,
seed, device)`` fills every tensor of a state dict's names and shapes from
one ``torch.Generator`` on the device with one uniform draw, each tensor a
slice of it scaled by a rule on its name; the program loads them
(``load_state_dict``) and the reference reads the same dict. A configuration
whose model would not fit twice in float32 asks instead for its tensors one
by one (``"per_tensor": true`` under ``weights``): ``fill`` draws each from
a substream of its own, by name, in the program's dtype, straight into the
program's parameters, and hands the reference ``Drawn``, a read-only
mapping that draws a tensor again, in float32, each time it is read and
keeps none.

The built-in rules keep a random network's activations in range, as a
trained one's are: He-scaled convolutions, dense layers at 1/sqrt(fan-in),
BatchNorm statistics near identity, and the last BatchNorm of each residual
branch small, so that ResNet-152's 50 residual additions do not grow the
stream by 2^50. The classifier is scaled up so that the next-word
distribution is peaked as a trained captioner's is (logits spread by a few
nats), and not flat over 10,000 words: a flat one leaves every beam a
near-tie, which rounding of any precision flips. By how much is the
configuration's own choice (``head_gain`` under ``weights`` in its file).

A configuration's ``rules`` under ``weights`` come before the built-in ones:
each names tensors by a regular expression that their whole name matches
(``match``) and gives one of ``uniform: [lo, hi]``, ``constant: c`` or
``fan_in_axis: n`` (uniform in +-1/sqrt(shape[n])); the first that matches
decides. So an RMSNorm's gain can sit near 1, a router's bias at 0 and an
expert weight ``[E, in, out]`` at 1/sqrt(in).
"""

from __future__ import annotations

import hashlib
import math
import re
from collections.abc import Mapping
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

Shapes = Dict[str, Tuple[int, ...]]
Rule = Tuple["re.Pattern", str, object]

# (low, high) of a uniform draw, by name
_BN = {"scale": (0.5, 1.0), "bias": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 1.5)}
_BRANCH_END_SCALE = (0.1, 0.3)
NEVER = -1.0e4  # the output bias of words the model never predicts


def rules_of(specs: Sequence[Dict]) -> List[Rule]:
    """A configuration's rules, checked and compiled."""
    out = []
    for spec in specs:
        kinds = [k for k in ("uniform", "constant", "fan_in_axis") if k in spec]
        if len(kinds) != 1 or set(spec) != {"match", kinds[0]}:
            raise ValueError("a weight rule is {'match': <regex>} and one of 'uniform': [lo, hi], "
                             f"'constant': c, 'fan_in_axis': n; got {spec!r}")
        out.append((re.compile(spec["match"]), kinds[0], spec[kinds[0]]))
    return out


def _interval(name: str, shape: Tuple[int, ...], head_gain: float, rules: Sequence[Rule]) -> Tuple[float, float]:
    for pattern, kind, value in rules:
        if pattern.fullmatch(name):
            if kind == "uniform":
                return float(value[0]), float(value[1])
            if kind == "constant":
                return float(value), float(value)
            s = 1.0 / math.sqrt(shape[value])
            return -s, s
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


def _scaled(name: str, part: torch.Tensor, head_gain: float, rules: Sequence[Rule]) -> torch.Tensor:
    """A uniform [0, 1) draw, in place, scaled to the tensor's interval."""
    lo, hi = _interval(name, tuple(part.shape), head_gain, rules)
    part.mul_(hi - lo).add_(lo)
    if name in ("classifier.b", "out.b"):
        # <pad> and <start> are never predicted, as by a trained model:
        # a served string cannot show them, so neither may be served
        part[:2] = NEVER
    return part


@torch.no_grad()
def make(shapes: Shapes, seed: int, device, head_gain: float = 1.0,
         rules: Sequence[Dict] = ()) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from ``seed`` alone; the output
    layer's weights ``head_gain`` times 1/sqrt(fan-in)."""
    rules = rules_of(rules)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32)
    return {n: _scaled(n, part.view(shapes[n]), head_gain, rules)
            for n, part in zip(names, torch.split(flat, sizes))}


def tensor_seed(seed: int, name: str) -> int:
    """The 63-bit seed of tensor ``name``'s own substream of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Drawn(Mapping):
    """The reference's read-only view of weights drawn tensor by tensor:
    each read draws the tensor again from its own substream, in the
    program's dtype, and hands it over in float32; nothing is kept, so that
    a reference holds only the tensors it is using."""

    def __init__(self, specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]], seed: int, device,
                 head_gain: float = 1.0, rules: Sequence[Dict] = ()):
        self.specs, self.seed, self.device, self.head_gain = specs, seed, device, head_gain
        self.rules = rules_of(rules)
        self._g = torch.Generator(device=device)

    @torch.no_grad()
    def draw(self, name: str) -> torch.Tensor:
        """Tensor ``name`` as the program holds it (its dtype)."""
        shape, dtype = self.specs[name]
        self._g.manual_seed(tensor_seed(self.seed, name))
        part = torch.rand(shape, generator=self._g, device=self.device, dtype=torch.float32)
        return _scaled(name, part, self.head_gain, self.rules).to(dtype)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.draw(name).float()

    def __contains__(self, name) -> bool:
        return name in self.specs

    def __iter__(self) -> Iterator[str]:
        return iter(self.specs)

    def __len__(self) -> int:
        return len(self.specs)


@torch.no_grad()
def fill(state_dict: Dict[str, torch.Tensor], seed: int, device, head_gain: float = 1.0,
         rules: Sequence[Dict] = ()) -> Drawn:
    """Draw every floating tensor of the program's ``state_dict`` (its
    parameters' own storage) on its own, in its dtype, and write it in
    place; return the mapping that the reference reads the same tensors
    from."""
    drawn = Drawn({k: (tuple(v.shape), v.dtype) for k, v in state_dict.items() if v.is_floating_point()},
                  seed, device, head_gain, rules)
    for name in drawn:
        state_dict[name].copy_(drawn.draw(name))
    return drawn
