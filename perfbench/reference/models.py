"""Plain reference pieces that every captioner of the benchmark shares.

Written from the papers' equations and the weight layout the benchmark hands
to both sides (``harness/weights``): dense weights ``[in, out]`` (``y = x @ w
+ b``), conv weights ``[out, in, kh, kw]``, an LSTM's one ``w [I + H, 4H]``
over ``[x, h]`` with the gates in the order i, f, g, o and one bias,
BatchNorm as ``{scale, bias, mean, var}``. Each model's network and each
trunk live in a plug-in of their own (``perfbench/models``, found by
``harness.plugins``), built on ``Net``; the beam search, its replay and the
trunk's features in blocks are here. It imports torch only: nothing of the
program under test, and nothing of JAX.

Every product and convolution goes through ``Net.q``: its operands, and the
tensor it produces, as a program computing in one precision stores them.
``q`` is the identity in the reference (float32; the caller turns TF32 off)
and rounds to float8 in the control (``lowp.fp8``), the precision below the
configurations' bfloat16. A cell state c stays float32, as the
configurations state.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Optional

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
PAD_ID, START_ID, END_ID = 0, 1, 2
NEG_INF = -1.0e9

Weights = Mapping[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


def normalize_nchw(images_u8: torch.Tensor) -> torch.Tensor:
    """[B, S, S, 3] uint8 (already cropped) -> normalised float32 NCHW."""
    x = images_u8.float().div(255.0)
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def center_crop(images_u8: torch.Tensor, crop: int) -> torch.Tensor:
    _, H, W, _ = images_u8.shape
    top, left = (H - crop) // 2, (W - crop) // 2
    return images_u8[:, top : top + crop, left : left + crop]


class Net:
    """Shared pieces: the products under ``q``, and the trunk.

    ``w`` is read as it stands, one tensor at a time: a dict of float32
    tensors, or a mapping that makes each float32 tensor when it is read
    (``harness.weights.Drawn``), so that a network holds no copy of its
    weights. ``trunk(net, x_nchw)`` is the trunk plug-in's ``features``."""

    def __init__(self, w: Weights, q: Optional[Quant] = None, trunk: Optional[Callable] = None):
        self.w = w
        self.q = _ident if q is None else q
        self.trunk = trunk

    def features(self, x_nchw: torch.Tensor) -> torch.Tensor:
        """The trunk's features of normalised NCHW images."""
        return self.trunk(self, x_nchw)

    def lin(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = self.q(x) @ self.q(self.w[name + ".w"])
        b = self.w.get(name + ".b")
        return self.q(y if b is None else y + b)

    def conv(self, x, name, stride=1, padding=0, bias=True):
        b = self.w.get(name + ".b") if bias else None
        return self.q(F.conv2d(self.q(x), self.q(self.w[name + ".w"]), b, stride=stride, padding=padding))

    def bn(self, x: torch.Tensor, name: str, eps: float = 1e-5, axis: int = 1) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[axis] = -1
        w = self.w
        inv = torch.rsqrt(w[name + ".var"] + eps)
        return (x - w[name + ".mean"].view(shape)) * (inv * w[name + ".scale"]).view(shape) + w[name + ".bias"].view(shape)

    def lstm(self, name: str, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        z = self.q(torch.cat([x, h], dim=-1)) @ self.q(self.w[name + ".w"]) + self.w[name + ".b"]
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return self.q(torch.sigmoid(o) * torch.tanh(c)), c


# --- decoding and scoring -----------------------------------------------------


def _gather_state(state, idx: torch.Tensor):
    if isinstance(state, (list, tuple)):
        return type(state)(_gather_state(s, idx) for s in state)
    return state.index_select(0, idx)


@torch.no_grad()
def beam_search(net: Net, feats: torch.Tensor, k: int, max_len: int):
    """Beam search with k beams, ranked by the raw sum of log-probabilities.
    At the first step the k beams are one, so the k best first words start
    them; a finished beam only extends by ``<pad>`` at no cost.

    Returns ``(ids [B, k, max_len], scores [B, k], parents [B, max_len, k],
    words [B, max_len, k])``: the final beams best first, padded with
    ``<pad>`` after ``<end>``, and their scores; then the search's choices,
    as ``replay`` takes them: at each step, the beam each kept beam extends
    and the word it adds (the last step's in the order of the final beams;
    after the search has ended, each beam extends itself by ``<pad>``)."""
    B = feats.shape[0]
    dev = feats.device
    image, state = net.start(feats)
    state, logits = net.first(image, state, B, k)
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), -1).view(B, k, V)
    mask = torch.full((1, k, 1), NEG_INF, device=dev)
    mask[:, 0] = 0.0
    scores, flat = torch.topk((logp + mask).view(B, k * V), k, dim=-1)
    parent, tok = flat // V, flat % V
    parents = torch.arange(k, device=dev).repeat(B, max_len, 1)
    words = torch.full((B, max_len, k), PAD_ID, dtype=torch.long, device=dev)
    parents[:, 0], words[:, 0] = parent, tok
    rows = (torch.arange(B, device=dev)[:, None] * k + parent).view(-1)
    state = _gather_state(state, rows)
    tokens = torch.full((B, k, max_len), PAD_ID, dtype=torch.long, device=dev)
    tokens[:, :, 0] = tok
    finished = tok == END_ID
    pad_only = torch.full((V,), NEG_INF, device=dev)
    pad_only[PAD_ID] = 0.0
    last = 0
    for t in range(1, max_len):
        if bool(finished.all()):
            break
        last = t
        state, logits = net.step(image, state, tok.view(-1), k)
        logp = torch.log_softmax(logits.float(), -1).view(B, k, V)
        logp = torch.where(finished[:, :, None], pad_only, logp)
        scores, flat = torch.topk((scores[:, :, None] + logp).view(B, k * V), k, dim=-1)
        parent, tok = flat // V, flat % V
        parents[:, t], words[:, t] = parent, tok
        rows = (torch.arange(B, device=dev)[:, None] * k + parent).view(-1)
        state = _gather_state(state, rows)
        tokens = torch.gather(tokens, 1, parent[:, :, None].expand(B, k, max_len))
        finished = torch.gather(finished, 1, parent)
        tokens[:, :, t] = torch.where(finished, PAD_ID, tok)
        finished = finished | (tok == END_ID)
    order = torch.argsort(-scores, dim=-1, stable=True)
    parents[:, last] = torch.gather(parents[:, last], 1, order)
    words[:, last] = torch.gather(words[:, last], 1, order)
    return (torch.gather(tokens, 1, order[:, :, None].expand(B, k, max_len)), torch.gather(scores, 1, order),
            parents, words)


@torch.no_grad()
def replay(net: Net, feats: torch.Tensor, parents: torch.Tensor, words: torch.Tensor):
    """Follow a beam search's choices, ``parents`` and ``words [B, T, k]``
    as ``beam_search`` returns them, with the reference's own state and
    scores. At each step the candidates are every word after every kept
    beam (only ``<pad>`` after a finished one), scored by the reference; the
    search should have kept the k best of them.

    Returns ``(gap [B], ids [B, k, T], scores [B, k])``: the widest amount,
    in nats, by which a candidate that was not kept outscores one that was
    (at or below 0 where the kept beams are the reference's k best; a kept
    candidate that the search could not have made, or one kept twice, reads
    ``inf``); and the final beams and their scores, in the order of the last
    step's choices."""
    B, T, k = parents.shape
    dev = feats.device
    image, state = net.start(feats)
    state, logits = net.first(image, state, B, k)
    V = logits.shape[-1]
    mask = torch.full((1, k, 1), NEG_INF, device=dev)
    mask[:, 0] = 0.0
    pad_only = torch.full((V,), NEG_INF, device=dev)
    pad_only[PAD_ID] = 0.0
    tokens = torch.full((B, k, T), PAD_ID, dtype=torch.long, device=dev)
    finished = torch.zeros(B, k, dtype=torch.bool, device=dev)
    gap = torch.full((B,), -float("inf"), device=dev)
    scores = tok = None
    for t in range(T):
        if t:
            state, logits = net.step(image, state, tok.reshape(-1), k)
        logp = torch.log_softmax(logits.float(), -1).view(B, k, V)
        cand = logp + mask if t == 0 else scores[:, :, None] + torch.where(finished[:, :, None], pad_only, logp)
        cand = cand.view(B, k * V)
        parent, tok = parents[:, t], words[:, t]
        flat = parent * V + tok
        kept = cand.gather(1, flat)
        others = cand.scatter(1, flat, -float("inf")).max(1).values
        step_gap = others - kept.min(1).values
        twice = (flat.sort(1).values.diff(dim=1) == 0).any(1)
        impossible = (kept <= NEG_INF / 2).any(1)
        gap = torch.maximum(gap, torch.where(twice | impossible, float("inf"), step_gap))
        rows = (torch.arange(B, device=dev)[:, None] * k + parent).view(-1)
        state = _gather_state(state, rows)
        tokens = torch.gather(tokens, 1, parent[:, :, None].expand(B, k, T))
        finished = torch.gather(finished, 1, parent)
        tokens[:, :, t] = torch.where(finished, PAD_ID, tok)
        finished = finished | (tok == END_ID)
        scores = kept
    return gap, tokens, scores


def features_of(net: Net, images_u8: torch.Tensor, crop: int, block: int = 16) -> torch.Tensor:
    """The trunk's features of uint8 NHWC images, centre-cropped, in blocks."""
    out: List[torch.Tensor] = []
    for i in range(0, images_u8.shape[0], block):
        x = normalize_nchw(center_crop(images_u8[i : i + block], crop))
        out.append(net.features(x))
    return torch.cat(out)
