"""The program's side of ``test_pb_proof``'s second model, which neither the
program nor the harness has seen: a pre-norm transformer decoder over the
port's VGG16 trunk, built from ``arch`` alone (its width, feed-forward
width, heads, depth, RoPE base and RMSNorm epsilon, named as a public
``config.json`` names them). The proof puts the class into the program's
``registry.MODELS``.

The trunk's grid, projected to the width, is a prefix of positions; then
``<start>``; then the words. ``decode_state`` runs the prefix and
``<start>`` and hands the beam search a key-value cache per layer as
``[B, heads, T, head_dim]`` leaves, which the search tiles to ``B * k`` rows
and ``decode.beam._gather_beams`` reorders at every step; each step appends
one position. Products and norms run in the configuration's compute dtype,
the softmax in float32. ``block`` and ``head`` are looked up in this module
at each call, so that a traced run wraps them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from show_and_tell_tpu_torch.models import encoders
from show_and_tell_tpu_torch.utils.device import resolve_device
from show_and_tell_tpu_torch.utils.vocab import START_ID

FEATURE = 512  # the VGG16 grid's channels


def rms_norm(x, g, eps):
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * g.float()).to(x.dtype)


def rope(x, pos, theta):
    """``x [N, H, T, hd]`` at positions ``pos [T]``, its halves rotated."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = pos.float()[:, None] * inv[None]
    cos, sin = ang.cos().to(x.dtype), ang.sin().to(x.dtype)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def block(p, x, cache, heads, theta, eps):
    """One layer over the new positions ``x [N, T, D]``, after the cache's
    ``(k, v) [N, H, P, hd]`` (None before the first): ``(x, (k, v))`` with
    the cache grown to ``P + T``."""
    N, T, D = x.shape
    hd = D // heads
    P = 0 if cache is None else cache[0].shape[2]
    h = rms_norm(x, p["attn_norm"]["g"], eps)
    q, k, v = ((h @ p[n]["w"]).view(N, T, heads, hd).transpose(1, 2) for n in ("q", "k", "v"))
    pos = torch.arange(P, P + T, device=x.device)
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    if cache is not None:
        k, v = torch.cat([cache[0], k], 2), torch.cat([cache[1], v], 2)
    s = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd)
    s = s.masked_fill(torch.arange(P + T, device=x.device)[None] > pos[:, None], float("-inf"))
    o = (torch.softmax(s, -1).to(x.dtype) @ v).transpose(1, 2).reshape(N, T, D)
    x = x + o @ p["o"]["w"]
    h = rms_norm(x, p["mlp_norm"]["g"], eps)
    return x + F.silu(h @ p["up"]["w"]) @ p["down"]["w"], (k, v)


def head(t, x, eps):
    """The logits of ``x [N, D]``."""
    return rms_norm(x, t["norm"]["g"], eps) @ t["out"]["w"] + t["out"]["b"]


def _pdict(**shapes) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(torch.zeros(*s)) for k, s in shapes.items()})


class CaptionDecoder(nn.Module):
    encoder_name = "vgg16"
    batch_stats = None
    mesh = None
    quantized = None

    def __init__(self, cfg, vocab_size, device="cuda", generator=None, arch=None):
        super().__init__()
        D, Fw, L = arch["hidden_size"], arch["intermediate_size"], arch["num_hidden_layers"]
        self.heads, self.theta, self.eps = arch["num_attention_heads"], arch["rope_theta"], arch["rms_norm_eps"]
        self.cfg, self.vocab_size = cfg, vocab_size
        self.cdtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        # every tensor is drawn by the caller (the benchmark's weights)
        self.proj = _pdict(w=(FEATURE, D), b=(D,))
        self.embed = nn.Parameter(torch.zeros(vocab_size, D))
        self.layers = nn.ModuleList(nn.ModuleDict({
            "attn_norm": _pdict(g=(D,)), "q": _pdict(w=(D, D)), "k": _pdict(w=(D, D)), "v": _pdict(w=(D, D)),
            "o": _pdict(w=(D, D)), "mlp_norm": _pdict(g=(D,)), "up": _pdict(w=(D, Fw)), "down": _pdict(w=(Fw, D)),
        }) for _ in range(L))
        self.norm = _pdict(g=(D,))
        self.out = _pdict(w=(D, vocab_size), b=(vocab_size,))
        self.encoder = encoders.frozen_module(encoders.init_vgg16(generator or torch.Generator().manual_seed(0)))
        self.to(resolve_device(device))

    @torch.no_grad()
    def backbone_features(self, images):
        """Normalised [B, crop, crop, 3] -> the grid [B, L, 512]."""
        return encoders.vgg16_features(encoders.module_tree(self.encoder), images.to(self.cdtype))

    def _cast(self):
        cd = self.cdtype
        return {
            "proj": {k: v.to(cd) for k, v in self.proj.items()}, "embed": self.embed.to(cd),
            "layers": [{n: {k: v.to(cd) for k, v in d.items()} for n, d in layer.items()} for layer in self.layers],
            "norm": {"g": self.norm.g.to(cd)}, "out": {k: v.to(cd) for k, v in self.out.items()},
        }

    @torch.no_grad()
    def decode_state(self, features, beam_size=1):
        """``(step_fn, carry, first_logits, tile=True)``: the prefix and
        ``<start>`` run here; the carry is each layer's ``(k, v)``."""
        t, opts = self._cast(), (self.heads, self.theta, self.eps)
        B = features.shape[0]
        x = features.to(self.cdtype) @ t["proj"]["w"] + t["proj"]["b"]
        x = torch.cat([x, t["embed"][START_ID].expand(B, 1, -1)], 1)
        cache = []
        for p in t["layers"]:
            x, kv = block(p, x, None, *opts)
            cache.append(kv)

        @torch.no_grad()
        def step_fn(carry, token_ids):
            x, new = t["embed"][token_ids][:, None], []
            for p, kv in zip(t["layers"], carry):
                x, kv = block(p, x, kv, *opts)
                new.append(kv)
            return new, head(t, x[:, 0], self.eps)

        return step_fn, cache, head(t, x[:, -1], self.eps), True
