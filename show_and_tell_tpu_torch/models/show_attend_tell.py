"""Show-Attend-and-Tell: VGG16 feature grid + additive soft attention + LSTM.

- Encoder: frozen VGG16 trunk to conv5_2+ReLU -> [B, 196, 512] patch grid.
- ``ctx_enc = features @ W_img`` once per image.
- LSTM state from the mean feature through two dense layers.
- Per step: additive attention, the LSTM cell over [emb; context], and the
  head ``classifier(c2o(context) + h2o(h))``.

Mixed precision: with ``cfg.dtype == "bfloat16"`` the parameters and
per-image tensors are cast to bf16 once per call, while the LSTM bias and
the cell state c stay fp32. The parameters themselves stay fp32: the casts
sit inside the differentiated function, so their gradients come back fp32.

On CUDA tensors each step runs hand-written kernels: the beam-shared
attention (k > 1) or the per-row attention (k = 1), and the fused LSTM
cell. On CPU tensors the same calls run their plain PyTorch versions.
Training (``decode_train``) runs the per-row attention and the cell
through their autograd Functions: the kernels forward, a plain recompute
backward, as the JAX package does. Decoding runs without autograd.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models import encoders
from show_and_tell_tpu_torch.models.layers import (
    cast_tree,
    dense,
    dropout,
    embedding_lookup,
    uniform_dense,
)
from show_and_tell_tpu_torch.models.quantize import backbone_features_q
from show_and_tell_tpu_torch.ops.attention import encode_features, init_attention_params
from show_and_tell_tpu_torch.ops.fused_attention import fused_additive_attention
from show_and_tell_tpu_torch.ops.fused_decode_attention import attention_beam
from show_and_tell_tpu_torch.ops.lstm import init_lstm_params, lstm_cell
from show_and_tell_tpu_torch.utils.device import resolve_device
from show_and_tell_tpu_torch.utils.vocab import START_ID

Params = Dict
_DENSE = ("init_h", "init_c", "c2o", "h2o", "classifier")


def _pdict(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


class ShowAttendTell(nn.Module):
    """Parameters live in the module; ``trainable_tree()`` and
    ``frozen_tree()`` give them as the nested dicts of the JAX package's
    ``(trainable, frozen)`` trees. The trainable ones require grad; the VGG
    convs do not. ``dropout_rate`` applies to the head's input during
    training when a generator is given (the captioning model this system
    reproduces declares a dropout it never applies, hence the default 0)."""

    encoder_name = "vgg16"
    batch_stats = None  # no BatchNorm (Show-and-Tell's are its buffers)

    def __init__(
        self,
        cfg: Config,
        vocab_size: int,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.dropout_rate = dropout_rate
        self.feature_dim = 512  # VGG conv5 channels
        self.cdtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        #: the calibrated int8 trunk (``models/quantize.py``) once the
        #: Captioner, the Trainer or ``cli.evaluate`` has made it; it is held
        #: outside the state dict, so checkpoints do not carry it
        self.quantized: Optional[Params] = None
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.random_seed)
        self.init(generator)
        self.to(dev)

    # --- init -------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (a CPU generator; the module is
        moved to its device afterwards)."""
        cfg, g = self.cfg, generator
        D, H, E, V = self.feature_dim, cfg.hidden_size, cfg.embed_size, self.vocab_size
        self.att = _pdict(init_attention_params(D, H, g))
        self.init_h = _pdict(uniform_dense(D, H, g))
        self.init_c = _pdict(uniform_dense(D, H, g))
        self.embed = nn.Parameter(torch.rand(V, E, generator=g) * 0.2 - 0.1)
        # LSTMCell input is [emb; context] = E + D
        self.lstm = _pdict(init_lstm_params(E + D, H, g))
        self.c2o = _pdict(uniform_dense(D, E, g))
        self.h2o = _pdict(uniform_dense(H, E, g))
        self.classifier = _pdict(uniform_dense(E, V, g))
        self.encoder = encoders.frozen_module(encoders.init_vgg16(g))

    def trainable_tree(self) -> Params:
        t = {k: dict(getattr(self, k).items()) for k in ("att", "lstm", *_DENSE)}
        t["embed"] = self.embed
        return t

    def frozen_tree(self) -> Params:
        return encoders.module_tree(self.encoder)

    # --- encoder ----------------------------------------------------------

    @torch.no_grad()
    def backbone_features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalised [B, 224, 224, 3] -> [B, 196, 512] in the compute dtype,
        or in fp32 through the int8 trunk once ``quantized`` is set."""
        if self.quantized is not None:
            return backbone_features_q(self.quantized, images)
        return encoders.vgg16_features(self.frozen_tree(), images.to(self.cdtype))

    def init_lstm_state(self, trainable: Params, features: torch.Tensor):
        """Mean feature through two dense layers."""
        mean = features.mean(dim=1)
        return dense(trainable["init_h"], mean), dense(trainable["init_c"], mean)

    def _cast_for_compute(self, features: torch.Tensor):
        """Parameters and per-image tensors in the compute dtype, once per
        call; the LSTM bias stays fp32 (it adds into the fp32 gates)."""
        cd = self.cdtype
        tr = self.trainable_tree()
        t = dict(tr)
        for k in ("att", "embed", "c2o", "h2o", "classifier"):
            t[k] = cast_tree(tr[k], cd)
        t["lstm"] = {"w": tr["lstm"]["w"].to(cd), "b": tr["lstm"]["b"]}
        return t, features.to(cd)

    # --- one decoder step -------------------------------------------------

    @staticmethod
    def _attend(att, features, ctx_enc, h, k: int):
        """Attention for rows ``b*k + j`` against per-image tensors: the
        per-row op for k = 1, the beam-shared op for k > 1. Returns
        ``(context [B*k, D], alpha [B*k, L])``."""
        if k == 1:
            return fused_additive_attention(att, features, ctx_enc, h)
        B, L, D = features.shape
        hp = h @ att["w_hh"] + att["b_hh"]
        context, alpha = attention_beam(ctx_enc, features, hp.reshape(B, k, D), att["w_att"])
        return context.reshape(B * k, D), alpha.reshape(B * k, L)

    def _recur(self, t, features, ctx_enc, h, c, emb, k: int = 1):
        """Attention, then the cell over [emb; context]. Returns
        (h, c, context, alpha)."""
        context, alpha = self._attend(t["att"], features, ctx_enc, h, k)
        h, c = lstm_cell(t["lstm"], torch.cat([emb, context], dim=-1), h, c)
        return h, c, context, alpha

    def _head(self, t, context, h, generator=None):
        out = dense(t["c2o"], context) + dense(t["h2o"], h)
        out = dropout(generator, out, self.dropout_rate)
        return dense(t["classifier"], out)

    def _step(self, t, features, ctx_enc, h, c, emb, k: int = 1, generator=None):
        """One step for k rows per image. ``h`` is in the compute dtype,
        ``c`` fp32. Returns (h, c, logits, alpha)."""
        h, c, context, alpha = self._recur(t, features, ctx_enc, h, c, emb, k)
        return h, c, self._head(t, context, h, generator), alpha

    def decode_init(self, features: torch.Tensor):
        """What every decode starts from: ``(tree, features, ctx_enc, h, c)``,
        the parameters and features cast to the compute dtype, ``ctx_enc``
        once per image, and the initial state with c in fp32."""
        t, features = self._cast_for_compute(features)
        ctx_enc = encode_features(t["att"], features)
        h, c = self.init_lstm_state(t, features)
        return t, features, ctx_enc, h, c.float()

    # --- training forward -------------------------------------------------

    def decode_train(
        self,
        features: torch.Tensor,  # [B, L, 512]
        captions: torch.Tensor,  # [B, T] int
        lengths: torch.Tensor,  # [B]
        generator: Optional[torch.Generator] = None,
        ss_prob: Union[float, torch.Tensor] = 0.0,
    ):
        """Teacher-forced (optionally scheduled-sampled) logits.

        Step t consumes ``captions[:, t]`` and is scored against
        ``captions[:, t+1]``; the mask is ``t < len - 1``. Returns
        ``(logits [B, T-1, V], mask [B, T-1], alphas [B, T-1, L])``.

        With ``ss_prob`` the Python float 0.0 (pure teacher forcing) only the
        recurrence runs per step; the embedding and the whole head run
        batched over the T-1 steps, so the classifier is one
        [B*(T-1), E] x [E, V] product. Any other ``ss_prob`` (a float or a
        tensor) takes the per-step path: from step 1 on, each row feeds the
        model's own previous argmax with probability ``ss_prob``. Both draw
        their random numbers (sampling and dropout) from ``generator``, on
        the model's device; without one there is no dropout, and sampling
        draws from torch's default generator.
        """
        B, T = captions.shape
        t, features, ctx_enc, h, c = self.decode_init(features)
        tokens = captions[:, :-1]
        mask = torch.arange(T - 1, device=captions.device)[None, :] < (lengths[:, None] - 1)
        if isinstance(ss_prob, (int, float)) and float(ss_prob) == 0.0:
            emb_all = embedding_lookup(t["embed"], tokens)  # [B, T-1, E]
            hs, ctxs, alphas = [], [], []
            for s in range(T - 1):
                h, c, context, alpha = self._recur(t, features, ctx_enc, h, c, emb_all[:, s])
                hs.append(h)
                ctxs.append(context)
                alphas.append(alpha)
            logits = self._head(t, torch.stack(ctxs, 1), torch.stack(hs, 1), generator)
            return logits, mask, torch.stack(alphas, 1)

        logits, alphas = [], []
        prev = None
        for s in range(T - 1):
            tok = tokens[:, s]
            if s > 0:
                u = torch.rand((B,), generator=generator, device=tok.device)
                tok = torch.where(u < ss_prob, prev, tok)
            emb = embedding_lookup(t["embed"], tok)
            h, c, lg, alpha = self._step(t, features, ctx_enc, h, c, emb, 1, generator)
            prev = lg.argmax(dim=-1)
            logits.append(lg)
            alphas.append(alpha)
        return torch.stack(logits, 1), mask, torch.stack(alphas, 1)

    # --- attention visualisation ------------------------------------------

    @torch.no_grad()
    def greedy_with_attention(self, features: torch.Tensor, max_len: int = 20):
        """Greedy decode that also returns each step's attention map:
        ``(ids [B, T], alphas [B, T, L])``. Reshape alphas to the patch grid
        (14 x 14 at 224 px) to lay them over the image."""
        t, features, ctx_enc, h, c = self.decode_init(features)
        B = features.shape[0]
        tok = torch.full((B,), START_ID, dtype=torch.long, device=features.device)
        ids, alphas = [], []
        for _ in range(max_len):
            emb = embedding_lookup(t["embed"], tok)
            h, c, logits, alpha = self._step(t, features, ctx_enc, h, c, emb)
            tok = logits.argmax(dim=-1)
            ids.append(tok)
            alphas.append(alpha)
        return torch.stack(ids, 1), torch.stack(alphas, 1)

    # --- decoding step interface -----------------------------------------

    def decode_state(self, features: torch.Tensor, beam_size: int = 1):
        """``(step_fn, carry, first_logits=None, tile=False)`` for
        ``decode.dispatch.decode_ids``: the carry is already per beam."""
        step_fn, carry, first = self.make_decode_state(features, beam_size)
        return step_fn, carry, first, False

    @torch.no_grad()
    def make_decode_state(self, features: torch.Tensor, beam_size: int = 1):
        """features [B, L, 512] -> (step_fn, carry, first_logits=None).

        Decoding starts from ``<start>``. The carry holds only the recurrent
        (h, c), repeated per beam (rows ``b*k + j``); features and ctx_enc
        stay per image in the step closure and the beamed attention reads
        them once per step for all k beams. Decoding is never
        differentiated: the state and every step run without autograd."""
        t, features, ctx_enc, h, c = self.decode_init(features)
        k = beam_size
        if k > 1:
            h = h.repeat_interleave(k, dim=0)
            c = c.repeat_interleave(k, dim=0)

        @torch.no_grad()
        def step_fn(carry, token_ids):
            emb = embedding_lookup(t["embed"], token_ids)
            h, c, logits, _ = self._step(t, features, ctx_enc, carry["h"], carry["c"], emb, k)
            return {"h": h, "c": c}, logits

        return step_fn, {"h": h, "c": c}, None
