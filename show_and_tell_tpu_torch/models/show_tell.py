"""Show-and-Tell (Vinyals et al.): a frozen CNN trunk and an N-layer LSTM.

- Encoder: the frozen ResNet-152 trunk (Inception-v3 with
  ``cfg.encoder == "inception_v3"``; ``"vgg16"``, the ``Config`` default,
  maps to ResNet-152 as in the JAX package) -> a pooled [B, 2048] feature
  -> a trainable projection to E, initialised N(0, 0.02) -> BatchNorm1d
  (momentum 0.01), whose running mean and variance are the model's buffers.
- Decoder: the embedding U(-0.1, 0.1), ``num_layers`` LSTM cells, the head
  Linear(H -> V) U(-0.1, 0.1) with bias 0.
- Step 0 consumes the image embedding and predicts the first word; every
  later step consumes the token the step before predicted. ``<start>`` is
  never fed.

Mixed precision as in Show-Attend-Tell: with ``cfg.dtype == "bfloat16"`` the
matmul weights are cast to bf16 inside each call, while the BatchNorm, the
LSTM bias and the cell state c stay fp32. Every layer of every step runs the
fused LSTM cell (``ops.lstm.lstm_cell``): the CUDA kernel for CUDA tensors,
its plain version for CPU tensors.

``encode(features, train=True)`` computes the batch statistics and returns
the new running statistics without writing them: the training step commits
them when it applies the update (``train/step.py``), so that a skipped
non-finite step leaves them as they were.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models import encoders
from show_and_tell_tpu_torch.models.layers import (
    batch_norm_inference,
    batch_norm_train,
    cast_tree,
    dense,
    embedding_lookup,
)
from show_and_tell_tpu_torch.models.quantize import backbone_features_q
from show_and_tell_tpu_torch.ops.lstm import init_lstm_params, lstm_cell
from show_and_tell_tpu_torch.utils.device import resolve_device

Params = Dict
State = List[Tuple[torch.Tensor, torch.Tensor]]

BN_MOMENTUM = 0.01


def _pdict(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


class _BatchNorm(nn.Module):
    """A trainable scale and bias, and the running mean and variance as
    buffers (state-dict names ``bn.scale``, ``bn.bias``, ``bn.mean``,
    ``bn.var``)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))


class ShowTell(nn.Module):
    """Parameters live in the module; ``trainable_tree()``, ``frozen_tree()``
    and ``batch_stats`` give them as the JAX package's ``(trainable,
    frozen)`` trees and its ``batch_stats``."""

    def __init__(
        self,
        cfg: Config,
        vocab_size: int,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.encoder_name = cfg.encoder if cfg.encoder != "vgg16" else "resnet152"
        self.feature_dim = encoders.encoder_feature_dim(self.encoder_name)
        self.cdtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        #: the calibrated int8 trunk, held outside the state dict (as in
        #: ``ShowAttendTell``)
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
        E, H, V = cfg.embed_size, cfg.hidden_size, self.vocab_size
        self.proj = _pdict({"w": torch.randn(self.feature_dim, E, generator=g) * 0.02, "b": torch.zeros(E)})
        self.bn = _BatchNorm(E)
        self.embed = nn.Parameter(torch.rand(V, E, generator=g) * 0.2 - 0.1)
        self.lstm = nn.ModuleList(
            _pdict(init_lstm_params(E if layer == 0 else H, H, g)) for layer in range(cfg.num_layers)
        )
        self.out = _pdict({"w": torch.rand(H, V, generator=g) * 0.2 - 0.1, "b": torch.zeros(V)})
        self.encoder = encoders.frozen_module(encoders.init_encoder(self.encoder_name, g))

    def trainable_tree(self) -> Params:
        return {
            "proj": dict(self.proj.items()),
            "bn": {"scale": self.bn.scale, "bias": self.bn.bias},
            "embed": self.embed,
            "lstm": [dict(p.items()) for p in self.lstm],
            "out": dict(self.out.items()),
        }

    def frozen_tree(self) -> Params:
        return encoders.module_tree(self.encoder)

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm's running statistics: the model's own buffers."""
        return {"mean": self.bn.mean, "var": self.bn.var}

    # --- encoder ----------------------------------------------------------

    @torch.no_grad()
    def backbone_features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalised [B, crop, crop, 3] -> [B, 2048] in the compute dtype,
        or in fp32 through the int8 trunk once ``quantized`` is set."""
        if self.quantized is not None:
            return backbone_features_q(self.quantized, images)
        apply = encoders.encoder_apply(self.encoder_name)
        return apply(self.frozen_tree(), images.to(self.cdtype))

    def encode(self, features: torch.Tensor, train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The projection, then the BatchNorm: ``(embedding [B, E],
        batch_stats)``. In train mode the batch's statistics normalise and
        the returned statistics are the updated running ones (detached, not
        written); otherwise the running statistics normalise and come back
        as they are."""
        f = dense(self.proj, features)
        bn = {"scale": self.bn.scale, "bias": self.bn.bias, "mean": self.bn.mean, "var": self.bn.var}
        if train:
            y, new = batch_norm_train(bn, f, momentum=BN_MOMENTUM)
            return y, {"mean": new["mean"].detach(), "var": new["var"].detach()}
        return batch_norm_inference(bn, f), self.batch_stats

    # --- decoder ----------------------------------------------------------

    def _cast_for_compute(self) -> Params:
        """The decoder's matmul weights in the compute dtype; the LSTM bias
        stays fp32 (it adds into the fp32 gates)."""
        cd = self.cdtype
        tr = self.trainable_tree()
        t = dict(tr)
        t["embed"] = tr["embed"].to(cd)
        t["out"] = cast_tree(tr["out"], cd)
        t["lstm"] = [{"w": p["w"].to(cd), "b": p["b"]} for p in tr["lstm"]]
        return t

    @staticmethod
    def _run_lstm_stack(t: Params, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        """One step through the layer stack; state is [(h, c)] per layer."""
        new_state = []
        inp = x
        for p, (h, c) in zip(t["lstm"], state):
            h, c = lstm_cell(p, inp, h, c)
            new_state.append((h, c))
            inp = h
        return inp, new_state

    def zero_state(self, batch: int, device: torch.device) -> State:
        """h in the compute dtype, c in fp32, per layer."""
        H = self.cfg.hidden_size
        return [
            (torch.zeros(batch, H, dtype=self.cdtype, device=device), torch.zeros(batch, H, device=device))
            for _ in range(self.cfg.num_layers)
        ]

    def decode_train(
        self,
        feat_embed: torch.Tensor,  # [B, E], projected and normalised
        captions: torch.Tensor,  # [B, T] int, <start> ... <end>
        lengths: torch.Tensor,  # [B]
        generator: Optional[torch.Generator] = None,
        ss_prob: Union[float, torch.Tensor] = 0.0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced (optionally scheduled-sampled) logits: ``(logits
        [B, T-1, V], mask [B, T-1])``.

        Step 0 consumes the image embedding, step t >= 1 consumes
        ``captions[:, t]``, and step t is scored against ``captions[:, t+1]``
        under the mask ``t < len - 1``. With ``ss_prob`` the Python float 0.0
        only the recurrence runs per step and the head runs once over all
        steps. Any other ``ss_prob`` takes the per-step path: from step 1 on,
        each row feeds the model's own previous argmax with probability
        ``ss_prob``, drawn from ``generator`` (torch's default one without
        it)."""
        t = self._cast_for_compute()
        feat = feat_embed.to(self.cdtype)
        B, T = captions.shape
        steps = T - 1
        mask = torch.arange(steps, device=captions.device)[None, :] < (lengths[:, None] - 1)
        state = self.zero_state(B, feat.device)
        if isinstance(ss_prob, (int, float)) and float(ss_prob) == 0.0:
            # time-major, so that each step's input rows are contiguous
            emb = embedding_lookup(t["embed"], captions[:, 1:steps].t())  # [T-2, B, E]
            xs = torch.cat([feat[None], emb], dim=0)
            outs = []
            for s in range(steps):
                out, state = self._run_lstm_stack(t, xs[s], state)
                outs.append(out)
            return dense(t["out"], torch.stack(outs, 1)), mask

        logits = []
        x = feat
        for s in range(steps):
            if s > 0:
                tok = captions[:, s]
                u = torch.rand((B,), generator=generator, device=tok.device)
                tok = torch.where(u < ss_prob, logits[-1].argmax(dim=-1), tok)
                x = embedding_lookup(t["embed"], tok)
            out, state = self._run_lstm_stack(t, x, state)
            logits.append(dense(t["out"], out))
        return torch.stack(logits, 1), mask

    # --- decoding step interface -----------------------------------------

    def decode_state(self, features: torch.Tensor, beam_size: int = 1):
        """``(step_fn, carry, first_logits, tile=True)`` for
        ``decode.dispatch.decode_ids``: the carry is per image, and beam
        search tiles it after the first step; ``beam_size`` is handled
        there."""
        step_fn, carry, first = self.make_decode_state(features)
        return step_fn, carry, first, True

    @torch.no_grad()
    def make_decode_state(self, features: torch.Tensor):
        """features [B, feature_dim] -> (step_fn, carry, first_logits).

        Step 0 runs here on the image embedding; ``first_logits`` are its
        predictions, and ``step_fn(carry, token_ids)`` runs every later
        step. Decoding runs without autograd."""
        f, _ = self.encode(features, train=False)
        t = self._cast_for_compute()
        f = f.to(self.cdtype)
        out, state = self._run_lstm_stack(t, f, self.zero_state(f.shape[0], f.device))
        first_logits = dense(t["out"], out)

        @torch.no_grad()
        def step_fn(carry, token_ids):
            out, carry = self._run_lstm_stack(t, embedding_lookup(t["embed"], token_ids), carry)
            return carry, dense(t["out"], out)

        return step_fn, state, first_logits
