"""The training step and the teacher-forced eval loss.

The optimizer is written out in plain tensor code, with the JAX package's
semantics (an optax chain there):

- a per-element clamp of every gradient to +-``grad_clip``,
- Adam with optax's ``scale_by_adam`` defaults (b1 0.9, b2 0.999,
  eps 1e-8 outside the square root, bias-corrected moments),
- then -lr, with the learning rate passed per step so that a host-side
  schedule can set it.

With ``grad_accum_steps`` k > 1 the gradients of k micro-batches are
averaged (a running mean, as ``optax.MultiSteps``) and one update is applied
every k-th step. With ``skip_nonfinite`` a step whose global gradient norm
is not finite changes nothing: not the parameters, not the optimizer state,
not the accumulation. ``ema_decay`` > 0 keeps an average of the parameters
that ticks only on steps that applied an update.

Parameters are the model's own and are updated in place, as are the
optimizer's moments; the step returns the same ``TrainState`` object. The
frozen VGG16 trunk and the train transform run outside autograd. Reading
whether the gradient norm is finite costs one host synchronisation per
step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data.transforms import eval_transform, train_transform
from show_and_tell_tpu_torch.train.losses import masked_cross_entropy

Tensors = Dict[str, torch.Tensor]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class TrainState:
    params: Tensors  # name (as in the model's state dict) -> trainable Parameter
    opt_state: Dict[str, Any]
    step: int = 0
    # average of the params (cfg.ema_decay > 0), else None
    ema_params: Optional[Tensors] = None


def _zeros_like(tree: Tensors) -> Tensors:
    return {k: torch.zeros_like(v, memory_format=torch.contiguous_format) for k, v in tree.items()}


def make_train_state(cfg: Config, model) -> TrainState:
    """A fresh state over the model's trainable parameters: Adam's count and
    zero moments, the accumulation state when ``grad_accum_steps`` > 1, and a
    copy of the params as the EMA when ``ema_decay`` > 0."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    with torch.no_grad():
        opt_state: Dict[str, Any] = {"count": 0, "mu": _zeros_like(params), "nu": _zeros_like(params)}
        if cfg.grad_accum_steps > 1:
            opt_state.update(mini_step=0, acc_grads=_zeros_like(params))
        ema = {k: v.detach().clone() for k, v in params.items()} if cfg.ema_decay > 0 else None
    return TrainState(params=params, opt_state=opt_state, step=0, ema_params=ema)


def _adam_update(cfg: Config, opt_state: Dict[str, Any], params: Tensors, grads: Tensors, lr: float):
    """Clamp, Adam, times -lr: updates params and opt_state in place."""
    count = opt_state["count"] + 1
    # the bias corrections in fp32, as optax computes them
    one = torch.ones((), dtype=torch.float32)
    bc1 = (one - torch.tensor(ADAM_B1, dtype=torch.float32) ** count).item()
    bc2 = (one - torch.tensor(ADAM_B2, dtype=torch.float32) ** count).item()
    for k, p in params.items():
        g = grads[k].clamp(-cfg.grad_clip, cfg.grad_clip)
        mu, nu = opt_state["mu"][k], opt_state["nu"][k]
        mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
        nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        p.add_(-u * lr)
    opt_state["count"] = count


class TrainStep:
    """``step(state, batch, lr, ss_prob=0.0, generator=None) -> (state,
    metrics)``.

    ``batch`` holds ``captions`` [B, T] and ``lengths`` [B] (int), and either
    ``features`` [B, L, 512] or ``images`` [B, H, W, 3] (uint8 images get the
    random crop, flip and normalisation). ``generator`` (on the model's
    device) drives the crop, the flips, scheduled sampling and dropout; the
    step owns one seeded from ``cfg.random_seed`` for calls without it.
    ``ss_prob`` is read only when ``cfg.scheduled_sampling_start`` >= 0;
    otherwise the step runs the teacher-forcing fast path.

    Metrics (device tensors): loss, perplexity, tokens, and grad_norm, the
    global norm of the gradients before the clamp.

    The phases are methods, so that a caller can time them apart:
    ``features`` (the trunk), ``forward``, ``backward`` and ``apply`` (the
    optimizer)."""

    def __init__(self, model, cfg: Config):
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.random_seed)

    def features(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None):
        if "features" in batch:
            return batch["features"].to(self.device)
        images = batch["images"].to(self.device)
        with torch.no_grad():
            if images.dtype == torch.uint8:
                images = train_transform(generator or self.generator, images, self.cfg.crop_size)
            return self.model.backbone_features(images)

    def forward(
        self, features: torch.Tensor, batch: Dict[str, torch.Tensor],
        ss_prob: Union[float, torch.Tensor] = 0.0, generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, token count), the loss still on the autograd graph."""
        captions = batch["captions"].to(self.device)
        lengths = batch["lengths"].to(self.device)
        if self.cfg.scheduled_sampling_start < 0:
            ss_prob = 0.0
        with torch.enable_grad():
            logits, mask, _ = self.model.decode_train(
                features, captions, lengths, generator or self.generator, ss_prob
            )
            return masked_cross_entropy(logits, captions[:, 1:], mask)

    def backward(self, state: TrainState, loss: torch.Tensor) -> Tensors:
        """The gradients of ``loss`` by parameter name."""
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names], allow_unused=True)
        return {n: torch.zeros_like(state.params[n]) if g is None else g for n, g in zip(names, grads)}

    @torch.no_grad()
    def apply(self, state: TrainState, grads: Tensors, lr: float) -> Tuple[TrainState, torch.Tensor]:
        """The update for one step's gradients. Returns (state, grad_norm)."""
        cfg = self.cfg
        grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        finite = bool(torch.isfinite(grad_norm))
        opt = state.opt_state
        applied = True
        if finite or not cfg.skip_nonfinite:
            k = cfg.grad_accum_steps
            if k > 1:
                n = opt["mini_step"]
                for name, acc in opt["acc_grads"].items():
                    acc.copy_(acc + (grads[name] - acc) / (n + 1))
                applied = n == k - 1
                if applied:
                    _adam_update(cfg, opt, state.params, opt["acc_grads"], lr)
                    for acc in opt["acc_grads"].values():
                        acc.zero_()
                opt["mini_step"] = (n + 1) % k
            else:
                _adam_update(cfg, opt, state.params, grads, lr)
            if state.ema_params is not None and cfg.ema_decay > 0 and applied:
                d = cfg.ema_decay
                for name, e in state.ema_params.items():
                    e.copy_(e * d + state.params[name] * (1.0 - d))
        state.step += 1
        return state, grad_norm

    def __call__(
        self, state: TrainState, batch: Dict[str, torch.Tensor], lr: float,
        ss_prob: Union[float, torch.Tensor] = 0.0, generator: Optional[torch.Generator] = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        features = self.features(batch, generator)
        loss, count = self.forward(features, batch, ss_prob, generator)
        grads = self.backward(state, loss)
        state, grad_norm = self.apply(state, grads, lr)
        loss = loss.detach()
        metrics = {"loss": loss, "perplexity": torch.exp(loss), "tokens": count, "grad_norm": grad_norm}
        return state, metrics


def make_train_step(model, cfg: Config) -> TrainStep:
    return TrainStep(model, cfg)


def make_eval_loss_step(model, cfg: Config):
    """``step(batch) -> (loss, token count)``: the teacher-forced loss with
    the training mask (t < len - 1), no dropout; uint8 images get the centre
    crop and normalisation."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor]):
        captions = batch["captions"].to(device)
        lengths = batch["lengths"].to(device)
        if "features" in batch:
            features = batch["features"].to(device)
        else:
            images = batch["images"].to(device)
            if images.dtype == torch.uint8:
                images = eval_transform(images, cfg.crop_size)
            features = model.backbone_features(images)
        logits, mask, _ = model.decode_train(features, captions, lengths)
        return masked_cross_entropy(logits, captions[:, 1:], mask)

    return step
