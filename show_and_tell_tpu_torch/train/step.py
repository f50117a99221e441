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
frozen trunk and the train transform run outside autograd. Reading
whether the gradient norm is finite costs one host synchronisation per
step.

Show-and-Tell's BatchNorm runs in train mode: ``forward`` computes the new
running statistics without writing them, and ``apply`` copies them into
``TrainState.batch_stats`` (the model's buffers) under the same rule as the
parameters, so a step skipped as non-finite leaves them as they were. They
move on every micro-step under gradient accumulation, as the JAX package's
do.

On a mesh (the model placed by ``parallel.mesh.place_params``) the step is
one device's step over the global batch, as the JAX package's one SPMD
program is: each rank holds its rows, the loss is divided by the global
token count, ``backward`` sums the gradients over the data group in one
flat buffer before the clamp and Adam, the global norm sums the squares of
the vocabulary slices over the model group, the random draws are made for
the global batch, and Show-and-Tell's BatchNorm takes the global batch's
statistics. ``gather_train_state`` and ``place_train_state`` carry a state
of vocabulary slices to a file of full tensors and back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from show_and_tell_tpu_torch.ckpt.checkpoint import trainable_state_dict
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data.transforms import eval_transform, train_transform
from show_and_tell_tpu_torch.obs.profiler import span
from show_and_tell_tpu_torch.parallel import mesh as mesh_lib
from show_and_tell_tpu_torch.parallel.collectives import all_reduce
from show_and_tell_tpu_torch.train import graphs as graphs_lib
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
    # Show-and-Tell's BatchNorm running {mean, var} (the model's buffers),
    # else None; the EMA does not cover them
    batch_stats: Optional[Tensors] = None


def _zeros_like(tree: Tensors) -> Tensors:
    return {k: torch.zeros_like(v, memory_format=torch.contiguous_format) for k, v in tree.items()}


def make_train_state(cfg: Config, model) -> TrainState:
    """A fresh state over the model's trainable parameters: Adam's count and
    zero moments, the accumulation state when ``grad_accum_steps`` > 1, a
    copy of the params as the EMA when ``ema_decay`` > 0, and the model's
    batch statistics when it has them."""
    params = trainable_state_dict(model)
    with torch.no_grad():
        opt_state: Dict[str, Any] = {"count": 0, "mu": _zeros_like(params), "nu": _zeros_like(params)}
        if cfg.grad_accum_steps > 1:
            opt_state.update(mini_step=0, acc_grads=_zeros_like(params))
        ema = {k: v.detach().clone() for k, v in params.items()} if cfg.ema_decay > 0 else None
    return TrainState(params=params, opt_state=opt_state, step=0, ema_params=ema,
                      batch_stats=model.batch_stats)


def gather_train_state(mesh, state: TrainState, shardings) -> TrainState:
    """The full train state of a state of vocabulary slices (every rank of
    the mesh calls this): the params, Adam's moments, the accumulated
    gradients and the EMA gathered over the model group. Replicated tensors
    are the state's own, not copies."""

    def full(tree):
        return None if tree is None else mesh_lib.gather_params(mesh, tree, shardings)

    opt = dict(state.opt_state)
    for k in ("mu", "nu", "acc_grads"):
        if k in opt:
            opt[k] = full(opt[k])
    return TrainState(params=full(state.params), opt_state=opt, step=state.step,
                      ema_params=full(state.ema_params), batch_stats=state.batch_stats)


@torch.no_grad()
def place_train_state(mesh, full: TrainState, state: TrainState, shardings) -> TrainState:
    """Copy this rank's slices of a full train state (one restored from a
    file) into ``state``'s tensors, the model's parameters among them: the
    counterpart of the JAX package's ``place_train_state``. Returns
    ``state``."""

    def put(dst, src):
        for k, t in (dst or {}).items():
            s = mesh_lib.local_slice(mesh, src[k], shardings.get(k))
            if s.data_ptr() != t.data_ptr():
                t.copy_(s)

    opt, fopt = state.opt_state, full.opt_state
    put(state.params, full.params)
    for k in ("mu", "nu", "acc_grads"):
        if k in opt:
            put(opt[k], fopt[k])
    put(state.ema_params, full.ema_params)
    put(state.batch_stats, full.batch_stats)
    opt["count"] = fopt["count"]
    if "mini_step" in opt:
        opt["mini_step"] = fopt["mini_step"]
    state.step = full.step
    return state


def _sum_over_data(grads: Tensors, mesh) -> Tensors:
    """The gradients summed over the data group, in one flat buffer."""
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads.values()]), mesh.data_group)
    parts = torch.split(flat, [g.numel() for g in grads.values()])
    return {k: p.view_as(g) for (k, g), p in zip(grads.items(), parts)}


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
    ``features`` (the trunk's output: [B, L, 512] for Show-Attend-Tell,
    [B, 2048] for Show-and-Tell) or ``images`` [B, H, W, 3] (uint8 images get
    the random crop, flip and normalisation). ``generator`` (on the model's
    device) drives the crop, the flips, scheduled sampling and dropout; the
    step owns one seeded from ``cfg.random_seed`` for calls without it.
    ``ss_prob`` is read only when ``cfg.scheduled_sampling_start`` >= 0;
    otherwise the step runs the teacher-forcing fast path.

    Metrics (device tensors): loss, perplexity, tokens, and grad_norm, the
    global norm of the gradients before the clamp.

    The phases are methods, so that a caller can time them apart:
    ``features`` (the trunk), ``forward``, ``backward`` and ``apply`` (the
    optimizer). Each runs inside its span (``obs.profiler``), ``train.step``
    around them all, and the finite read inside ``train.apply.sync``.

    ``forward`` and ``backward`` replay CUDA graphs (``train.graphs``), one
    pair per padded shape, where the call allows it (``graphable``): CUDA
    tensors, no mesh across processes, the teacher-forcing fast path and a
    forward that draws no random numbers (no dropout). A shape is captured
    the first time it is seen, up to ``graphs.MAX_KEYS`` shapes; the rest, and
    every other call, run eagerly. The arithmetic is the eager path's, by
    the same kernels in the same order. The trunk and ``apply`` always run
    eagerly. The graphs' gradients are buffers that the next replay
    rewrites: ``apply`` consumes them first. ``cuda_lib.LAUNCHES`` counts a
    graphed shape's kernels in its warm-up runs and its capture, not at its
    replays; the recording's ``train.graph_captures``,
    ``train.graph_replays`` and ``train.eager_steps`` count the forwards of
    each kind.

    On a mesh (``model.mesh``) the batch is this rank's rows of the global
    batch and ``generator`` draws the global batch's numbers on every rank;
    the metrics are the global batch's."""

    def __init__(self, model, cfg: Config):
        self.model = model
        self.cfg = cfg
        self.mesh = getattr(model, "mesh", None)
        self.shardings = mesh_lib.model_shardings(model)
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.random_seed)
        # the running statistics of the last forward, which apply commits
        self.new_stats: Optional[Tensors] = None
        self.graphs = graphs_lib.StepGraphs()
        # the leaves the graphed forward differentiates by, and the names of
        # Show-and-Tell's running statistics, which it also returns
        self._leaves = list(trainable_state_dict(model).values())
        self._stat_names = tuple(model.batch_stats or ())

    def features(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None):
        with span("train.features"):
            if "features" in batch:
                return batch["features"].to(self.device)
            images = batch["images"].to(self.device)
            with torch.no_grad():
                if images.dtype == torch.uint8:
                    images = train_transform(generator or self.generator, images, self.cfg.crop_size, mesh=self.mesh)
                return self.model.backbone_features(images)

    def forward(
        self, features: torch.Tensor, batch: Dict[str, torch.Tensor],
        ss_prob: Union[float, torch.Tensor] = 0.0, generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, token count), the loss still on the autograd graph. For
        Show-and-Tell it also keeps the BatchNorm's new running statistics
        in ``self.new_stats`` for ``apply``."""
        captions = batch["captions"].to(self.device)
        lengths = batch["lengths"].to(self.device)
        if self.cfg.scheduled_sampling_start < 0:
            ss_prob = 0.0
        with span("train.forward"), torch.enable_grad():
            out = None
            if self.graphable(features, ss_prob):
                # the graphs read the leaves and the running statistics where
                # they are: a key holds their addresses, so that moved storage
                # is captured anew
                in_place = self._leaves + [self.model.batch_stats[n] for n in self._stat_names]
                key = (features.device, *((t.dtype, tuple(t.shape)) for t in (features, captions, lengths)),
                       *(t.data_ptr() for t in in_place))
                out = self.graphs(self._loss, key, (features, captions, lengths), self._leaves)
            if out is None:
                graphs_lib.count("train.eager_steps")
                out = self._loss(features, captions, lengths, generator or self.generator, ss_prob)
            loss, count, *stats = out
            self.new_stats = dict(zip(self._stat_names, stats)) or None
            return loss, count

    def graphable(self, features: torch.Tensor, ss_prob: Union[float, torch.Tensor]) -> bool:
        """Whether ``forward`` and ``backward`` may replay CUDA graphs for
        this call: CUDA features, no mesh across processes, the
        teacher-forcing fast path (``ss_prob`` the Python number 0) and no
        dropout, so that the forward draws no random numbers."""
        return (features.is_cuda and not (self.mesh is not None and self.mesh.distributed)
                and isinstance(ss_prob, (int, float)) and float(ss_prob) == 0.0
                and getattr(self.model, "dropout_rate", 0.0) == 0.0)

    def _loss(self, features, captions, lengths, generator=None, ss_prob=0.0) -> Tuple[torch.Tensor, ...]:
        """(loss, token count, *the new running statistics)."""
        if hasattr(self.model, "encode"):  # Show-and-Tell: projection + BatchNorm
            feat_embed, new_stats = self.model.encode(features, train=True)
            logits, mask = self.model.decode_train(feat_embed, captions, lengths, generator, ss_prob)
        else:
            new_stats = {}
            logits, mask, _ = self.model.decode_train(features, captions, lengths, generator, ss_prob)
        loss, count = masked_cross_entropy(logits, captions[:, 1:], mask, self.mesh)
        return (loss, count, *(new_stats[n] for n in self._stat_names))

    def backward(self, state: TrainState, loss: torch.Tensor) -> Tensors:
        """The gradients of ``loss`` by parameter name, over a mesh summed
        over the data group: the global batch's."""
        with span("train.backward"):
            names = list(state.params)
            grads = torch.autograd.grad(loss, [state.params[n] for n in names], allow_unused=True)
            grads = {n: torch.zeros_like(state.params[n]) if g is None else g for n, g in zip(names, grads)}
            if self.mesh is not None and self.mesh.distributed:
                grads = _sum_over_data(grads, self.mesh)
            return grads

    def _grad_norm(self, grads: Tensors) -> torch.Tensor:
        """The global norm: the squares of the vocabulary slices summed over
        the model group, the replicated gradients counted once."""
        split = {k for k, ax in self.shardings.items() if ax is not None}
        if not split:
            return torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        sq = {s: sum((g.float() ** 2).sum() for k, g in grads.items() if (k in split) == s) for s in (False, True)}
        return torch.sqrt(sq[False] + all_reduce(sq[True], self.mesh.model_group))

    @torch.no_grad()
    def apply(self, state: TrainState, grads: Tensors, lr: float) -> Tuple[TrainState, torch.Tensor]:
        """The update for one step's gradients, and the running statistics
        of the forward before it. Returns (state, grad_norm)."""
        with span("train.apply"):
            cfg = self.cfg
            grad_norm = self._grad_norm(grads)
            with span("train.apply.sync"):
                finite = bool(torch.isfinite(grad_norm))
            opt = state.opt_state
            new_stats, self.new_stats = self.new_stats, None
            applied = True
            if finite or not cfg.skip_nonfinite:
                if new_stats is not None:
                    for name, v in state.batch_stats.items():
                        v.copy_(new_stats[name])
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
        with span("train.step"):
            features = self.features(batch, generator)
            loss, count = self.forward(features, batch, ss_prob, generator)
            grads = self.backward(state, loss)
            state, grad_norm = self.apply(state, grads, lr)
            loss = loss.detach()
            if self.mesh is not None and self.mesh.distributed:
                loss = all_reduce(loss, self.mesh.data_group)
            metrics = {"loss": loss, "perplexity": torch.exp(loss), "tokens": count, "grad_norm": grad_norm}
        return state, metrics


def make_train_step(model, cfg: Config) -> TrainStep:
    return TrainStep(model, cfg)


def make_eval_loss_step(model, cfg: Config):
    """``step(batch) -> (loss, token count)``: the teacher-forced loss with
    the training mask (t < len - 1), no dropout, Show-and-Tell's BatchNorm
    on its running statistics; uint8 images get the centre crop and
    normalisation."""
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
        if hasattr(model, "encode"):  # Show-and-Tell
            feat_embed, _ = model.encode(features, train=False)
            logits, mask = model.decode_train(feat_embed, captions, lengths)
        else:
            logits, mask, _ = model.decode_train(features, captions, lengths)
        return masked_cross_entropy(logits, captions[:, 1:], mask)

    return step
