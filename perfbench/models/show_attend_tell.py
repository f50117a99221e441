"""Show-Attend-Tell (Xu et al. 2015, arXiv:1502.03044): soft attention over
the trunk's conv5 grid, one LSTM, the deep output layer.

The plain reference network, the model FLOPs of a window and of a training
step, and the kernels' entry points that traced runs wrap
(``harness.plugins`` says what a model plug-in gives). Every size is a
``Config`` field: ``arch`` is ignored.
"""

from __future__ import annotations

import torch

from harness import bounds
from harness.plugins import Wrap
from reference import models as ref

PROGRAM = "show_and_tell_tpu_torch.models.show_attend_tell"
D = 512  # the conv5 grid's channels


class ShowAttendTell(ref.Net):
    """Soft attention over the conv5 grid, one LSTM, the deep output layer
    ``classifier(c2o(context) + h2o(h))``. The context is the alpha-weighted
    *mean* over the L patches, as the reference implementation divides by L."""

    def start(self, feats):
        """(per-image context, per-row state) before the first word."""
        mean = feats.mean(dim=1)
        h, c = self.lin(mean, "init_h"), self.lin(mean, "init_c")
        ctx_enc = self.q(self.q(feats) @ self.q(self.w["att.w_img"]))
        return (feats, ctx_enc), (h, c)

    def step(self, image, state, tok, rows_per_image: int):
        """One word for every row: rows ``b * k + j`` belong to image b."""
        feats, ctx_enc = image
        h, c = state
        B, L, D = feats.shape
        k = rows_per_image
        hp = self.q(self.q(h) @ self.q(self.w["att.w_hh"]) + self.w["att.b_hh"])
        t = self.q(torch.tanh(ctx_enc[:, None] + hp.view(B, k, 1, D)))  # [B, k, L, D]
        e = self.q(t) @ self.q(self.w["att.w_att"])  # [B, k, L]
        alpha = torch.softmax(e, dim=-1)
        ctx = self.q(torch.einsum("bkl,bld->bkd", self.q(alpha), self.q(feats)).reshape(B * k, D) / L)
        emb = self.w["embed"][tok]
        h, c = self.lstm("lstm", torch.cat([emb, ctx], dim=-1), h, c)
        out = self.lin(ctx, "c2o") + self.lin(h, "h2o")
        return (h, c), self.lin(out, "classifier")

    def first(self, image, state, B: int, k: int):
        """(state per row, logits of the first word per row)."""
        h, c = state
        state = (h.repeat_interleave(k, 0), c.repeat_interleave(k, 0))
        tok = torch.full((B * k,), ref.START_ID, dtype=torch.long, device=h.device)
        return self.step(image, state, tok, k)


def reference(cfg, weights, q, trunk, arch) -> ShowAttendTell:
    return ShowAttendTell(weights, q, trunk)


# --- model FLOPs (multiply-adds count 2) ----------------------------------------


def grid(cfg) -> int:
    return (cfg.crop_size // 16) ** 2


def image_flops(cfg, vocab: int) -> float:
    """Once per image before the first word: ctx_enc, h0 and c0."""
    L, H = grid(cfg), cfg.hidden_size
    return 2.0 * L * D * D + 2 * 2.0 * D * H


def step_flops(cfg, vocab: int) -> float:
    """One decoder step of one row (one word): attention, the cell, the
    head."""
    E, H, V, L = cfg.embed_size, cfg.hidden_size, vocab, grid(cfg)
    attention = 2.0 * H * D + 5.0 * L * D
    cell = 2.0 * (E + D + H) * 4 * H
    head = 2.0 * D * E + 2.0 * H * E + 2.0 * E * V
    return attention + cell + head


def model_flops(cfg, vocab: int, counters, trunk_flops: float, arch) -> float:
    """Every image's trunk and start, and one step per row that the cell
    wraps counted (``decode_row_cells``, one cell call per layer a step)."""
    return (counters["trunk_images"] * (trunk_flops + image_flops(cfg, vocab))
            + counters["decode_row_cells"] * step_flops(cfg, vocab) / cfg.num_layers)


def train_step_flops(cfg, vocab: int, batch: int, caption_len: int, trunk_flops: float, arch) -> float:
    """One teacher-forced step over ``batch`` captions padded to
    ``caption_len``: the frozen trunk forward, the rest forward and backward
    (three times its forward)."""
    return batch * (trunk_flops + 3 * image_flops(cfg, vocab) + 3 * (caption_len - 1) * step_flops(cfg, vocab))


# --- the kernels' entry points, as the model's module calls them ----------------


def _rows(params, x, h, c):
    return {"decode_row_cells": x.shape[0]}


WRAPS = [
    Wrap(PROGRAM + ":lstm_cell", "lstm_cell", bounds.lstm_cell_call, _rows),
    Wrap(PROGRAM + ":attention_beam", "attention_beam", bounds.attention_beam_call),
]
