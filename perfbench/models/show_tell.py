"""Show-and-Tell (Vinyals et al. 2015, arXiv:1411.4555): the trunk's pooled
feature, projected and batch-normalised, is the first input of an N-layer
LSTM; every later step reads the previous word.

The plain reference network, the model FLOPs of a window, and the kernels'
entry points that traced runs wrap (``harness.plugins`` says what a model
plug-in gives). Every size is a ``Config`` field: ``arch`` is ignored.
"""

from __future__ import annotations

from harness import bounds
from harness.plugins import Wrap
from reference import models as ref

PROGRAM = "show_and_tell_tpu_torch.models.show_tell"
FEATURE = 2048  # the pooled trunk feature's width


class ShowTell(ref.Net):
    """Image embedding (projection, BatchNorm on its running statistics) as
    the LSTM's first input; every later step reads the previous word."""

    def __init__(self, w, q=None, trunk=None, layers: int = 1):
        super().__init__(w, q, trunk)
        self.layers = layers

    def _stack(self, x, state):
        new = []
        for i, (h, c) in enumerate(state):
            h, c = self.lstm(f"lstm.{i}", x, h, c)
            new.append((h, c))
            x = h
        return new, self.lin(x, "out")

    def start(self, feats):
        emb = self.bn(self.lin(feats, "proj"), "bn", axis=-1)
        H = self.w["lstm.0.b"].shape[0] // 4
        zero = feats.new_zeros(feats.shape[0], H)
        state, logits = self._stack(emb, [(zero, zero)] * self.layers)
        return logits, state

    def step(self, image, state, tok, rows_per_image: int):
        return self._stack(self.w["embed"][tok], state)

    def first(self, image, state, B: int, k: int):
        logits, state = image, state
        state = [(h.repeat_interleave(k, 0), c.repeat_interleave(k, 0)) for h, c in state]
        return state, logits.repeat_interleave(k, 0)


def reference(cfg, weights, q, trunk, arch) -> ShowTell:
    return ShowTell(weights, q, trunk, cfg.num_layers)


# --- model FLOPs (multiply-adds count 2) ----------------------------------------


def image_flops(cfg, vocab: int) -> float:
    """Once per image before the first word: the projection."""
    return 2.0 * FEATURE * cfg.embed_size


def step_flops(cfg, vocab: int) -> float:
    """One decoder step of one row (one word): the cells, the head."""
    E, H, V = cfg.embed_size, cfg.hidden_size, vocab
    cells = sum(2.0 * ((E if i == 0 else H) + H) * 4 * H for i in range(cfg.num_layers))
    return cells + 2.0 * H * V


def model_flops(cfg, vocab: int, counters, trunk_flops: float, arch) -> float:
    """Every image's trunk and projection, and one step per row that the
    cell wraps counted (``decode_row_cells``, one cell call per layer a
    step)."""
    return (counters["trunk_images"] * (trunk_flops + image_flops(cfg, vocab))
            + counters["decode_row_cells"] * step_flops(cfg, vocab) / cfg.num_layers)


# --- the kernels' entry points, as the model's module calls them ----------------


def _rows(params, x, h, c):
    return {"decode_row_cells": x.shape[0]}


WRAPS = [Wrap(PROGRAM + ":lstm_cell", "lstm_cell", bounds.lstm_cell_call, _rows)]
