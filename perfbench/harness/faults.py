"""Faults planted in the program underneath a run, to read what the checks
make of them: the CPU tests drive whole runs with each, and
``control.py --faults`` reads them on the chip at a cell's size.

- ``altered_token``: the decode's ids with the second word of every row
  replaced by another, where the decode produces them;
- ``beam_width_1``: the decode searching one beam where the configuration
  states its beam width;
- ``state_unchanged``: a training step that leaves parameters and
  optimizer state as they were;
- ``half_batch``: a training step whose loss is the mean over the first
  half of the batch only.
"""

from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def altered_token(vocab_size: int):
    from show_and_tell_tpu_torch import serve

    def make(orig):
        def decode_ids(*a, **kw):
            ids = orig(*a, **kw).clone()
            ids[:, 1] = 4 + (ids[:, 1] + 7 - 4) % (vocab_size - 4)
            return ids

        return decode_ids

    return _patched(serve, "decode_ids", make)


def beam_width_1(vocab_size: int = 0):
    from show_and_tell_tpu_torch import serve

    def make(orig):
        def decode_ids(model, cfg, *a, **kw):
            return orig(model, dataclasses.replace(cfg, beam_size=1), *a, **kw)

        return decode_ids

    return _patched(serve, "decode_ids", make)


def state_unchanged(vocab_size: int = 0):
    from show_and_tell_tpu_torch.train.step import TrainStep

    def make(orig):
        def apply(self, state, grads, lr):
            self.new_stats = None
            state.step += 1
            return state, self._grad_norm(grads)

        return apply

    return _patched(TrainStep, "apply", make)


def half_batch(vocab_size: int = 0):
    from show_and_tell_tpu_torch.train.step import TrainStep

    def make(orig):
        def forward(self, features, batch, *a, **kw):
            n = features.shape[0] // 2
            return orig(self, features[:n], {k: v[:n] for k, v in batch.items()}, *a, **kw)

        return forward

    return _patched(TrainStep, "forward", make)


FAULTS = {"altered_token": altered_token, "beam_width_1": beam_width_1, "state_unchanged": state_unchanged, "half_batch": half_batch}
