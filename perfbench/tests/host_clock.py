"""CPU stand-ins for the card's clocks, so that a CPU test can drive a traced
run: ``torch.cuda.synchronize`` returns at once and ``Run.device_timer``
records nothing. Only tests install them; a benchmark run without a card
stops before it measures anything."""

import contextlib

import torch

from harness.trace import Run


def install(setattr_) -> None:
    """Install both through ``setattr_`` (``monkeypatch.setattr``, say)."""
    setattr_(torch.cuda, "synchronize", lambda *a, **kw: None)
    setattr_(Run, "device_timer", lambda self, name: contextlib.nullcontext())
