"""Model registry of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models.show_attend_tell import ShowAttendTell
from show_and_tell_tpu_torch.models.show_tell import ShowTell

MODELS = {"show_tell": ShowTell, "show_attend_tell": ShowAttendTell}


def build_model(
    cfg: Config,
    vocab_size: int,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
):
    try:
        cls = MODELS[cfg.model]
    except KeyError:
        raise ValueError(f"unknown model {cfg.model!r}; options: {sorted(MODELS)}") from None
    return cls(cfg, vocab_size, device=device, generator=generator)
