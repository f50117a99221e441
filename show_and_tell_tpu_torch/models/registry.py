"""Model registry of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models.show_attend_tell import ShowAttendTell

MODELS = {"show_attend_tell": ShowAttendTell}
NOT_PORTED = {"show_tell"}


def build_model(
    cfg: Config,
    vocab_size: int,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
):
    if cfg.model in NOT_PORTED:
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported to PyTorch yet; see ROADMAP.md"
        )
    try:
        cls = MODELS[cfg.model]
    except KeyError:
        raise ValueError(f"unknown model {cfg.model!r}; options: {sorted(MODELS)}") from None
    return cls(cfg, vocab_size, device=device, generator=generator)
