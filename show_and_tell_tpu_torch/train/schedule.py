"""Epoch-wise schedules, host-side (plain Python: they feed scalar arguments
to the train step).

- LR: step decay ``lr * rate^((epoch - start) // every)`` once
  ``epoch > start`` (reference train.py:101-107).
- Scheduled sampling: ``min(increase_prob * ((epoch - start) // every),
  max_prob)`` once ``epoch > start`` — the schedule the reference defines in
  config.py:50-57 and comments out in train.py:109-113; implemented here.
"""

from __future__ import annotations

from show_and_tell_tpu_torch.config import Config


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    # -1 disables decay (config contract); 0 means decay from the first
    # epoch boundary, so the guard must be >= 0 (matching ss_prob_for_epoch)
    if cfg.learning_rate_decay_start >= 0 and epoch > cfg.learning_rate_decay_start:
        frac = (epoch - cfg.learning_rate_decay_start) // cfg.learning_rate_decay_every
        return cfg.learning_rate * (cfg.learning_rate_decay_rate ** frac)
    return cfg.learning_rate


def ss_prob_for_epoch(cfg: Config, epoch: int) -> float:
    if cfg.scheduled_sampling_start >= 0 and epoch > cfg.scheduled_sampling_start:
        frac = (epoch - cfg.scheduled_sampling_start) // cfg.scheduled_sampling_increase_every
        return min(
            cfg.scheduled_sampling_increase_prob * frac, cfg.scheduled_sampling_max_prob
        )
    return 0.0
