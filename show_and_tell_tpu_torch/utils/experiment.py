"""Experiment directory management (reference main.py:15-20).

Creates ``<expr_dir>/<user_id>/<exp_id>/`` and returns the resolved path;
config is persisted there as JSON (see config.save_config). Checkpoints and
info histories (ckpt module) live under the same root, mirroring the
reference's ``infos.pkl`` / ``model-best.pth`` layout (train.py:180-196).
"""

from __future__ import annotations

import os

from show_and_tell_tpu_torch.config import Config, save_config


def make_experiment_dir(cfg: Config) -> Config:
    path = os.path.join(cfg.expr_dir, cfg.user_id, cfg.exp_id)
    os.makedirs(path, exist_ok=True)
    cfg = cfg.replace(expr_dir=path)
    save_config(cfg)
    return cfg
