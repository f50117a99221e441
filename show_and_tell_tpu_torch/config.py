"""Typed configuration: the ``Config`` dataclass and its defaults.

A field-for-field copy of the JAX package's ``Config``, so that one JSON
config describes a run of either package. Fields that only the JAX package
reads (mesh, Pallas, multi-host) are kept for that reason and are ignored
here. The CLI parser is generated from the dataclass, as in the JAX package,
so the same argv gives the same config in both.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, fields
from typing import Any, List, Optional


@dataclass
class Config:
    # --- data input ---
    root_dir: str = "."
    data_json: str = "data/data.json"
    vocab_path: str = "data/vocab.json"
    crop_size: int = 224
    batch_size: int = 128

    # --- devices / reproducibility ---
    num_devices: int = 0
    model_parallel: int = 1
    multihost: bool = False
    coordinator_address: Optional[str] = None
    random_seed: int = 123

    # --- experiment management ---
    expr_dir: str = "experiment"
    exp_id: str = "showattendtell"
    user_id: str = "default"
    start_from: Optional[str] = None

    # --- model dims ---
    model: str = "show_attend_tell"  # or "show_tell"
    encoder: str = "vgg16"
    embed_size: int = 512
    hidden_size: int = 1024
    num_layers: int = 1
    encoder_weights: Optional[str] = None

    # --- checkpoint / resume ---
    load_best_score: bool = True
    load_model_path: Optional[str] = None
    load_optim_path: Optional[str] = None
    load_pretrained: bool = False
    torch_checkpoint: Optional[str] = None

    # --- optimization ---
    learning_rate: float = 1e-3
    grad_accum_steps: int = 1
    ema_decay: float = 0.0
    max_epochs: int = 20
    learning_rate_decay_start: int = 1
    learning_rate_decay_every: int = 3
    learning_rate_decay_rate: float = 0.8
    grad_clip: float = 0.1

    # --- scheduled sampling ---
    scheduled_sampling_start: int = -1
    scheduled_sampling_increase_every: int = 5
    scheduled_sampling_increase_prob: float = 0.05
    scheduled_sampling_max_prob: float = 0.25

    # --- logging / eval cadence ---
    log_step: int = 10
    language_eval: int = 1
    save_checkpoint_every: int = 3000
    preempt_save: bool = True
    rss_preempt_gb: float = 0.0

    # --- decoding ---
    max_decode_len: int = 20
    beam_size: int = 3
    length_penalty: float = 0.0  # GNMT ((5+len)/6)^alpha; 0 = raw sum-logprob

    # --- preprocessing ---
    caption_json: Optional[str] = None
    output_json: str = "data/data.json"
    images_root: Optional[str] = None
    word_count_threshold: int = 5
    print_stats: bool = True

    # --- data pipeline ---
    num_workers: int = 8
    prefetch_depth: int = 2
    max_caption_len: int = 57
    num_buckets: int = 4
    native_decode: Optional[bool] = None
    on_corrupt: str = "substitute"
    features_path: Optional[str] = None
    memmap_dir: Optional[str] = None
    attention_dir: Optional[str] = None

    # --- eval data ---
    ann_file: Optional[str] = None

    # --- compute ---
    dtype: str = "float32"  # compute dtype; "bfloat16" = bf16 with fp32 state
    quantize_backbone: bool = False
    quantized_backbone_path: Optional[str] = None
    use_pallas: Optional[bool] = None
    donate: bool = True
    skip_nonfinite: bool = True

    # --- observability ---
    profile_dir: Optional[str] = None
    profile_step: int = -1

    # derived at run time, persisted for the record
    current_lr: float = 1e-3
    ss_prob: float = 0.0

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _add_field_arg(parser: argparse.ArgumentParser, f: dataclasses.Field) -> None:
    # ``from __future__ import annotations`` makes ``f.type`` a string, so the
    # type is picked by its name; ``Optional[...]`` fields other than
    # ``Optional[bool]`` parse as strings, as in the JAX package
    name = "--" + f.name
    default = f.default if f.default is not dataclasses.MISSING else None
    if f.type in ("bool", bool, "Optional[bool]"):
        parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"), default=default)
    elif f.type in ("int", int):
        parser.add_argument(name, type=int, default=default)
    elif f.type in ("float", float):
        parser.add_argument(name, type=float, default=default)
    else:
        parser.add_argument(name, type=str, default=default)


def parse_config(argv: Optional[List[str]] = None) -> Config:
    """A ``Config`` from CLI flags: every field is ``--field_name``."""
    parser = argparse.ArgumentParser(description="show_and_tell_tpu_torch")
    for f in fields(Config):
        _add_field_arg(parser, f)
    return Config.from_dict(vars(parser.parse_args(argv)))


def save_config(cfg: Config, path: Optional[str] = None) -> str:
    """Write the config as JSON, by default to
    ``<expr_dir>/config_expr_<exp_id>.json``."""
    if path is None:
        os.makedirs(cfg.expr_dir, exist_ok=True)
        path = os.path.join(cfg.expr_dir, f"config_expr_{cfg.exp_id}.json")
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=2, sort_keys=True)
    return path


def load_config(path: str) -> Config:
    with open(path) as f:
        return Config.from_dict(json.load(f))
