"""Typed configuration: the ``Config`` dataclass and its defaults.

A field-for-field copy of the JAX package's ``Config``, so that one JSON
config describes a run of either package. Fields that only the JAX package
reads (mesh, Pallas, multi-host) are kept for that reason and are ignored
here. CLI parsing is not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import Any, Optional


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
