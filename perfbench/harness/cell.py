"""One cell of ``BENCHMARK.json``, found by name: its configuration file,
its traffic file, its limits file, and the program built from them.

The program is ``show_and_tell_tpu_torch``, imported here and in the
drivers only; the reference (``perfbench/reference``) never imports it.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from harness import traffic, weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "perfbench")


def manifest() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(*parts) -> Dict:
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: Dict
    mix: Dict
    limits: Dict
    chips: int = 1
    overrides: Dict = field(default_factory=dict)

    @classmethod
    def find(cls, name: str, overrides: Optional[Dict] = None) -> "Cell":
        """The cell of ``BENCHMARK.json`` by its name."""
        wl = next((w for w in manifest()["workloads"] if w["name"] == name), None)
        if wl is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        return cls(
            name=name, config_name=wl["config"], traffic_name=wl["traffic"],
            config=_json("configs", wl["config"] + ".json"), mix=traffic.load(wl["traffic"]),
            limits=_json("limits", name + ".json"), chips=wl["chips"], overrides=dict(overrides or {}),
        )

    def port_config(self):
        """The program's ``Config`` for this configuration (and any
        overrides, which only the CPU tests pass)."""
        from show_and_tell_tpu_torch.config import Config

        return Config(**{**self.config["model"], **self.overrides.get("model", {})})

    @property
    def vocab_size(self) -> int:
        return int(self.overrides.get("vocab_size", self.config["vocab_size"]))

    def vocabulary(self):
        """Words ``w4`` ... ``w<V-1>`` after the four special tokens."""
        from show_and_tell_tpu_torch.utils.vocab import Vocabulary

        return Vocabulary.from_words(f"w{i}" for i in range(4, self.vocab_size))

    def mix_value(self, key: str):
        return self.overrides.get("mix", {}).get(key, self.mix[key])


DRIVERS = {"bulk": "harness.bulk", "train": "harness.train"}


def driver(cell: Cell, seed: int, device, run):
    """The driver of the cell's traffic kind (``bulk``, ``train``)."""
    import importlib

    return importlib.import_module(DRIVERS[cell.mix["kind"]]).Driver(cell, seed, device, run)


def build_model(cell: Cell, seed: int, device):
    """The program's model with the benchmark's weights for ``seed``:
    ``(model, weights)``, the weights what the reference reads: a dict, or
    where the configuration asks for its tensors one by one
    (``per_tensor``), a mapping that draws each again when read."""
    from show_and_tell_tpu_torch.models.registry import build_model as port_build

    cfg = cell.port_config()
    model = port_build(cfg, cell.vocab_size, device=device)
    opts = {**cell.config.get("weights", {}), **cell.overrides.get("weights", {})}
    wseed = traffic.substream(seed, traffic.WEIGHTS)
    if opts.pop("per_tensor", False):
        return model, weights.fill(model.state_dict(), wseed, device, **opts)
    w = weights.make(weights.shapes_of(model.state_dict()), wseed, device, **opts)
    model.load_state_dict(w)
    return model, w


def free_program() -> None:
    """Once the caller has dropped its references to the program's objects:
    return their memory to the device, so that the reference runs in what
    they held."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def full_fp32():
    """TF32 off for the reference's products and convolutions."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sample_rows(n: int, k: int, seed: int, longest: np.ndarray) -> np.ndarray:
    """``k`` distinct row indices of ``n``, drawn from the seed, with the
    rows of ``longest`` (the longest served outputs) among them."""
    rng = np.random.default_rng(traffic.substream(seed, traffic.SAMPLE))
    keep = list(dict.fromkeys(int(i) for i in longest))[:k]
    kept = set(keep)
    rest = [int(i) for i in rng.permutation(n) if int(i) not in kept]
    return np.array(keep + rest[: k - len(keep)], dtype=np.int64)
