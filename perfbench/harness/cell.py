"""One cell of ``BENCHMARK.json``, found by name: its configuration file,
its traffic file, its limits file, and the program built from them.

A configuration file holds, beside the benchmark's own keys (``HARNESS``),
the architecture's keys at its top level, named and valued as the model's
public ``config.json`` has them: ``Cell.arch``, which the harness hands to
the program's model and to the model's plug-in and never reads itself.
``model`` holds the program's ``Config`` fields only (run settings). A cut
is documented: ``reduced`` lists each architecture key (or ``vocab_size``)
whose value the cell runs below the published one, ``published`` gives the
published value of each, and ``deployment`` the layout the cut stands for.
A file that breaks any of this stops set-up with a message that names the
key and the fix.

The program is ``show_and_tell_tpu_torch``, imported here and in the
drivers only; the reference (``perfbench/reference``) never imports it.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


#: the benchmark's own keys of a configuration file; every other top-level
#: key is the architecture's
HARNESS = frozenset({"name", "source", "defines", "reduced", "published", "deployment", "model", "vocab_size",
                     "assumed", "weights"})
#: what ``reduced`` may never name: widths (``vocab_size``, a slice of the
#: vocabulary, is not one)
_WIDTH_SUFFIXES = ("_dim", "_rank", "_size")
_WIDTH_KEYS = {"expand", "mlp_ratio", "num_experts_per_tok", "num_experts_per_token", "moe_topk"}


def _stop(config: Dict, message: str):
    raise SystemExit(f"perfbench: configuration {config.get('name', '?')!r}: {message}")


def check_config(config: Dict) -> None:
    """Stop, naming the key and the fix, where a configuration file mixes
    architecture keys into ``model`` or lists a cut it does not document."""
    from show_and_tell_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    model = config.get("model", {})
    for key in model:
        if key not in fields:
            _stop(config, f"'model' holds {key!r}, which is not a field of the program's Config; architecture "
                          f"keys go at the top level of the configuration file, named as the model's config.json "
                          f"names them")
    arch = {k for k in config if k not in HARNESS}
    for key in sorted(arch & set(model)):
        _stop(config, f"{key!r} is both a Config field under 'model' and an architecture key at the top level; "
                      f"keep it in one place")
    reduced, published = config.get("reduced", []), config.get("published", {})
    for key in reduced:
        if key != "vocab_size" and key not in arch:
            _stop(config, f"'reduced' lists {key!r}, which the file does not set: list architecture keys at the "
                          f"top level, or 'vocab_size'")
        if (key.endswith(_WIDTH_SUFFIXES) and key != "vocab_size") or key in _WIDTH_KEYS:
            _stop(config, f"'reduced' lists {key!r}, a width: widths are never cut, only depth, the experts held "
                          f"on this chip and the vocabulary's slice")
        if key not in published or published[key] == config[key]:
            _stop(config, f"'reduced' lists {key!r} without a differing published value: give it under "
                          f"'published' as the model's config.json has it")
    if reduced and not str(config.get("deployment", "")).strip():
        _stop(config, "'reduced' lists a cut without a 'deployment': say which layout the cut stands for")


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

    def __post_init__(self):
        check_config(self.config)

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
    def arch(self) -> Dict:
        """The architecture's keys: the file's top-level keys other than the
        benchmark's own (and any overrides, which only the CPU tests pass);
        ``{}`` where the file has none."""
        own = {k: v for k, v in self.config.items() if k not in HARNESS}
        return {**own, **self.overrides.get("arch", {})}

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
    ``(model, weights)``. A configuration with architecture keys hands them
    to the model's class as ``arch``; one without builds the model through
    ``registry.build_model`` as it always has. The weights are what the
    reference reads: a dict, or where the configuration asks for its tensors
    one by one (``per_tensor``), a mapping that draws each again when read."""
    from show_and_tell_tpu_torch.models import registry

    cfg = cell.port_config()
    arch = cell.arch
    if arch:  # the class the registry holds, called as ``build_model`` calls it, with ``arch``
        cls = registry.MODELS.get(cfg.model)
        if cls is None:
            raise SystemExit(f"perfbench: the program has no model {cfg.model!r}; options: {sorted(registry.MODELS)}")
        model = cls(cfg, cell.vocab_size, device=device, arch=arch)
    else:
        model = registry.build_model(cfg, cell.vocab_size, device=device)
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
