"""What belongs to one model or one trunk, in files of its own, found by name.

A configuration's ``model`` names ``perfbench/models/<model>.py`` and its
``encoder`` names ``perfbench/models/encoders/<encoder>.py``. A plug-in
imports nothing of the program: it names the program's entry points that a
traced run wraps as ``"module:function"`` strings, which
``harness.instrument`` resolves at run time.

A model plug-in gives, where ``cfg`` is the program's ``Config`` (run
settings) and ``arch`` the cell's architecture (``Cell.arch``: the keys of
the configuration file's top level that are the model's own, as its public
``config.json`` names them; ``{}`` for a model that has none):
- ``reference(cfg, weights, q, trunk, arch)``: the plain reference network,
  a ``reference.models.Net`` with ``start``, ``first`` and ``step`` as
  ``beam_search`` and ``replay`` take it, whose ``features`` run ``trunk``;
- ``model_flops(cfg, vocab, counters, trunk_flops, arch)``: the model FLOPs
  of a traced serving window from its counters, given one image's trunk
  FLOPs;
- ``WRAPS``: the program's entry points to wrap, each a ``Wrap``;
- for a model that the training driver runs, ``train_step_flops(cfg, vocab,
  batch, caption_len, trunk_flops, arch)``: one training step's model FLOPs.
The harness reads no key of ``arch``: only the plug-in and the program's
model do.

A trunk plug-in gives ``features(net, x_nchw)``, the reference trunk over
the weights under ``encoder.``, and ``flops(cfg)``, one image's trunk FLOPs.

A model or a trunk without its file stops set-up with the file's path: no
plug-in ever stands in for another.
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, Dict, Optional, Tuple

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclass(frozen=True)
class Wrap:
    """A program entry point that traced runs wrap where its callers look it
    up: ``target`` is ``"module:function"``; ``span`` labels its range
    (``perfbench.<span>``) and its counters ``<span>_calls`` and
    ``<span>_bound_s``; ``bound(*args, **kw)`` is the least milliseconds of
    the call from its shapes (``harness.bounds``); ``adds(*args, **kw)``
    gives any further counters the call adds."""

    target: str
    span: str
    bound: Callable[..., float]
    adds: Optional[Callable[..., Dict[str, float]]] = None


def _load(kind: str, *where: str) -> ModuleType:
    name = where[-1]
    rel = os.path.join("perfbench", *where[:-1], name + ".py")
    path = os.path.join(BENCH, *where[:-1], name + ".py")
    if not _NAME.fullmatch(name) or not os.path.isfile(path):
        raise SystemExit(f"perfbench: no plug-in for {kind} {name!r}: {rel} is missing")
    key = f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    mod = sys.modules.get(key)
    if mod is None or getattr(mod, "__file__", None) != path:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod


def model(name: str) -> ModuleType:
    """The plug-in of model ``name``: ``perfbench/models/<name>.py``."""
    return _load("model", "models", name)


def encoder(name: str) -> ModuleType:
    """The plug-in of trunk ``name``: ``perfbench/models/encoders/<name>.py``."""
    return _load("encoder", "models", "encoders", name)


def of(cfg) -> Tuple[ModuleType, ModuleType]:
    """The model's and the trunk's plug-ins of ``cfg``."""
    return model(cfg.model), encoder(cfg.encoder)


def reference(cfg, weights, arch: Dict, q=None):
    """The plain reference of ``cfg`` and ``arch``: its model's network over
    its trunk, reading ``weights`` (computed under ``q``, where given)."""
    net, trunk = of(cfg)
    return net.reference(cfg, weights, q, trunk.features, arch)


def model_flops(cfg, vocab: int, counters, arch: Dict) -> float:
    """The model FLOPs of a traced serving window, from its counters."""
    net, trunk = of(cfg)
    return net.model_flops(cfg, vocab, counters, trunk.flops(cfg), arch)
