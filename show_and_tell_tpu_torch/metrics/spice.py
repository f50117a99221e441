"""SPICE — semantic propositional caption evaluation (optional).

The reference wrapper shells out to ``spice-1.0.jar`` plus the Stanford
scene-graph parser (spice.py:63-70) — but the main jar is **absent** from the
repo (only the 16 dependency jars ship, SURVEY.md §2.2), so SPICE is de facto
optional there: any attempt to run it fails. This module preserves that
contract explicitly: the same ``compute_score(gts, res)`` API, raising
``SpiceUnavailable`` (or returning a disabled marker when ``strict=False``)
with an actionable message, and a hook (``set_backend``) where a real
scene-graph scorer can be plugged in.

Unlike the reference (where SPICE always crashes), a **built-in backend** is
installed by default: the rule-based scene-graph parser + tuple F-score in
``metrics/scene_graph.py``. It is a documented approximation of the Java
scorer (no CoreNLP dependency parse), qualified in docs/PARITY.md. Disable
with ``set_backend(None)`` to reproduce the reference's de-facto behavior,
or install a stronger parser via ``set_backend``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


class SpiceUnavailable(RuntimeError):
    pass


_BACKEND: Optional[Callable] = None
_DEFAULT_INSTALLED = False


def set_backend(fn: Optional[Callable]) -> None:
    """Install a callable ``fn(gts, res) -> (score, scores)`` as the SPICE
    implementation (e.g. a local scene-graph parser service). ``None``
    disables SPICE entirely (the reference's de-facto state)."""
    global _BACKEND, _DEFAULT_INSTALLED
    _BACKEND = fn
    _DEFAULT_INSTALLED = True  # explicit choice overrides the lazy default


def use_builtin_backend() -> None:
    """Install the built-in rule-based scene-graph backend
    (metrics/scene_graph.py)."""
    from show_and_tell_tpu_torch.metrics.scene_graph import spice_backend

    set_backend(spice_backend)


def _ensure_default() -> None:
    """Lazily install the builtin backend on first use (lazy so importing
    the metrics package never pays the parser import)."""
    global _DEFAULT_INSTALLED
    if not _DEFAULT_INSTALLED:
        use_builtin_backend()


def cached_backend(fn: Callable, cache_path: str) -> Callable:
    """Wrap a SPICE backend with a persistent per-image score cache — the
    equivalent of the Java scorer's LMDB parse cache (the reference wrapper
    allocates one at spice.py:53-58). Keyed by (hypothesis, sorted refs);
    only uncached images hit the expensive backend."""
    import hashlib
    import json
    import os

    def load() -> dict:
        if os.path.exists(cache_path):
            with open(cache_path) as f:
                return json.load(f)
        return {}

    def key(hypo: str, refs) -> str:
        blob = hypo + "\x00" + "\x00".join(sorted(refs))
        return hashlib.sha256(blob.encode()).hexdigest()

    def all_f(s) -> float:
        # builtin-backend scores are per-category dicts (the reference
        # wrapper's shape, spice.py:78-91); custom backends may return bare
        # floats — average works for both
        return float(s["All"]["f"]) if isinstance(s, dict) else float(s)

    def wrapped(gts, res):
        cache = load()
        ids = sorted(gts.keys())
        keys = {i: key(res[i][0], gts[i]) for i in ids}
        missing = [i for i in ids if keys[i] not in cache]
        if missing:
            sub_gts = {i: gts[i] for i in missing}
            sub_res = {i: res[i] for i in missing}
            _, scores = fn(sub_gts, sub_res)
            for i, s in zip(sorted(missing), scores):
                cache[keys[i]] = s if isinstance(s, dict) else float(s)
            tmp = cache_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(cache, f)
            os.replace(tmp, cache_path)
        per_image = [cache[keys[i]] for i in ids]
        mean = sum(all_f(s) for s in per_image) / max(len(per_image), 1)
        return float(mean), per_image

    return wrapped


class Spice:
    def __init__(self, strict: bool = True):
        self.strict = strict

    def available(self) -> bool:
        _ensure_default()
        return _BACKEND is not None

    def compute_score(self, gts: Dict, res: Dict):
        _ensure_default()
        if _BACKEND is not None:
            return _BACKEND(gts, res)
        msg = (
            "SPICE backend disabled (set_backend(None)): the reference repo "
            "ships only the dependency jars, not spice-1.0.jar "
            "(pycocoevalcap/spice/spice.py:12), so SPICE never ran there. "
            "Re-enable via spice.use_builtin_backend() or set_backend()."
        )
        if self.strict:
            raise SpiceUnavailable(msg)
        return None, None

    def method(self):
        return "SPICE"
