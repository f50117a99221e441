"""Corpus BLEU-1..4, JVM/Py2-free, matching the vendored scorer bit-for-bit.

Semantics reproduced from the reference's ``pycocoevalcap/bleu``
(bleu_scorer.py), which the metric-parity gate requires exactly:

- n-gram counts over whitespace tokens for n = 1..4 (precook,
  bleu_scorer.py:23-33),
- clipped correct counts against per-ngram max reference counts
  (cook_refs/cook_test, bleu_scorer.py:36-83),
- effective reference length option: "closest" (|refs| > 1) or "average"
  (single segment) — the auto-selection of bleu_scorer.py:225-226 used via
  ``Bleu.compute_score`` (bleu.py:40),
- the tiny/small epsilons (1e-15 / 1e-9) in every ratio
  (bleu_scorer.py:219-220,245,253),
- brevity penalty ``exp(1 - 1/ratio)`` applied when ratio < 1, both per image
  and corpus-level (bleu_scorer.py:252-256,268-271),
- per-image scores use each image's own counts (not corpus-incremental).

API contract identical to the reference ``Bleu`` class: ``compute_score(gts,
res) -> ([b1, b2, b3, b4], [[per-img b1], ...])`` over id-keyed dicts of
tokenized caption strings.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

TINY = 1e-15
SMALL = 1e-9


def ngram_counts(s: str, n: int = 4) -> Tuple[int, Dict[tuple, int]]:
    words = s.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return len(words), counts


def _cook_refs(refs: Sequence[str], n: int = 4):
    reflens: List[int] = []
    maxcounts: Dict[tuple, int] = {}
    for ref in refs:
        rl, counts = ngram_counts(ref, n)
        reflens.append(rl)
        for ngram, count in counts.items():
            maxcounts[ngram] = max(maxcounts.get(ngram, 0), count)
    return reflens, maxcounts


def _cook_test(test: str, reflens, refmaxcounts, n: int = 4):
    testlen, counts = ngram_counts(test, n)
    comps = {
        "testlen": testlen,
        "reflen": reflens,
        "guess": [max(0, testlen - k + 1) for k in range(1, n + 1)],
        "correct": [0] * n,
    }
    for ngram, count in counts.items():
        comps["correct"][len(ngram) - 1] += min(refmaxcounts.get(ngram, 0), count)
    return comps


def _effective_reflen(reflens, option: str, testlen: int) -> float:
    if option == "shortest":
        return min(reflens)
    if option == "average":
        return float(sum(reflens)) / len(reflens)
    if option == "closest":
        return min((abs(l - testlen), l) for l in reflens)[1]
    raise ValueError(option)


class BleuScorer:
    def __init__(self, n: int = 4):
        self.n = n
        # raw sentences only; n-gram cooking happens lazily via the comps
        # property (the C++ fast path never builds Python n-gram dicts)
        self._raw: List[Tuple[str, List[str]]] = []

    def append(self, test: str, refs: Sequence[str]) -> None:
        self._raw.append((test, list(refs)))

    @property
    def comps(self) -> List[dict]:
        out = []
        for test, refs in self._raw:
            reflens, maxcounts = _cook_refs(refs, self.n)
            out.append(_cook_test(test, reflens, maxcounts, self.n))
        return out

    def compute_score(self, option=None):
        n = self.n
        if option is None:
            option = "average" if len(self._raw) == 1 else "closest"
        cpp = _cpp_compute(self._raw, n, option)
        if cpp is not None:
            return cpp
        bleu_list: List[List[float]] = [[] for _ in range(n)]
        total = {"testlen": 0, "reflen": 0.0, "guess": [0] * n, "correct": [0] * n}
        for comps in self.comps:
            testlen = comps["testlen"]
            reflen = _effective_reflen(comps["reflen"], option, testlen)
            total["testlen"] += testlen
            total["reflen"] += reflen
            for key in ("guess", "correct"):
                for k in range(n):
                    total[key][k] += comps[key][k]
            bleu = 1.0
            for k in range(n):
                bleu *= (comps["correct"][k] + TINY) / (comps["guess"][k] + SMALL)
                bleu_list[k].append(bleu ** (1.0 / (k + 1)))
            ratio = (testlen + TINY) / (reflen + SMALL)
            if ratio < 1:
                for k in range(n):
                    bleu_list[k][-1] *= math.exp(1 - 1 / ratio)

        bleus: List[float] = []
        bleu = 1.0
        for k in range(n):
            bleu *= (total["correct"][k] + TINY) / (total["guess"][k] + SMALL)
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (total["testlen"] + TINY) / (total["reflen"] + SMALL)
        if ratio < 1:
            for k in range(n):
                bleus[k] *= math.exp(1 - 1 / ratio)
        return bleus, bleu_list


class Bleu:
    """Reference-compatible facade (pycocoevalcap/bleu/bleu.py surface)."""

    def __init__(self, n: int = 4):
        self._n = n

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        scorer = BleuScorer(self._n)
        for img_id in sorted(gts.keys()):
            hypo, refs = res[img_id], gts[img_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(refs, list) and len(refs) >= 1
            scorer.append(hypo[0], refs)
        return scorer.compute_score(option="closest")

    def method(self):
        return "Bleu"


# --- C++ fast path (csrc/bleu.cpp via ctypes) -------------------------------

_CPP_LIB = None
_OPTIONS = {"closest": 0, "average": 1, "shortest": 2}


def _configure_cpp(lib) -> None:
    import ctypes

    lib.bleu_score.restype = ctypes.c_int
    lib.bleu_score.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]


def _cpp_available() -> bool:
    global _CPP_LIB
    if _CPP_LIB is None:
        from show_and_tell_tpu_torch.utils.native import load_csrc_lib

        _CPP_LIB = load_csrc_lib("libbleu.so", _configure_cpp)
    return _CPP_LIB is not None


def _cpp_compute(raw, n: int, option: str):
    """Corpus + per-image BLEU from C++ — bit-equal float chain (see
    csrc/bleu.cpp header). Returns None when the library is absent."""
    if not _cpp_available() or not raw or option not in _OPTIONS:
        return None
    # embedded NUL would truncate at the C-string boundary: Python path
    if any(
        "\x00" in t or any("\x00" in r for r in refs) for t, refs in raw
    ):
        return None
    import ctypes

    import numpy as np

    N = len(raw)
    # pre-normalize whitespace so the ASCII splitter sees Python str.split()
    # token streams (same contract as the METEOR/CIDEr wrappers)
    enc = lambda s: " ".join(s.split()).encode("utf-8", "ignore")  # noqa: E731
    cands = (ctypes.c_char_p * N)(*[enc(t) for t, _ in raw])
    flat = [enc(r) for _, refs in raw for r in refs]
    refs_flat = (ctypes.c_char_p * len(flat))(*flat)
    rpi = (ctypes.c_int * N)(*[len(refs) for _, refs in raw])
    corpus = np.zeros((n,), np.float64)
    per_img = np.zeros((n, N), np.float64)
    rc = _CPP_LIB.bleu_score(
        cands, N, refs_flat, rpi, n, _OPTIONS[option],
        corpus.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        per_img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        return None
    # plain Python floats, like the pure-Python path returns
    return (
        [float(x) for x in corpus],
        [[float(x) for x in per_img[k]] for k in range(n)],
    )
