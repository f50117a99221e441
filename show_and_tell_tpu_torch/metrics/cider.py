"""CIDEr (Consensus-based Image Description Evaluation), exact-semantics port.

Reproduces the vendored ``pycocoevalcap/cider`` scorer precisely, including
its quirks — the parity gate depends on them:

- document frequency counted per *reference set* (one increment per image
  whose refs contain the n-gram; cider_scorer.py:93-103),
- ``ref_len = log(#images)`` and tf-idf weight
  ``tf * (ref_len - log(max(1, df)))`` (cider_scorer.py:113-124),
- clipped similarity ``sum(min(h, r) * r)`` normalised by both norms
  (cider_scorer.py:149-154),
- the "length" used by the Gaussian penalty counts **bigrams**, not words
  (``if n == 1: length += term_freq`` with n = len(ngram)-1,
  cider_scorer.py:126-127 — a reference quirk reproduced as-is),
- Gaussian length penalty ``exp(-delta^2 / (2 * sigma^2))`` with sigma = 6
  (cider_scorer.py:158; cider.py:18-22),
- mean over the 4 n-gram orders, divided by #refs, times 10
  (cider_scorer.py:174-178).

API: ``Cider().compute_score(gts, res) -> (mean, per-image array)``.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from show_and_tell_tpu_torch.metrics.bleu import ngram_counts


def _precook(s: str, n: int = 4) -> Dict[tuple, int]:
    return ngram_counts(s, n)[1]


class CiderScorer:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma
        # raw sentences; n-gram precooking happens lazily in compute_score's
        # Python fallback (the C++ fast path tokenizes in native code)
        self.raw_tests: List[str] = []
        self.raw_refs: List[List[str]] = []

    def append(self, test: str, refs) -> None:
        self.raw_tests.append(test)
        self.raw_refs.append(list(refs))

    @property
    def ctest(self) -> List[Dict[tuple, int]]:
        return [_precook(t, self.n) for t in self.raw_tests]

    @property
    def crefs(self) -> List[List[Dict[tuple, int]]]:
        return [[_precook(r, self.n) for r in refs] for refs in self.raw_refs]

    @staticmethod
    def _doc_freq(crefs) -> Dict[tuple, float]:
        df: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            for ngram in set(ng for ref in refs for ng in ref):
                df[ngram] += 1
        return df

    def compute_score(self) -> Tuple[float, np.ndarray]:
        cpp = _cpp_compute(self)
        if cpp is not None:
            return cpp
        ctest, crefs = self.ctest, self.crefs  # precook once
        document_frequency = self._doc_freq(crefs)
        if document_frequency:
            assert len(ctest) >= max(document_frequency.values())
        ref_len = np.log(float(len(crefs)))

        def counts2vec(cnts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ngram, tf in cnts.items():
                df = np.log(max(1.0, document_frequency[ngram]))
                k = len(ngram) - 1
                vec[k][ngram] = float(tf) * (ref_len - df)
                norm[k] += vec[k][ngram] ** 2
                if k == 1:
                    length += tf  # bigram count — faithful quirk, see docstring
            return vec, [np.sqrt(x) for x in norm], length

        def sim(vh, vr, nh, nr, lh, lr):
            delta = float(lh - lr)
            val = np.zeros(self.n)
            for k in range(self.n):
                for ngram in vh[k]:
                    val[k] += min(vh[k][ngram], vr[k][ngram]) * vr[k][ngram]
                if nh[k] != 0 and nr[k] != 0:
                    val[k] /= nh[k] * nr[k]
                assert not math.isnan(val[k])
                val[k] *= np.e ** (-(delta ** 2) / (2 * self.sigma ** 2))
            return val

        scores = []
        for test, refs in zip(ctest, crefs):
            vec, norm, length = counts2vec(test)
            score = np.zeros(self.n)
            for ref in refs:
                vec_r, norm_r, length_r = counts2vec(ref)
                score += sim(vec, vec_r, norm, norm_r, length, length_r)
            scores.append(float(np.mean(score) / len(refs) * 10.0))
        return float(np.mean(scores)), np.array(scores)


# --- C++ fast path (csrc/cider.cpp via ctypes) ------------------------------

_CPP_LIB = None


def _configure_cpp(lib) -> None:
    import ctypes

    lib.cider_score.restype = ctypes.c_int
    lib.cider_score.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]


def _cpp_available() -> bool:
    global _CPP_LIB
    if _CPP_LIB is None:
        from show_and_tell_tpu_torch.utils.native import load_csrc_lib

        _CPP_LIB = load_csrc_lib("libcider.so", _configure_cpp)
    return _CPP_LIB is not None


def _cpp_compute(scorer: "CiderScorer"):
    """Per-image accumulated score 4-vectors from C++ (bit-equal operation
    order to the Python fallback — see csrc/cider.cpp header); the numpy
    aggregation below is IDENTICAL to the fallback's. Returns None when the
    library is absent so the pure-Python path runs."""
    if not _cpp_available() or not scorer.raw_tests:
        return None
    # embedded NUL would truncate at the C-string boundary: Python path
    if any("\x00" in t for t in scorer.raw_tests) or any(
        "\x00" in r for refs in scorer.raw_refs for r in refs
    ):
        return None
    import ctypes

    N = len(scorer.raw_tests)
    # pre-normalize whitespace so the ASCII splitter sees Python str.split()
    # token streams (same contract as the METEOR wrapper)
    enc = lambda s: " ".join(s.split()).encode("utf-8", "ignore")  # noqa: E731
    cands = (ctypes.c_char_p * N)(*[enc(t) for t in scorer.raw_tests])
    flat = [enc(r) for refs in scorer.raw_refs for r in refs]
    refs_flat = (ctypes.c_char_p * len(flat))(*flat)
    rpi = (ctypes.c_int * N)(*[len(refs) for refs in scorer.raw_refs])
    out = np.zeros((N, scorer.n), np.float64)
    rc = _CPP_LIB.cider_score(
        cands, N, refs_flat, rpi, scorer.n, scorer.sigma,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        return None  # NaN guard tripped: fall back (Python will assert)
    scores = [
        float(np.mean(out[i]) / len(scorer.raw_refs[i]) * 10.0)
        for i in range(N)
    ]
    return float(np.mean(scores)), np.array(scores)


class Cider:
    """Reference-compatible facade (pycocoevalcap/cider/cider.py surface)."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self._n = n
        self._sigma = sigma

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        scorer = CiderScorer(n=self._n, sigma=self._sigma)
        for img_id in sorted(gts.keys()):
            hypo, refs = res[img_id], gts[img_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(refs, list) and len(refs) > 0
            scorer.append(hypo[0], refs)
        return scorer.compute_score()

    def method(self):
        return "CIDEr"
