"""ROUGE-L: LCS-based F-measure with beta = 1.2.

Exact-semantics port of the vendored ``pycocoevalcap/rouge/rouge.py``:
token-level longest-common-subsequence length per reference
(rouge.py:13-34), max precision / max recall over references — note the
reference takes the max of each *independently* (rouge.py:66-67), not the
best single reference's (P, R) pair — and F-beta with beta = 1.2
(rouge.py:43,68-74). The LCS DP here is O(len_r * len_c) numpy rows instead
of nested Python lists; identical results.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def lcs_length(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = np.zeros(len(b) + 1, dtype=np.int32)
    for x in a:
        cur = prev.copy()
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return int(prev[-1])


class Rouge:
    def __init__(self):
        self.beta = 1.2

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        assert len(candidate) == 1
        assert len(refs) > 0
        token_c = candidate[0].split(" ")
        prec, rec = [], []
        for reference in refs:
            token_r = reference.split(" ")
            lcs = lcs_length(token_r, token_c)
            prec.append(lcs / float(len(token_c)))
            rec.append(lcs / float(len(token_r)))
        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            return ((1 + self.beta ** 2) * prec_max * rec_max) / float(
                rec_max + self.beta ** 2 * prec_max
            )
        return 0.0

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        keys = sorted(gts.keys())
        for i in keys:  # same contract the Python calc_score enforces
            assert len(res[i]) == 1
            assert len(gts[i]) > 0
        cpp = _cpp_compute(
            [res[i][0] for i in keys], [gts[i] for i in keys], self.beta
        )
        if cpp is not None:
            return float(np.mean(cpp)), cpp
        scores = [self.calc_score(res[i], gts[i]) for i in keys]
        return float(np.mean(scores)), np.array(scores)

    def method(self):
        return "Rouge"


# --- C++ fast path (csrc/rouge.cpp via ctypes) ------------------------------

_CPP_LIB = None


def _configure_cpp(lib) -> None:
    import ctypes

    lib.rouge_score.restype = ctypes.c_int
    lib.rouge_score.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]


def _cpp_available() -> bool:
    global _CPP_LIB
    if _CPP_LIB is None:
        from show_and_tell_tpu_torch.utils.native import load_csrc_lib

        _CPP_LIB = load_csrc_lib("librouge.so", _configure_cpp)
    return _CPP_LIB is not None


def _cpp_compute(cands: List[str], refs: List[List[str]], beta: float):
    """Per-image ROUGE-L from C++ — bit-equal float ops (see csrc/rouge.cpp
    header). The candidate/reference assertions mirror calc_score's."""
    if not _cpp_available() or not cands:
        return None
    # an embedded NUL would truncate at the C-string boundary and silently
    # change the score — let the pure-Python path handle such input
    if any("\x00" in c for c in cands) or any(
        "\x00" in r for rs in refs for r in rs
    ):
        return None
    import ctypes

    N = len(cands)
    # NOTE: no whitespace normalization here — the Python scorer splits on
    # single spaces (str.split(" ")) including empties, and the C++ splitter
    # reproduces exactly that, so the raw strings must pass through as-is
    enc = lambda s: s.encode("utf-8", "ignore")  # noqa: E731
    c_arr = (ctypes.c_char_p * N)(*[enc(c) for c in cands])
    flat = [enc(r) for rs in refs for r in rs]
    r_arr = (ctypes.c_char_p * len(flat))(*flat)
    rpi = (ctypes.c_int * N)(*[len(rs) for rs in refs])
    out = np.zeros((N,), np.float64)
    rc = _CPP_LIB.rouge_score(
        c_arr, N, r_arr, rpi, beta,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out if rc == 0 else None
