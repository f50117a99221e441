"""METEOR scorer — native, JVM-free.

The reference drives ``meteor-1.5.jar`` over a stdio line protocol
(pycocoevalcap/meteor/meteor.py:18-56) — and the jar is not shipped
(meteor.py:12 references it; SURVEY.md §2.2), so the metric never actually
ran there. This module is a from-scratch METEOR implementation following the
METEOR 1.5 English task definition (Denkowski & Lavie 2014):

- all four METEOR 1.5 matcher modules with its English module weights, NOT
  renormalized: exact (w=1.0), Porter-stem (w=0.6), synonym (w=0.8,
  share-a-group over the compact embedded table in metrics/synonyms.py —
  WordNet itself is not available in this zero-egress image), and paraphrase
  (w=0.6, PHRASE-level spans over the compact caption-domain table in
  metrics/paraphrases.py; the real corpus-derived paraphrase-en database is
  not fetchable here, and a user holding one can install it via
  paraphrases.set_paraphrase_groups — both scorers rebuild),
- METEOR 1.3/1.5 alignment resolution (Denkowski & Lavie 2011 §2.1): all
  modules propose matches over the full sentence pair simultaneously (a
  span pair's weight is that of the first supporting module in module
  order); the final non-overlapping alignment is resolved by beam search
  (METEOR's beam width, 40) to lexicographically (1) maximize covered words
  across both sentences, (2) minimize chunks, (3) minimize the sum of
  |start_i-start_j| match distances — (4) total match weight breaks
  remaining ties deterministically,
- content/function word distinction with delta = 0.75 (function words from a
  compact English closed-class list),
- weighted precision/recall over hypothesis/reference word counts,
  Fmean = P*R / (alpha*P + (1-alpha)*R), alpha = 0.85,
- fragmentation penalty gamma * (chunks / matches)^beta with the METEOR 1.5
  English parameters gamma = 0.45, beta = 2.15, applied UNCONDITIONALLY
  whenever matches > 0 (real METEOR does not zero it for single-chunk
  alignments; a perfect match therefore scores slightly below 1),
- multiple references: score each, keep the max (METEOR's multi-ref rule).

API contract identical to the reference wrapper:
``compute_score(gts, res) -> (mean, [per-image])``; thread-safe by being
stateless (the reference needs a lock around its subprocess's stdio,
meteor.py:26,34 — no shared process here, so no lock).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from show_and_tell_tpu_torch.metrics import paraphrases as _paraphrases
from show_and_tell_tpu_torch.metrics import synonyms as _synonyms

ALPHA = 0.85
BETA = 2.15
GAMMA = 0.45
DELTA = 0.75
W_EXACT = 1.0
W_STEM = 0.6
W_SYN = 0.8
W_PARA = 0.6

_EMPTY: frozenset = frozenset()

# Compact English closed-class (function) word list for the delta weighting.
FUNCTION_WORDS = frozenset(
    """a an the this that these those some any each every no all both half
    i you he she it we they me him her us them my your his its our their
    mine yours hers ours theirs myself yourself himself herself itself
    ourselves themselves who whom whose which what
    and or but nor so yet for if while although though because since unless
    until when where as than whether
    in on at by with from to of off over under above below between among
    through during before after about against into onto upon out up down
    is am are was were be been being do does did have has had will would
    shall should may might can could must
    not n't 's 'm 're 've 'll 'd
    there here now then also just only very too quite rather
    """.split()
)


# ---------------------------------------------------------------------------
# Porter stemmer (classic algorithm, self-contained)
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences."""
    form = "".join("c" if _is_cons(stem, i) else "v" for i in range(len(stem)))
    m = 0
    prev = None
    for ch in form:
        if prev == "v" and ch == "c":
            m += 1
        prev = ch
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_cons(word, len(word) - 1)
    )


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if not (
        _is_cons(word, len(word) - 3)
        and not _is_cons(word, len(word) - 2)
        and _is_cons(word, len(word) - 1)
    ):
        return False
    return word[-1] not in "wxy"


@functools.lru_cache(maxsize=1 << 16)
def porter_stem(word: str) -> str:
    # Pure function of the word; caption corpora reuse a small vocabulary,
    # so memoization turns stemming from the dominant metric cost (70% of
    # SPICE's profile) into a dict hit.
    if len(word) <= 2:
        return word
    w = word

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag = True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    step2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ]
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 3
    step3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 4
    step4 = [
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ]
    for suf in step4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and _measure(w[:-3]) > 1:
            w = w[:-3]

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# Alignment + score
# ---------------------------------------------------------------------------

# built after porter_stem exists (build_index stems each table word);
# rebuilt when synonyms.set_synonym_groups swaps the table
_SYN_INDEX = _synonyms.build_index()
_SYN_GEN = _synonyms.generation()


def _syn_index():
    global _SYN_INDEX, _SYN_GEN
    if _SYN_GEN != _synonyms.generation():
        _SYN_INDEX = _synonyms.build_index()
        _SYN_GEN = _synonyms.generation()
    return _SYN_INDEX


def _syn_groups(word: str, stem: str) -> frozenset:
    """Group ids for a word: surface form unioned with its Porter stem —
    the morphological fallback documented in synonyms.build_index."""
    idx = _syn_index()
    a = idx.get(word, _EMPTY)
    b = idx.get(stem, _EMPTY)
    return a | b if b else a


_BEAM = 40  # METEOR 1.5 Aligner beam width
_MAX_REF_RESOLVE = 128  # C++ path's bitmask width; greedy fallback beyond

# A match is a span pair (i, i_len, j, j_len, w): hyp[i:i+i_len] aligned to
# ref[j:j+j_len] by a module of weight w. Word-module matches have
# i_len == j_len == 1; only the paraphrase module produces longer spans.
Match = Tuple[int, int, int, int, float]

_PARA_INDEX = None
_PARA_GEN = -1


def _para_index():
    """Phrase -> group-id index over the ACTIVE paraphrase table, rebuilt
    when paraphrases.set_paraphrase_groups swaps the table."""
    global _PARA_INDEX, _PARA_GEN
    if _PARA_GEN != _paraphrases.generation():
        _PARA_INDEX = _paraphrases.build_index()
        _PARA_GEN = _paraphrases.generation()
    return _PARA_INDEX


def _phrase_spans(words: List[str], index) -> List[Tuple[int, int, frozenset]]:
    """(start, length, group_ids) for every table phrase occurring in
    ``words``, lengths 1..MAX_PHRASE_LEN."""
    out = []
    n = len(words)
    for start in range(n):
        for length in range(1, min(_paraphrases.MAX_PHRASE_LEN, n - start) + 1):
            groups = index.get(" ".join(words[start : start + length]))
            if groups:
                out.append((start, length, groups))
    return out


def _candidate_spans(hyp: List[str], ref: List[str]) -> List[List[Match]]:
    """Candidates per hyp start position, every module proposing over the
    whole pair simultaneously. Word pairs carry the weight of the first
    supporting module in module order (exact, stem, synonym); the
    paraphrase module proposes span pairs that share a paraphrase group
    (word-word pairs a word module already proposes are not duplicated).
    Each row is sorted by (i_len, j, j_len, -w) — the resolver's generation
    order, mirrored in C++."""
    hyp_stems = [porter_stem(w) for w in hyp]
    ref_stems = [porter_stem(w) for w in ref]
    hyp_syn = [_syn_groups(w, s) for w, s in zip(hyp, hyp_stems)]
    ref_syn = [_syn_groups(w, s) for w, s in zip(ref, ref_stems)]
    cand: List[List[Match]] = [[] for _ in hyp]
    word_pairs = set()
    for i in range(len(hyp)):
        for j in range(len(ref)):
            if hyp[i] == ref[j]:
                w = W_EXACT
            elif hyp_stems[i] == ref_stems[j]:
                w = W_STEM
            elif hyp_syn[i] and not hyp_syn[i].isdisjoint(ref_syn[j]):
                w = W_SYN
            else:
                continue
            cand[i].append((i, 1, j, 1, w))
            word_pairs.add((i, j))
    index = _para_index()
    if index:
        ref_spans = _phrase_spans(ref, index)
        for i, il, hg in _phrase_spans(hyp, index):
            for j, jl, rg in ref_spans:
                if hg.isdisjoint(rg):
                    continue
                if il == 1 and jl == 1 and (i, j) in word_pairs:
                    continue  # a higher-priority word module owns this pair
                cand[i].append((i, il, j, jl, W_PARA))
    for row in cand:
        row.sort(key=lambda m: (m[1], m[2], m[3], -m[4]))
    return cand


def _align(hyp: List[str], ref: List[str]) -> List[Match]:
    """Non-overlapping alignment per METEOR 1.3/1.5 resolution: over the
    pooled candidate matches of all four modules, beam search (width 40)
    for the alignment that lexicographically maximizes covered words
    (both sentences), then minimizes chunks, then minimizes summed
    |start_i - start_j| distance (total match weight as a deterministic
    final tie-break).

    States advance over hyp positions (a span match advances by its hyp
    length); a match extends the current chunk iff the previous match ended
    exactly at this hyp position with its ref span ending at j (tracked as
    cont_j; -1 = broken). The C++ scorer (csrc/meteor.cpp) mirrors this
    procedure exactly — generation order, dedup rule, stable sorts — and is
    tested bit-equal."""
    if len(ref) > _MAX_REF_RESOLVE:
        return _align_greedy(hyp, ref)
    cand = _candidate_spans(hyp, ref)
    n = len(hyp)
    # state: (cov, chunks, dist, wsum, mask, cont_j, match_tuple); cov =
    # covered words across both sentences. (mask, cont_j) fully determines
    # the future at a given position, so only the best partial objective
    # per key survives (exact dominance); the beam truncation afterwards is
    # METEOR's own approximation.
    buckets: List[List] = [[] for _ in range(n + 1)]
    buckets[0] = [(0, 0, 0, 0.0, 0, -1, ())]
    for i in range(n + 1):
        # best per (mask, cont_j): stable-sort by key then objective, keep first
        raw = buckets[i]
        raw.sort(key=lambda s: (s[4], s[5], -s[0], s[1], s[2], -s[3]))
        states = []
        last_key = None
        for s in raw:
            key = (s[4], s[5])
            if key != last_key:
                states.append(s)
                last_key = key
        states.sort(key=lambda s: (-s[0], s[1], s[2], -s[3], s[4], s[5]))
        del states[_BEAM:]
        if i == n:
            return list(states[0][6])
        for cov, c, d, ws, mask, cont_j, ml in states:
            buckets[i + 1].append((cov, c, d, ws, mask, -1, ml))  # skip hyp[i]
            for m in cand[i]:
                _, il, j, jl, w = m
                span = ((1 << jl) - 1) << j
                if mask & span:
                    continue
                # contiguous iff the previous match ended exactly here with
                # its ref span ending at j (cont_j >= 0 guards the broken
                # sentinel from colliding with j=0)
                nc = c if (cont_j >= 0 and cont_j == j) else c + 1
                buckets[i + il].append(
                    (cov + il + jl, nc, d + abs(i - j), ws + w, mask | span,
                     j + jl, ml + (m,))
                )
    raise AssertionError("unreachable")


def _align_greedy(hyp: List[str], ref: List[str]) -> List[Match]:
    """Leftmost-greedy staged word-level fallback (used only beyond the
    resolver's 128-word reference bound — never on caption-scale text)."""
    matches: List[Match] = []
    used_h = [False] * len(hyp)
    used_r = [False] * len(ref)
    cand = _candidate_spans(hyp, ref)
    for stage_weight in (W_EXACT, W_STEM, W_SYN):
        for i in range(len(hyp)):
            if used_h[i]:
                continue
            for _, il, j, jl, w in cand[i]:
                if il == 1 and jl == 1 and not used_r[j] and w == stage_weight:
                    matches.append((i, 1, j, 1, w))
                    used_h[i] = True
                    used_r[j] = True
                    break
    return matches


def _count_chunks(matches: List[Match]) -> int:
    if not matches:
        return 0
    ms = sorted(matches)
    chunks = 1
    for (i1, il1, j1, jl1, _), (i2, _, j2, _, _) in zip(ms, ms[1:]):
        if not (i2 == i1 + il1 and j2 == j1 + jl1):
            chunks += 1
    return chunks


def _word_weight(w: str) -> float:
    return DELTA if w not in FUNCTION_WORDS else 1.0 - DELTA


def meteor_sentence(hypothesis: str, references: Sequence[str]) -> float:
    hyp = hypothesis.split()
    if not hyp:
        return 0.0
    best = 0.0
    for reference in references:
        ref = reference.split()
        if not ref:
            continue
        matches = _align(hyp, ref)
        if not matches:
            continue
        w_hyp_total = sum(_word_weight(w) for w in hyp)
        w_ref_total = sum(_word_weight(w) for w in ref)
        m_hyp = m_ref = 0.0
        cov_h = cov_r = 0
        for i, il, j, jl, mw in matches:
            m_hyp += mw * sum(_word_weight(w) for w in hyp[i : i + il])
            m_ref += mw * sum(_word_weight(w) for w in ref[j : j + jl])
            cov_h += il
            cov_r += jl
        if w_hyp_total == 0 or w_ref_total == 0:
            continue
        P = m_hyp / w_hyp_total
        R = m_ref / w_ref_total
        if P + R == 0:
            continue
        fmean = P * R / (ALPHA * P + (1 - ALPHA) * R)
        chunks = _count_chunks(matches)
        # METEOR 1.5 applies the fragmentation penalty unconditionally for
        # matches > 0 — no single-chunk or full-coverage special case; with
        # phrase matches the denominator is the average covered-word count
        # (== match count when all matches are word-level).
        frag = chunks / ((cov_h + cov_r) / 2.0)
        penalty = GAMMA * (frag ** BETA)
        score = (1.0 - penalty) * fmean
        best = max(best, score)
    return best


class Meteor:
    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        if _cpp_available():
            _cpp_sync_tables()
            sentence_fn = _cpp_meteor_sentence
        else:
            sentence_fn = meteor_sentence
        scores = []
        for img_id in sorted(gts.keys()):
            assert len(res[img_id]) == 1
            scores.append(sentence_fn(res[img_id][0], gts[img_id]))
        return float(np.mean(scores)), scores

    def method(self):
        return "METEOR"


# --- C++ fast path (csrc/meteor.cpp via ctypes) -----------------------------

_CPP_LIB = None


def _configure_cpp(lib) -> None:
    import ctypes

    lib.meteor_score.restype = ctypes.c_double
    lib.meteor_score.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.meteor_stem.restype = ctypes.c_void_p
    lib.meteor_stem.argtypes = [ctypes.c_char_p]
    lib.meteor_free.argtypes = [ctypes.c_void_p]
    lib.meteor_set_synonyms.argtypes = [ctypes.c_char_p]
    lib.meteor_set_paraphrases.argtypes = [ctypes.c_char_p]
    # share the synonym + paraphrase tables with the Python scorer
    lib.meteor_set_synonyms(_synonyms.serialize())
    lib.meteor_set_paraphrases(_paraphrases.serialize())
    global _CPP_PARA_GEN, _CPP_SYN_GEN
    _CPP_PARA_GEN = _paraphrases.generation()
    _CPP_SYN_GEN = _synonyms.generation()


def _cpp_available() -> bool:
    global _CPP_LIB
    if _CPP_LIB is None:
        from show_and_tell_tpu_torch.utils.native import load_csrc_lib

        _CPP_LIB = load_csrc_lib("libmeteor.so", _configure_cpp)
    return _CPP_LIB is not None


_CPP_PARA_GEN = -1
_CPP_SYN_GEN = -1


def _cpp_sync_tables() -> None:
    """Re-push the synonym/paraphrase tables to the C++ scorer after a
    set_*_groups swap (generation-tracked, cheap no-op otherwise)."""
    global _CPP_PARA_GEN, _CPP_SYN_GEN
    if _CPP_LIB is None:
        return
    if _CPP_PARA_GEN != _paraphrases.generation():
        _CPP_LIB.meteor_set_paraphrases(_paraphrases.serialize())
        _CPP_PARA_GEN = _paraphrases.generation()
    if _CPP_SYN_GEN != _synonyms.generation():
        _CPP_LIB.meteor_set_synonyms(_synonyms.serialize())
        _CPP_SYN_GEN = _synonyms.generation()


def _cpp_meteor_sentence(hypothesis: str, references: Sequence[str]) -> float:
    # Normalize with str.split() BEFORE crossing the ctypes boundary: the
    # C++ splitter handles ASCII whitespace only, while Python's split()
    # also breaks on Unicode whitespace (U+00A0 etc.) — pre-joining with
    # single spaces makes the two paths see identical token streams for any
    # input, keeping the bit-equality contract.
    hyp = " ".join(hypothesis.split())
    joined = "\x01".join(" ".join(r.split()) for r in references)
    return float(
        _CPP_LIB.meteor_score(hyp.encode("utf-8", "ignore"), joined.encode("utf-8", "ignore"))
    )


def _cpp_stem(word: str) -> str:
    import ctypes

    ptr = _CPP_LIB.meteor_stem(word.encode())
    try:
        return ctypes.cast(ptr, ctypes.c_char_p).value.decode()
    finally:
        _CPP_LIB.meteor_free(ptr)
