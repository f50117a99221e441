"""Compact embedded English paraphrase table for METEOR's paraphrase stage.

METEOR 1.5's paraphrase module matches multi-word PHRASES (and words) that
its corpus-derived paraphrase database lists as substitutable
(meteor-1.5.jar's bundled paraphrase-en.gz — referenced by the jar the
reference wrapper drives, pycocoevalcap/meteor/meteor.py:12, but not
shipped, and not fetchable in this zero-egress image). This module embeds a
hand-curated, captioning-domain paraphrase table in the same representation
as metrics/synonyms.py: groups of mutually substitutable phrases; two
spans match on the paraphrase stage iff they share at least one group.

Coverage beyond this table is a documented deviation (docs/PARITY.md).
Users holding a real paraphrase database can install it at runtime with
``set_paraphrase_groups`` — the scorer (Python and C++) rebuilds its index
from whatever table is active.

Phrases are 1-4 tokens (PTB-tokenized, lowercase). Single-word pairs that
the exact/stem/synonym modules already cover are redundant here (the
resolver drops them — module priority), so groups focus on phrase<->phrase
and phrase<->word equivalences that only this stage can see.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

MAX_PHRASE_LEN = 4

PARAPHRASE_GROUPS: Tuple[Tuple[str, ...], ...] = (
    # --- spatial relations ---
    ("next to", "beside", "alongside", "adjacent to"),
    ("close to", "near", "nearby"),
    ("in front of", "ahead of"),
    ("on top of", "atop"),
    ("in the middle of", "amid", "amidst"),
    ("side by side", "together"),
    ("each other", "one another"),
    # --- quantities ---
    ("a lot of", "lots of", "many", "plenty of", "a bunch of"),
    ("a group of", "several", "a number of"),
    ("a couple of", "a pair of", "two"),
    ("a few", "some"),
    # --- caption-domain compounds ---
    ("cell phone", "cellphone", "mobile phone", "mobile"),
    ("remote control", "remote"),
    ("hot dog", "hotdog", "frankfurter"),
    ("traffic light", "stoplight", "traffic signal"),
    ("living room", "sitting room", "lounge"),
    ("fire truck", "firetruck", "fire engine"),
    ("tennis racket", "tennis racquet", "racket", "racquet"),
    ("skate board", "skateboard"),
    ("snow board", "snowboard"),
    ("surf board", "surfboard"),
    ("t shirt", "tshirt", "tee shirt"),
    ("base ball", "baseball"),
    ("basket ball", "basketball"),
    ("motor cycle", "motorcycle", "motor bike", "motorbike"),
    ("train station", "railway station", "railroad station"),
    ("parking lot", "car park"),
    ("sidewalk", "side walk", "pavement"),
    # --- verbal constructions (auxiliary + participle <-> finite verb) ---
    ("is wearing", "wears"),
    ("are wearing", "wear"),
    ("is holding", "holds"),
    ("is riding", "rides"),
    ("is sitting", "sits"),
    ("is standing", "stands"),
    ("sitting on top of", "sitting on", "atop"),
    ("getting ready to", "about to", "preparing to"),
    ("in order to", "to"),
)

_ACTIVE_GROUPS: Tuple[Tuple[str, ...], ...] = PARAPHRASE_GROUPS
_GENERATION = 0  # bumped on table swap so scorers can rebuild caches


def set_paraphrase_groups(groups) -> None:
    """Replace the active paraphrase table (e.g. with one converted from the
    real METEOR paraphrase-en database). ``groups``: iterable of iterables
    of phrase strings (1-``MAX_PHRASE_LEN`` space-separated tokens each).
    Phrases longer than ``MAX_PHRASE_LEN`` tokens are rejected."""
    global _ACTIVE_GROUPS, _GENERATION
    canon = []
    for g in groups:
        row = tuple(" ".join(p.split()) for p in g)
        for p in row:
            n = len(p.split())
            if not 1 <= n <= MAX_PHRASE_LEN:
                raise ValueError(
                    f"paraphrase {p!r}: {n} tokens (limit {MAX_PHRASE_LEN})"
                )
        if len(row) >= 2:
            canon.append(row)
    _ACTIVE_GROUPS = tuple(canon)
    _GENERATION += 1


def active_groups() -> Tuple[Tuple[str, ...], ...]:
    return _ACTIVE_GROUPS


def generation() -> int:
    return _GENERATION


def build_index() -> Dict[str, FrozenSet[int]]:
    """phrase -> set of group ids over the ACTIVE table (no stemming:
    METEOR's paraphrase db lists surface forms)."""
    idx: Dict[str, set] = {}
    for gid, group in enumerate(_ACTIVE_GROUPS):
        for phrase in group:
            idx.setdefault(phrase, set()).add(gid)
    return {k: frozenset(v) for k, v in idx.items()}


def serialize() -> bytes:
    """One group per line, phrases '|'-separated (phrases contain spaces) —
    the wire format csrc/meteor.cpp's meteor_set_paraphrases ingests."""
    return "\n".join("|".join(g) for g in _ACTIVE_GROUPS).encode()
