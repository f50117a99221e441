"""File-format loaders for real METEOR-1.5 resource databases.

The reference's METEOR wrapper drives ``meteor-1.5.jar``, which bundles a
WordNet-derived synonym db and the corpus-derived ``paraphrase-en.gz``
(pycocoevalcap/meteor/meteor.py:12 — the jar itself is not shipped, and
neither database is fetchable in a zero-egress image). The embedded tables
in :mod:`metrics.synonyms` / :mod:`metrics.paraphrases` are compact
caption-domain stand-ins; a user holding the real files installs them in
two calls each::

    from show_and_tell_tpu_torch.metrics import ingest, synonyms, paraphrases
    synonyms.set_synonym_groups(ingest.load_wordnet_synsets("prolog/wn_s.pl"))
    paraphrases.set_paraphrase_groups(
        ingest.load_paraphrase_en("paraphrase-en.gz"))

Both Python and C++ scorers rebuild their indices from the active tables
automatically (generation-tracked — metrics/meteor.py).

Offline recipe (any machine with internet, then copy the files over):

- WordNet synsets: download the WordNet 3.x "Prolog database" distribution
  (``WNprolog-3.0.tar.gz`` from wordnet.princeton.edu) — the synset file is
  ``prolog/wn_s.pl``.
- Paraphrases: the METEOR 1.5 release tarball (``meteor-1.5.tar.gz`` from
  the CMU mtdiff/Meteor page) ships ``data/paraphrase-en.gz``.

Gzip files are handled transparently (magic-byte sniff, not extension).
"""

from __future__ import annotations

import gzip
import re
from typing import Iterable, Optional, Sequence, Tuple

from show_and_tell_tpu_torch.metrics import paraphrases as _paraphrases

__all__ = ["load_wordnet_synsets", "load_paraphrase_en"]


def _open_maybe_gzip(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, "r", encoding="utf-8", errors="replace")


# s(synset_id, w_num, 'word', ss_type, sense_number, tag_count).
# Word is single-quoted with '' as the escape for a literal quote
# (e.g. 'o''clock'); ss_type is n/v/a/s/r ("s" = adjective satellite).
_WN_S_RE = re.compile(r"^s\((\d+),\s*\d+,\s*'((?:[^']|'')*)',\s*([a-z]),")


def load_wordnet_synsets(
    path: str,
    parts: Optional[Sequence[str]] = None,
    include_collocations: bool = False,
) -> Tuple[Tuple[str, ...], ...]:
    """Parse a WordNet Prolog ``wn_s.pl`` synset file into synonym groups.

    One group per synset — exactly METEOR's share-a-synset predicate.
    Lemmas are lowercased (captions are lowercased upstream).

    ``parts``: restrict to these ss_types (subset of ``n v a s r``);
    default all. METEOR's db covers all parts of speech.
    ``include_collocations``: WordNet multi-word lemmas use ``_``
    separators ('domestic_dog'). The synonym module is token-level
    (metrics/synonyms.py), so by default collocations are skipped; pass
    True to keep them as space-joined phrases IF you are building input
    for the paraphrase table instead.

    Returns groups ready for ``synonyms.set_synonym_groups`` (synsets with
    fewer than two usable lemmas are dropped there).
    """
    allowed = set(parts) if parts is not None else None
    synsets: dict = {}
    with _open_maybe_gzip(path) as f:
        for line in f:
            m = _WN_S_RE.match(line.strip())
            if not m:
                continue
            sid, word, ss_type = m.group(1), m.group(2), m.group(3)
            if allowed is not None and ss_type not in allowed:
                continue
            word = word.replace("''", "'").lower()
            if "_" in word:
                if not include_collocations:
                    continue
                word = " ".join(word.split("_"))
            # synset ids are part-of-speech-prefixed (1xxxxxxxx nouns,
            # 2xxxxxxxx verbs, …) so cross-POS collisions can't happen
            synsets.setdefault(sid, []).append(word)
    out = []
    for sid in sorted(synsets):
        group = tuple(dict.fromkeys(synsets[sid]))
        if len(group) >= 2:
            out.append(group)
    return tuple(out)


def _parse_paraphrase_line(line: str) -> Optional[Tuple[str, str, float]]:
    """(phrase1, phrase2, prob) from one paraphrase-db line.

    Accepts the field layouts seen across METEOR paraphrase-db exports:
    ``|||``-separated or tab-separated, 2 or 3 fields, with the probability
    (when present) as either the first or the last field. Unparseable lines
    return None (callers count them).
    """
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    fields = [f.strip() for f in (line.split("|||") if "|||" in line else line.split("\t"))]
    if len(fields) == 1:  # single-field line: not a pair
        return None

    def _as_prob(s: str) -> Optional[float]:
        try:
            v = float(s)
        except ValueError:
            return None
        return v

    if len(fields) == 2:
        return fields[0], fields[1], 1.0
    if len(fields) == 3:
        head, tail = _as_prob(fields[0]), _as_prob(fields[2])
        if tail is not None:
            return fields[0], fields[1], tail
        if head is not None:
            return fields[1], fields[2], head
    return None


def load_paraphrase_en(
    path: str,
    min_prob: float = 0.0,
    max_phrase_len: int = _paraphrases.MAX_PHRASE_LEN,
) -> Tuple[Tuple[str, str], ...]:
    """Parse a METEOR ``paraphrase-en``-style database into paraphrase
    groups for ``paraphrases.set_paraphrase_groups``.

    Each surviving line becomes its own two-phrase group: the paraphrase
    relation is *pairwise*, and a union-find merge would over-connect
    ("large" ~ "big" and "large" ~ "vast" does not license "big" ~ "vast"
    at this module's weight) — share-a-group over per-pair groups encodes
    exactly the pairwise relation.

    Filters: probability < ``min_prob`` (when the file carries one),
    identical pairs, and phrases longer than ``max_phrase_len`` tokens
    (the span cap the matcher searches — paraphrases.MAX_PHRASE_LEN).
    """
    pairs = []
    seen = set()
    with _open_maybe_gzip(path) as f:
        for line in f:
            parsed = _parse_paraphrase_line(line)
            if parsed is None:
                continue
            p1, p2, prob = parsed
            p1 = " ".join(p1.lower().split())
            p2 = " ".join(p2.lower().split())
            if prob < min_prob or p1 == p2 or not p1 or not p2:
                continue
            if len(p1.split()) > max_phrase_len or len(p2.split()) > max_phrase_len:
                continue
            key = (p1, p2) if p1 <= p2 else (p2, p1)
            if key in seen:
                continue
            seen.add(key)
            pairs.append(key)
    return tuple(pairs)
