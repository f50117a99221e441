"""Vocabulary: word <-> id maps with ``<unk>`` fallback.

The special-token order is load-bearing for checkpoints and decoding:

    <pad>=0, <start>=1, <end>=2, <unk>=3

``save``/``load`` use the same JSON as the JAX package (``{"words": [...]}``
in index order), so one vocabulary file serves both.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence

import numpy as np

PAD, START, END, UNK = "<pad>", "<start>", "<end>", "<unk>"
PAD_ID, START_ID, END_ID, UNK_ID = 0, 1, 2, 3
SPECIAL_TOKENS = (PAD, START, END, UNK)


class Vocabulary:
    def __init__(self) -> None:
        self.word2idx: Dict[str, int] = {}
        self.idx2word: Dict[int, str] = {}
        self.idx = 0

    def add_word(self, word: str) -> None:
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def __call__(self, word: str) -> int:
        return self.word2idx.get(word, self.word2idx[UNK])

    def __len__(self) -> int:
        return len(self.word2idx)

    def __contains__(self, word: str) -> bool:
        return word in self.word2idx

    @classmethod
    def from_words(cls, words: Iterable[str]) -> "Vocabulary":
        v = cls()
        for w in SPECIAL_TOKENS:
            v.add_word(w)
        for w in words:
            v.add_word(w)
        return v

    def save(self, path: str) -> None:
        words = [self.idx2word[i] for i in range(self.idx)]
        with open(path, "w") as f:
            json.dump({"words": words}, f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            d = json.load(f)
        v = cls()
        for w in d["words"]:
            v.add_word(w)
        # decoding hardwires the special ids: a words list that does not
        # lead with them would silently mis-decode every caption
        for tok, want in zip(SPECIAL_TOKENS, (PAD_ID, START_ID, END_ID, UNK_ID)):
            got = v.word2idx.get(tok)
            if got != want:
                raise ValueError(
                    f"{path!r}: special token {tok!r} is at index {got}, "
                    f"expected {want} — the words list must begin with "
                    f"{list(SPECIAL_TOKENS)}"
                )
        return v

    def decode(self, ids: Sequence[int]) -> str:
        """ids -> sentence: stops at ``<end>``, skips ``<pad>``/``<start>``."""
        words: List[str] = []
        for i in ids:
            w = self.idx2word.get(int(i), UNK)
            if w == END:
                break
            if w in (PAD, START):
                continue
            words.append(w)
        return " ".join(words)

    def decode_batch(self, ids) -> List[str]:
        return [self.decode(row) for row in np.asarray(ids)]
