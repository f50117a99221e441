"""Vocabulary: word <-> id maps with ``<unk>`` fallback.

The special-token order is load-bearing for checkpoints and decoding:

    <pad>=0, <start>=1, <end>=2, <unk>=3

``save``/``load`` use the same JSON as the JAX package (``{"words": [...]}``
in index order), so one vocabulary file serves both.
``from_reference_pickle`` reads the reference's pickled ``vocab.pkl``
without its code, and ``encode``/``encode_batch`` give the fixed-length int32
caption arrays that training reads.
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
    def with_special_tokens(cls) -> "Vocabulary":
        v = cls()
        for tok in SPECIAL_TOKENS:
            v.add_word(tok)
        return v

    @classmethod
    def from_words(cls, words: Iterable[str]) -> "Vocabulary":
        v = cls.with_special_tokens()
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

    @classmethod
    def from_reference_pickle(cls, path: str) -> "Vocabulary":
        """Load a reference ``vocab.pkl`` without the reference's code.

        - Every pickled class outside a small whitelist becomes a plain
          attribute bag: a vocab.pkl is untrusted data, and the default
          resolver would run any importable callable it names.
        - Python 2 pickles are read with ``encoding='latin1'``; bytes keys
          and values from py2 ``str`` payloads are accepted.
        - A bare ``{word: idx}`` dict is accepted too.

        The indices are taken from the pickle, then checked: contiguous from
        0, and the special tokens at ``<pad>=0, <start>=1, <end>=2,
        <unk>=3``. Anything else raises ``ValueError``.
        """
        import pickle

        class _Bag:
            def __init__(self, *a, **k):  # tolerate REDUCE-style construction
                pass

        _SAFE = {
            ("collections", "OrderedDict"),
            ("builtins", "object"),
            ("__builtin__", "object"),
            ("copy_reg", "_reconstructor"),
            ("copyreg", "_reconstructor"),
            # protocol <= 2 has no bytes opcode: py3 pickles bytes through
            # codecs.encode (a pure data transform)
            ("_codecs", "encode"),
        }

        class _AnyClassUnpickler(pickle.Unpickler):
            def find_class(self, module, name):  # noqa: D102
                if (module, name) in _SAFE:
                    return super().find_class(module, name)
                return _Bag

        def _s(x) -> str:
            return x.decode("utf-8", "replace") if isinstance(x, bytes) else str(x)

        with open(path, "rb") as f:
            obj = _AnyClassUnpickler(f, encoding="latin1").load()

        d = obj if isinstance(obj, dict) else getattr(obj, "__dict__", {})
        raw = d.get("word2idx")
        if not isinstance(raw, dict):
            raw = d.get(b"word2idx")
        if not isinstance(raw, dict):
            raw = obj if isinstance(obj, dict) else None
        if raw is None:
            raise ValueError(
                f"{path!r} does not look like a reference vocab.pkl: "
                "no word2idx attribute and not a word->index dict"
            )
        if not raw:
            raise ValueError(f"{path!r}: empty vocabulary (no entries)")
        try:
            word2idx = {_s(k): int(v) for k, v in raw.items()}
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"{path!r} does not look like a reference vocab.pkl: "
                f"values are not integer indices ({e})"
            ) from None

        by_index = sorted(word2idx.items(), key=lambda kv: kv[1])
        indices = [i for _, i in by_index]
        if indices != list(range(len(indices))):
            raise ValueError(
                f"{path!r}: word indices are not contiguous 0..N-1 "
                f"(got min={indices[0] if indices else None}, "
                f"max={indices[-1] if indices else None}, n={len(indices)})"
            )
        v = cls()
        for w, _ in by_index:
            v.add_word(w)
        for tok, want in zip(SPECIAL_TOKENS, (PAD_ID, START_ID, END_ID, UNK_ID)):
            got = v.word2idx.get(tok)
            if got != want:
                raise ValueError(
                    f"{path!r}: special token {tok!r} is at index {got}, "
                    f"expected {want}; this vocabulary was not produced by "
                    "the reference preprocess pipeline"
                )
        return v

    def encode(self, tokens: Sequence[str], max_len: int) -> np.ndarray:
        """``<start>`` + ids + ``<end>``, padded with ``<pad>`` to ``max_len``
        (int32). Tokens beyond ``max_len - 2`` are dropped; ``<end>`` is
        always kept."""
        ids = [START_ID] + [self(t) for t in tokens[: max_len - 2]] + [END_ID]
        out = np.full((max_len,), PAD_ID, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def encode_batch(self, token_lists: Sequence[Sequence[str]], max_len: int) -> tuple:
        """``(ids [B, max_len] int32, lengths [B] int32)``; a length counts
        ``<start>``, the tokens and ``<end>``."""
        n = len(token_lists)
        ids = np.full((n, max_len), PAD_ID, dtype=np.int32)
        lengths = np.zeros((n,), dtype=np.int32)
        for i, toks in enumerate(token_lists):
            row = self.encode(toks, max_len)
            ids[i] = row
            lengths[i] = int(np.sum(row != PAD_ID))
        return ids, lengths

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
