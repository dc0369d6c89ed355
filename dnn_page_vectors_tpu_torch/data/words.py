"""Word-level tokenizer with a most-frequent-N vocab (the Kim-CNN and
BiLSTM towers' input): the port's own copy of the JAX package's
data/words.py, with the same vocab, ids and JSON file format, so a vocab
saved by either package loads in the other.

PAD is 0 and UNK is 1; the vocab's words take ids 2.. in order of
descending count, ties by the word.
"""
from __future__ import annotations

import collections
import json
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

PAD_ID = 0
UNK_ID = 1
_RESERVED = 2


class WordTokenizer:
    """Most-frequent-N word vocab; text -> int32 ids [max_words] (0 pad, 1 unk)."""

    def __init__(self, vocab: Dict[str, int], max_words: int = 64,
                 meta: Optional[Dict] = None):
        self.vocab = vocab
        self.max_words = max_words
        # provenance (config vocab_size, corpus fingerprint): lets the
        # loader detect a stale cache instead of silently reusing it
        self.meta = meta or {}

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int = 30_000,
              max_words: int = 64, strict_vocab: bool = False
              ) -> "WordTokenizer":
        """Scan texts until the vocabulary can be filled: the scan stops at
        1.5 x `vocab_size` unique words (+ 1,000), so it costs O(vocab),
        not O(corpus), on a 1M-page corpus. strict_vocab=True raises when
        the corpus has fewer unique words than the vocab asks for."""
        counts: collections.Counter = collections.Counter()
        target_unique = int((vocab_size - _RESERVED) * 1.5) + 1_000
        for text in texts:
            counts.update(text.split())
            if len(counts) >= target_unique:
                break
        ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        vocab = {w: i + _RESERVED for i, (w, _) in
                 enumerate(ranked[: vocab_size - _RESERVED])}
        tok = cls(vocab, max_words=max_words)
        if strict_vocab and tok.vocab_size != vocab_size:
            raise ValueError(
                f"corpus has only {len(counts)} unique words; cannot build "
                f"the configured {vocab_size}-word vocab. Lower "
                "data.vocab_size or use a larger corpus.")
        return tok

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + _RESERVED

    def encode(self, text: str) -> np.ndarray:
        out = np.zeros(self.max_words, dtype=np.int32)
        for i, w in enumerate(text.split()[: self.max_words]):
            out[i] = self.vocab.get(w, UNK_ID)
        return out

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"max_words": self.max_words, "vocab": self.vocab,
                       "meta": self.meta}, f)

    @classmethod
    def load(cls, path: str) -> "WordTokenizer":
        with open(path) as f:
            blob = json.load(f)
        return cls(blob["vocab"], max_words=blob["max_words"],
                   meta=blob.get("meta"))
