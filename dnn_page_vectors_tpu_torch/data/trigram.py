"""Char-trigram hashing tokenizer (the CDSSM tower's input): the port's
own copy of the JAX package's data/trigram.py, output for output its
Python path.

Each word (``str.split()``: Unicode whitespace) is wrapped as ``#word#``
and cut into its character trigrams; the first K of them are hashed with
64-bit FNV-1a over their UTF-8 bytes (``surrogatepass``, so a lone
surrogate hashes instead of raising) into ids ``1 + hash % buckets``. A
text becomes int32 [max_words, K] with 0 as pad. FNV-1a is stable across
processes and runs (Python's own ``hash`` is salted), so a vector store
stays reproducible.

The JAX package's C++ fast path (``native/trigram_hash.cpp``) has no copy
here yet; this loop is the port's only path.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def word_trigrams(word: str) -> List[str]:
    padded = f"#{word}#"
    if len(padded) < 3:
        return [padded]
    return [padded[i:i + 3] for i in range(len(padded) - 2)]


class TrigramTokenizer:
    """text -> int32 ids of shape [max_words, k] (0 = pad)."""

    def __init__(self, buckets: int = 16_384, max_words: int = 64,
                 k: int = 8):
        self.buckets = buckets
        self.max_words = max_words
        self.k = k

    @property
    def vocab_size(self) -> int:
        return self.buckets + 1  # + padding id 0

    def encode(self, text: str) -> np.ndarray:
        out = np.zeros((self.max_words, self.k), dtype=np.int32)
        for wi, word in enumerate(text.split()[: self.max_words]):
            for ti, tg in enumerate(word_trigrams(word)[: self.k]):
                data = tg.encode("utf-8", "surrogatepass")
                out[wi, ti] = 1 + fnv1a(data) % self.buckets
        return out

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.max_words, self.k), np.int32)
        return np.stack([self.encode(t) for t in texts])
