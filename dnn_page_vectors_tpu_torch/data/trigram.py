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

By default ``encode`` and ``encode_batch`` run the C++ hash
(native/trigram_hash.cpp), which gives the same ids; a failed build or call
raises. The Python loop (``encode_py``) is the plain version, taken only
when the caller asks for it with ``use_native=False``.
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
                 k: int = 8, use_native: bool = True):
        self.buckets = buckets
        self.max_words = max_words
        self.k = k
        self.use_native = use_native

    @property
    def path(self) -> str:
        """Which encoder runs: "native" (C++) or "python"."""
        return "native" if self.use_native else "python"

    @property
    def vocab_size(self) -> int:
        return self.buckets + 1  # + padding id 0

    def encode_py(self, text: str) -> np.ndarray:
        """The plain Python encoder."""
        out = np.zeros((self.max_words, self.k), dtype=np.int32)
        for wi, word in enumerate(text.split()[: self.max_words]):
            for ti, tg in enumerate(word_trigrams(word)[: self.k]):
                data = tg.encode("utf-8", "surrogatepass")
                out[wi, ti] = 1 + fnv1a(data) % self.buckets
        return out

    def encode(self, text: str) -> np.ndarray:
        if self.use_native:
            from dnn_page_vectors_tpu_torch.native import trigram_native
            return trigram_native.encode(text, self.buckets, self.max_words,
                                         self.k)
        return self.encode_py(text)

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        if self.use_native:
            from dnn_page_vectors_tpu_torch.native import trigram_native
            return trigram_native.encode_batch(texts, self.buckets,
                                               self.max_words, self.k)
        if not texts:
            return np.zeros((0, self.max_words, self.k), np.int32)
        return np.stack([self.encode_py(t) for t in texts])
