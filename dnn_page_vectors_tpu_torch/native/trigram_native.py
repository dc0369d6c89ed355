"""numpy-facing wrappers over the C++ trigram hash (trigram_hash.cpp)."""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from dnn_page_vectors_tpu_torch.native import load

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def encode(text: str, buckets: int, max_words: int, k: int) -> np.ndarray:
    out = np.zeros((max_words, k), dtype=np.int32)
    # surrogatepass matches the Python path: the C++ side decodes the
    # surrogate's 3-byte sequence as one codepoint and hashes its bytes
    data = text.encode("utf-8", "surrogatepass")
    load().dpv_encode_trigrams(data, len(data), buckets, max_words, k,
                               out.ctypes.data_as(_I32P))
    return out


def encode_batch(texts: Sequence[str], buckets: int, max_words: int,
                 k: int) -> np.ndarray:
    n = len(texts)
    out = np.zeros((n, max_words, k), dtype=np.int32)
    if n == 0:
        return out
    blobs = [t.encode("utf-8", "surrogatepass") for t in texts]
    lens = np.asarray([len(b) for b in blobs], dtype=np.int64)
    load().dpv_encode_trigrams_batch(
        b"".join(blobs), lens.ctypes.data_as(_I64P), n, buckets, max_words,
        k, out.ctypes.data_as(_I32P))
    return out
