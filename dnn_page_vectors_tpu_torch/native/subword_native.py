"""numpy-facing wrapper over the C++ greedy subword encoder
(bpe_encode.cpp).

One NativeBpeEncoder per piece vocab: the constructor ships the vocab to
C++ once (a 250,112-piece hash map is far too costly to rebuild per
batch); ``encode_batch`` then runs the whole batch without the
interpreter, and ctypes drops the GIL for it, so tokenizer workers scale
across host cores. ``shared_encoder`` dedups by vocab content: the query
and page tokenizers share one vocab (data/loader.py) and must not build
two identical maps.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import threading
from typing import Dict, Sequence, Tuple

import numpy as np

from dnn_page_vectors_tpu_torch.native import load

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


class NativeBpeEncoder:
    def __init__(self, vocab: Dict[str, int]):
        self._init(*_vocab_blob(vocab))

    def _init(self, blob: bytes, ids: np.ndarray) -> None:
        self._lib = load()
        self._blob = blob          # keeps the c_char_p view alive
        self._h = self._lib.dpv_bpe_new(blob, len(blob),
                                        ids.ctypes.data_as(_I32P), len(ids))

    def encode_batch(self, texts: Sequence, max_tokens: int,
                     unk_id: int) -> np.ndarray:
        """[n] texts (str, or utf-8 bytes) -> [n, max_tokens] int32 ids,
        0-padded."""
        n = len(texts)
        out = np.zeros((n, max_tokens), dtype=np.int32)
        if n == 0:
            return out
        # surrogatepass: a lone surrogate (a "\ud800" JSON escape) must
        # encode rather than raise; C++ decodes it back to one codepoint,
        # finds no piece and emits UNK, as the Python path does
        blobs = [t if isinstance(t, bytes)
                 else t.encode("utf-8", "surrogatepass") for t in texts]
        lens = np.asarray([len(b) for b in blobs], dtype=np.int64)
        self._lib.dpv_bpe_encode_batch(
            self._h, b"".join(blobs), lens.ctypes.data_as(_I64P), n,
            max_tokens, unk_id, out.ctypes.data_as(_I32P))
        return out

    def encode_jsonl_batch(self, lines: Sequence[bytes], key: bytes,
                           max_tokens: int, unk_id: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused jsonl extract + encode: `lines` are raw jsonl lines, `key`
        e.g. b'"page":'. Returns (ids [n, max_tokens], status [n] int8);
        a row of status 0 was not extracted (escapes, nesting, a duplicate
        or missing key: data/jsonl.py ``_extract``'s rules) and must be
        filled by the caller."""
        n = len(lines)
        out = np.zeros((n, max_tokens), dtype=np.int32)
        status = np.zeros(n, dtype=np.int8)
        if n == 0:
            return out, status
        lens = np.asarray([len(b) for b in lines], dtype=np.int64)
        self._lib.dpv_bpe_encode_jsonl_batch(
            self._h, b"".join(lines), lens.ctypes.data_as(_I64P), n, key,
            len(key), max_tokens, unk_id, out.ctypes.data_as(_I32P),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        return out, status

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.dpv_bpe_free(h)
            self._h = None


def _vocab_blob(vocab: Dict[str, int]) -> Tuple[bytes, np.ndarray]:
    pieces = list(vocab.keys())
    # pieces come from str.split() words: never a '\n' (or any whitespace)
    blob = "\n".join(pieces).encode("utf-8")
    ids = np.asarray([vocab[p] for p in pieces], dtype=np.int32)
    return blob, ids


_CACHE: "collections.OrderedDict[bytes, NativeBpeEncoder]" = \
    collections.OrderedDict()
_CACHE_MAX = 4
_CACHE_LOCK = threading.Lock()


def shared_encoder(vocab: Dict[str, int]) -> NativeBpeEncoder:
    """A content-keyed encoder cache (hashing the blob takes milliseconds;
    the map build it skips does not). Thread-safe: tokenizer workers may
    ask for the first time together."""
    blob, ids = _vocab_blob(vocab)
    key = hashlib.sha1(blob + ids.tobytes()).digest()
    with _CACHE_LOCK:
        enc = _CACHE.get(key)
        if enc is None:
            enc = NativeBpeEncoder.__new__(NativeBpeEncoder)
            enc._init(blob, ids)
            _CACHE[key] = enc
            while len(_CACHE) > _CACHE_MAX:
                _CACHE.popitem(last=False)
        else:
            _CACHE.move_to_end(key)
        return enc
