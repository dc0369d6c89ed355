"""Subword tokenizer for the transformer towers: the port's own copy of the
JAX package's data/subword.py, wordpiece and sentencepiece surfaces over one
deterministic BPE core.

Training is classic BPE (greedy highest-count pair merge, ties broken by the
lexicographically smallest pair) with incremental pair counts on a lazy
max-heap, so a 30,522-piece vocab trains in seconds. Encoding is greedy
longest-match; for the same vocab its token ids equal the JAX package's
byte for byte (tests/test_torch_serve.py, tests/test_torch_native.py).

By default ``encode``, ``encode_batch`` and ``encode_jsonl_lines`` run the
C++ matcher (native/bpe_encode.cpp); ``threads`` > 1 (from
``data.tokenize_threads``) splits a batch of at least 512 texts across a
shared thread pool, since the C++ call drops the GIL. A failed build or
call raises: nothing falls back. The Python matcher (``encode_py``) is the
plain version, taken only with ``use_native=False``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import heapq
import json
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
UNK_ID = 1
_RESERVED = 2


def _train_bpe(word_counts: Dict[Tuple[str, ...], int], num_merges: int,
               min_pair_count: int = 1) -> List[Tuple[str, str]]:
    """Greedy BPE merge learning over symbol-tuple word counts.

    Selection rule: highest pair count, ties broken by lexicographically
    smallest pair (deterministic). Pair counts are maintained incrementally:
    merging pair P rewrites only the words that contain P, subtracting their
    old adjacent-pair counts and adding the new ones; the heap is lazy
    (stale entries are dropped/refreshed on pop).
    """
    merges: List[Tuple[str, str]] = []
    words: List[List[str]] = []
    counts: List[int] = []
    for sym, c in word_counts.items():
        words.append(list(sym))
        counts.append(c)

    pair_counts: Dict[Tuple[str, str], int] = collections.defaultdict(int)
    pair_words: Dict[Tuple[str, str], set] = collections.defaultdict(set)
    for wi, sym in enumerate(words):
        c = counts[wi]
        for a, b in zip(sym, sym[1:]):
            pair_counts[(a, b)] += c
            pair_words[(a, b)].add(wi)

    heap = [(-c, pair) for pair, c in pair_counts.items()]
    heapq.heapify(heap)

    # `num_merges` counts NOVEL piece strings: two different pairs can merge
    # to the same surface string (e.g. (a,bc) and (ab,c) -> "abc"), and the
    # final vocab dedups surfaces — counting novel strings keeps
    # len(vocab) == alphabet + num_merges exactly (the honesty contract).
    seen = {s for sym in words for s in sym}
    novel = 0
    while novel < num_merges and heap:
        neg, best = heapq.heappop(heap)
        cur = pair_counts.get(best, 0)
        if cur != -neg:                      # stale: refresh and re-queue
            if cur > 0:
                heapq.heappush(heap, (-cur, best))
            continue
        if cur < min_pair_count or cur <= 0:
            break
        merges.append(best)
        merged = best[0] + best[1]
        if merged not in seen:
            seen.add(merged)
            novel += 1
        touched: set = set()
        for wi in list(pair_words.get(best, ())):
            sym = words[wi]
            c = counts[wi]
            # left-to-right non-overlapping rewrite
            out: List[str] = []
            i = 0
            hit = False
            while i < len(sym):
                if (i + 1 < len(sym) and sym[i] == best[0]
                        and sym[i + 1] == best[1]):
                    out.append(merged)
                    i += 2
                    hit = True
                else:
                    out.append(sym[i])
                    i += 1
            if not hit:                      # stale index entry
                continue
            for a, b in zip(sym, sym[1:]):   # retract old adjacencies
                pair_counts[(a, b)] -= c
                if pair_counts[(a, b)] <= 0:
                    pair_counts.pop((a, b), None)
            for a, b in zip(out, out[1:]):   # add new adjacencies
                pair_counts[(a, b)] += c
                pair_words[(a, b)].add(wi)
                touched.add((a, b))
            words[wi] = out
        pair_words.pop(best, None)
        for pair in touched:
            if pair in pair_counts:
                heapq.heappush(heap, (-pair_counts[pair], pair))
    return merges


_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_POOL_SIZE = 0
_POOL_LOCK = threading.Lock()


def _threaded_encode(native, texts: Sequence, max_tokens: int,
                     k: int) -> np.ndarray:
    """Encodes `texts` in `k` contiguous chunks on a shared thread pool,
    concatenated in order. Correct because the chunks are independent and
    the C++ call drops the GIL for its whole length.

    The lock covers both replacing the pool (to grow it) and submitting
    the chunks: ``Executor.map`` submits every chunk when it is called, so
    no thread can submit to a pool that another is shutting down.
    ``shutdown(wait=False)`` never cancels work already submitted, so the
    results are read safely outside the lock."""
    global _POOL, _POOL_SIZE
    n = len(texts)
    bounds = [(i * n // k, (i + 1) * n // k) for i in range(k)]
    with _POOL_LOCK:
        if _POOL is None or _POOL_SIZE < k:
            if _POOL is not None:
                _POOL.shutdown(wait=False)
            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=k, thread_name_prefix="subword-encode")
            _POOL_SIZE = k
        parts = _POOL.map(
            lambda se: native.encode_batch(texts[se[0]:se[1]], max_tokens,
                                           UNK_ID), bounds)
    return np.concatenate(list(parts), axis=0)


class SubwordTokenizer:
    """BPE-core subword tokenizer with WordPiece / SentencePiece surfaces."""

    def __init__(self, vocab: Dict[str, int], style: str = "wordpiece",
                 max_tokens: int = 64, meta: Dict | None = None,
                 use_native: bool = True):
        if style not in ("wordpiece", "sentencepiece"):
            raise ValueError(f"unknown subword style {style!r} "
                             "(want wordpiece | sentencepiece)")
        self.vocab = vocab
        self.style = style
        self.max_tokens = max_tokens
        # provenance (config vocab_size, corpus fingerprint) — lets the
        # loader detect a stale cache instead of silently reusing it
        self.meta = meta or {}
        self.use_native = use_native
        # >1 splits a native batch encode across host threads; the loader
        # sets it from data.tokenize_threads
        self.threads = 1
        self._native = None
        self._native_lock = threading.Lock()

    def __getstate__(self):
        # the C++ handle and the lock stay in their process
        state = dict(self.__dict__)
        state["_native"] = None
        del state["_native_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._native_lock = threading.Lock()

    @property
    def path(self) -> str:
        """Which encoder runs: "native" (C++) or "python"."""
        return "native" if self.use_native else "python"

    # -- training ---------------------------------------------------------
    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int = 8_192,
              style: str = "wordpiece", max_tokens: int = 64,
              max_train_words: int = 2_000_000,
              strict_vocab: bool = False) -> "SubwordTokenizer":
        """Train a BPE vocab of (up to) `vocab_size` total ids.

        strict_vocab=True raises if the corpus sample cannot support exactly
        `vocab_size` pieces (merges run dry) — the named configs claim real
        vocab geometries (30,522 / 250,112) and silently training something
        smaller diverges the executed model from its config (VERDICT r1 #3).
        """
        counts: collections.Counter[str] = collections.Counter()
        seen = 0
        for text in texts:
            ws = text.split()
            counts.update(ws)
            seen += len(ws)
            if seen >= max_train_words:
                break
        word_counts = {tuple(w): c for w, c in counts.items()}
        alphabet = sorted({ch for w in word_counts for ch in w})
        num_merges = max(0, vocab_size - len(alphabet) - _RESERVED)
        merges = _train_bpe(word_counts, num_merges)
        pieces = list(alphabet) + [a + b for a, b in merges]
        # piece -> id, longest pieces preferred implicitly by greedy matcher
        vocab = {p: i + _RESERVED for i, p in enumerate(dict.fromkeys(pieces))}
        tok = cls(vocab, style=style, max_tokens=max_tokens)
        if strict_vocab and tok.vocab_size != vocab_size:
            raise ValueError(
                f"BPE training produced {tok.vocab_size} ids but the config "
                f"claims vocab_size={vocab_size}: the training sample "
                f"({seen} words, {len(word_counts)} unique) ran out of "
                "mergeable pairs. Use a larger corpus / max_train_words, or "
                "lower data.vocab_size to what the corpus supports.")
        return tok

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + _RESERVED

    # -- encoding ---------------------------------------------------------
    def _encode_word(self, word: str) -> List[int]:
        """Greedy longest-match over the BPE vocab."""
        ids: List[int] = []
        i = 0
        n = len(word)
        while i < n:
            j = n
            while j > i:
                piece = word[i:j]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                j -= 1
            else:
                ids.append(UNK_ID)
                j = i + 1
            i = j
        return ids

    def encode_py(self, text: str) -> np.ndarray:
        """The plain Python encoder."""
        out = np.zeros(self.max_tokens, dtype=np.int32)
        pos = 0
        for word in text.split():
            if pos >= self.max_tokens:
                break
            for tid in self._encode_word(word):
                if pos >= self.max_tokens:
                    break
                out[pos] = tid
                pos += 1
        return out

    def native_encoder(self):
        """The C++ matcher of this vocab (shared between tokenizers of
        equal vocabs; the library is built on first use). Raises when the
        library cannot be built or loaded."""
        if self._native is None:
            with self._native_lock:
                if self._native is None:
                    from dnn_page_vectors_tpu_torch.native import (
                        subword_native)
                    self._native = subword_native.shared_encoder(self.vocab)
        return self._native

    def encode(self, text: str) -> np.ndarray:
        if self.use_native:
            return self.encode_batch([text])[0]
        return self.encode_py(text)

    def encode_batch(self, texts: Sequence) -> np.ndarray:
        """[n] texts -> [n, max_tokens] int32 ids, 0-padded."""
        if self.use_native:
            native = self.native_encoder()
            k = min(self.threads, len(texts) // 256)   # >= 256 texts a chunk
            if k > 1:
                return _threaded_encode(native, texts, self.max_tokens, k)
            return native.encode_batch(texts, self.max_tokens, UNK_ID)
        if not texts:
            return np.zeros((0, self.max_tokens), np.int32)
        return np.stack([self.encode_py(t) for t in texts])

    def encode_jsonl_lines(self, lines: Sequence[bytes],
                           field: str = "page") -> np.ndarray:
        """Fused jsonl extract + encode: raw jsonl lines in, [n, max_tokens]
        ids out, with no field extract and no UTF-8 decode and re-encode
        on the Python side. A record the C++ extractor does not take
        (escapes, nesting, a duplicate or missing key: the rules of
        data/jsonl.py ``_extract``) is parsed with ``json.loads`` and
        encoded by ``encode_batch``, so the ids equal the unfused path's.
        Needs the native encoder: with ``use_native=False`` it raises."""
        if not self.use_native:
            raise ValueError("encode_jsonl_lines runs the C++ encoder; this "
                             "tokenizer was built with use_native=False")
        key = f'"{field}":'.encode("utf-8")
        out, status = self.native_encoder().encode_jsonl_batch(
            lines, key, self.max_tokens, UNK_ID)
        bad = np.flatnonzero(status == 0)
        if bad.size:
            texts = []
            for i in bad:
                rec = json.loads(lines[int(i)])
                texts.append(rec[field] if field == "page"
                             else rec.get(field, ""))
            out[bad] = self.encode_batch(texts)
        return out

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"style": self.style, "max_tokens": self.max_tokens,
                       "vocab": self.vocab, "meta": self.meta}, f)

    @classmethod
    def load(cls, path: str) -> "SubwordTokenizer":
        with open(path) as f:
            blob = json.load(f)
        return cls(blob["vocab"], style=blob["style"],
                   max_tokens=blob["max_tokens"], meta=blob.get("meta"))
