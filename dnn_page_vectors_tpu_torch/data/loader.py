"""Host half of the data pipeline: corpus and tokenizer construction, the
shuffled train batches, the fixed-order bulk-embed sweep, and the
host->device copy.

Counterpart of the JAX package's data/loader.py. The host->device copy goes
through pinned memory with ``non_blocking=True``, so a copy overlaps the
host work that follows it; the JAX package's ``prefetch_to_device`` has no
counterpart here. The train batcher is single-process with a serial
producer (the tokenizer worker pool and multi-host slices are later
slices); with ``pack`` > 1 it packs its pages into rows with segment ids
(``pack_segments``, sequence packing), byte for byte as the JAX package
does.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.config import Config
from dnn_page_vectors_tpu_torch.data.subword import SubwordTokenizer
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.data.trigram import TrigramTokenizer
from dnn_page_vectors_tpu_torch.data.words import WordTokenizer

Batch = Dict[str, np.ndarray]


def _waterfill(lens: np.ndarray, cap: int) -> np.ndarray:
    """Clip a row's page token-lengths to fit `cap` total: the classic
    waterfilling threshold — largest pages lose tokens first, small pages
    keep everything. Deterministic: threshold by binary search, leftover
    slack dealt one token at a time to the longest pages (stable order)."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total <= cap or lens.max(initial=0) == 0:
        return lens.copy()
    lo, hi = 0, int(lens.max())
    while lo < hi:                      # largest T with sum(min(len,T))<=cap
        mid = (lo + hi + 1) // 2
        if int(np.minimum(lens, mid).sum()) <= cap:
            lo = mid
        else:
            hi = mid - 1
    out = np.minimum(lens, lo)
    slack = cap - int(out.sum())
    for i in np.argsort(-lens, kind="stable"):
        if slack <= 0:
            break
        if lens[i] > out[i]:
            out[i] += 1
            slack -= 1
    return out


def pack_segments(enc: np.ndarray, pack: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sequence packing (train.pack_pages): place `pack` consecutive
    tokenized pages into ONE row of the same length.

    enc: [B, L] int32 token ids, 0 = pad, tokens left-aligned (every
    tokenizer pads only at the tail). B must divide by `pack`.
    Returns (rows [B/pack, L], seg [B/pack, L], pos [B/pack, L]):
      rows  the packed token ids — page s of row r is the byte-identical
            token run of input page r*pack+s (clipped only when the row's
            combined length overflows L, largest pages first — waterfill);
      seg   segment ids, 0 = pad, s+1 on page s's tokens — the attention /
            pooling mask consumed by the transformer towers;
      pos   per-page LOCAL positions (0..len-1), so BERT's absolute
            position embedding restarts for every packed page.

    Everything is a pure function of the token lengths — deterministic,
    and byte-identical to the unpacked tokens whenever the row fits."""
    B, L = enc.shape[:2]
    if enc.ndim != 2:
        raise ValueError("pack_segments wants [B, L] subword/word ids; "
                         "trigram [B, L, K] batches cannot pack")
    if B % pack:
        raise ValueError(f"batch of {B} pages must divide pack={pack}")
    R = B // pack
    rows = np.zeros((R, L), enc.dtype)
    seg = np.zeros((R, L), np.int32)
    pos = np.zeros((R, L), np.int32)
    lens = (enc != 0).sum(axis=1)
    for r in range(R):
        budget = _waterfill(lens[r * pack:(r + 1) * pack], L)
        c = 0
        for s in range(pack):
            n = int(budget[s])
            if n == 0:
                continue
            rows[r, c:c + n] = enc[r * pack + s, :n]
            seg[r, c:c + n] = s + 1
            pos[r, c:c + n] = np.arange(n)
            c += n
    return rows, seg, pos


def build_corpus(cfg: Config) -> ToyCorpus:
    d = cfg.data
    if d.corpus == "toy":
        return ToyCorpus(num_pages=d.num_pages, seed=d.seed,
                         page_len=d.page_len, query_len=d.query_len,
                         languages=d.languages, num_topics=d.num_topics)
    if d.corpus.startswith("jsonl:"):
        raise NotImplementedError(
            "jsonl corpora are not ported yet (slice 6 of the port)")
    raise ValueError(f"unknown corpus {d.corpus!r} (want 'toy' or 'jsonl:<path>')")


def _corpus_fingerprint(corpus) -> str:
    fp = getattr(corpus, "fingerprint", None)
    return fp() if callable(fp) else f"{type(corpus).__name__}:{corpus.num_pages}"


def build_tokenizer(cfg: Config, corpus, cache_dir: Optional[str] = None):
    """Builds (query_tok, page_tok). Trigram hashing is stateless: nothing
    is cached. A trained vocab (word, wordpiece, sentencepiece) is cached
    under cache_dir so later runs reuse the EXACT vocab the model was
    trained with: page vectors are comparable across runs only if token
    ids are.

    Honesty contract: the built tokenizer's vocab_size must EQUAL
    config.data.vocab_size. Training raises rather than silently training
    something smaller, and a cached vocab is reused only when its recorded
    (vocab_size, corpus fingerprint) provenance matches the current config.
    """
    d = cfg.data
    if d.tokenizer == "trigram":
        q = TrigramTokenizer(d.trigram_buckets, max_words=d.query_len,
                             k=d.trigrams_per_word)
        p = TrigramTokenizer(d.trigram_buckets, max_words=d.page_len,
                             k=d.trigrams_per_word)
        return q, p
    if d.tokenizer not in ("word", "wordpiece", "sentencepiece"):
        raise ValueError(f"unknown tokenizer {d.tokenizer!r} (want trigram "
                         "| word | wordpiece | sentencepiece)")
    cache = (os.path.join(cache_dir, f"tokenizer_{d.tokenizer}.json")
             if cache_dir else None)
    meta = {"vocab_size": d.vocab_size,
            "corpus": _corpus_fingerprint(corpus)}
    if d.tokenizer == "word":
        tok = None
        if cache and os.path.exists(cache):
            tok = WordTokenizer.load(cache)
            if tok.meta != meta:   # stale: config/corpus changed since save
                tok = None
        if tok is None:
            tok = WordTokenizer.train(
                corpus.all_texts(), vocab_size=d.vocab_size,
                max_words=d.page_len, strict_vocab=True)
            tok.meta = meta
            if cache:
                tok.save(cache)
        return WordTokenizer(tok.vocab, max_words=d.query_len), tok
    tok = None
    if cache and os.path.exists(cache):
        tok = SubwordTokenizer.load(cache)
        tok.max_tokens = d.page_len
        if tok.meta != meta:   # stale: config/corpus changed since save
            tok = None
    if tok is None:
        # sample size scales with the requested vocab: merge capacity is
        # bounded by the unique-word count of the sample
        tok = SubwordTokenizer.train(
            corpus.all_texts(), vocab_size=d.vocab_size,
            style=d.tokenizer, max_tokens=d.page_len, strict_vocab=True,
            max_train_words=max(2_000_000, 60 * d.vocab_size))
        tok.meta = meta
        if cache:
            tok.save(cache)
    q = SubwordTokenizer(tok.vocab, style=tok.style, max_tokens=d.query_len)
    return q, tok


class TrainBatcher:
    """Deterministic shuffled (query, page) training batches: numpy dicts
    {"query": [B, query_len], "page": [B, page_len], "page_id": [B]}
    (trigram ids: [B, query_len, K] and [B, page_len, K]), plus
    "neg_page" [B, H, page_len] when a hard-negative lookup is given. With
    ``pack`` > 1 (train.pack_pages) the B pages ride in B / pack packed rows:
    "page" is [B / pack, page_len], with "page_seg" and "page_pos" beside
    it (``pack_segments``); B must divide by ``pack``.

    The id schedule is the JAX package's: epoch e visits the pages in the
    order ``np.random.default_rng(seed + e).permutation(num_pages)``, in
    ``num_pages // batch_size`` full batches (the tail is dropped).
    ``start_step`` maps a global step to (epoch, offset), so a resumed run
    continues the exact batch order of an uninterrupted one."""

    def __init__(self, corpus: ToyCorpus, query_tok, page_tok,
                 batch_size: int, seed: int = 0, start_step: int = 0,
                 hard_negative_lookup: Optional[
                     Callable[[np.ndarray], np.ndarray]] = None,
                 pack: int = 1):
        if batch_size > corpus.num_pages:
            raise ValueError(
                f"batch_size {batch_size} > corpus size {corpus.num_pages}: "
                "no full batch can ever be formed")
        self.corpus = corpus
        self.query_tok = query_tok
        self.page_tok = page_tok
        self.batch_size = batch_size
        self.seed = seed
        self.start_step = start_step
        # maps [B] gold page ids -> [B, H] hard-negative page ids
        self.hard_negative_lookup = hard_negative_lookup
        self.pack = max(1, pack)
        if self.pack > 1 and batch_size % self.pack:
            raise ValueError(f"batch_size {batch_size} must divide "
                             f"train.pack_pages={self.pack}")

    @property
    def steps_per_epoch(self) -> int:
        return self.corpus.num_pages // self.batch_size

    def _id_stream(self) -> Iterator[np.ndarray]:
        n = self.corpus.num_pages
        epoch = self.start_step // self.steps_per_epoch
        skip = self.start_step % self.steps_per_epoch
        while True:
            order = np.random.default_rng(self.seed + epoch).permutation(n)
            for b in range(skip, self.steps_per_epoch):
                yield order[b * self.batch_size:(b + 1) * self.batch_size]
            skip = 0
            epoch += 1

    def __iter__(self) -> Iterator[Batch]:
        for ids in self._id_stream():
            yield self._materialize(ids)

    def _materialize(self, ids: np.ndarray) -> Batch:
        c = self.corpus
        batch: Batch = {
            "query": self.query_tok.encode_batch(
                [c.query_text(int(i)) for i in ids]),
            "page": self.page_tok.encode_batch(
                [c.page_text(int(i)) for i in ids]),
            "page_id": ids.astype(np.int32),
        }
        if self.pack > 1:
            rows, seg, pos = pack_segments(batch["page"], self.pack)
            batch["page"] = rows
            batch["page_seg"] = seg
            batch["page_pos"] = pos
        if self.hard_negative_lookup is not None:
            neg_ids = self.hard_negative_lookup(ids)              # [B, H]
            enc = self.page_tok.encode_batch(
                [c.page_text(int(i)) for i in neg_ids.reshape(-1)])
            batch["neg_page"] = enc.reshape(neg_ids.shape + enc.shape[1:])
        return batch


def iter_corpus_batches(corpus: ToyCorpus, page_tok, batch_size: int,
                        start: int = 0, stop: Optional[int] = None
                        ) -> Iterator[Batch]:
    """Fixed-order corpus sweep for bulk embed; the last batch is padded to
    keep shapes static (pad rows are all-pad token rows flagged with
    page_id == -1)."""
    stop = corpus.num_pages if stop is None else min(stop, corpus.num_pages)
    for s in range(start, stop, batch_size):
        ids = np.arange(s, min(s + batch_size, stop))
        enc = page_tok.encode_batch([corpus.page_text(int(i)) for i in ids])
        if len(ids) < batch_size:
            pad = batch_size - len(ids)
            enc = np.concatenate(
                [enc, np.zeros((pad,) + enc.shape[1:], enc.dtype)])
            ids = np.concatenate([ids, -np.ones(pad, dtype=ids.dtype)])
        yield {"page": enc, "page_id": ids.astype(np.int32)}


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`. For the GPU the bytes go through
    pinned memory with a non-blocking copy, so the copy overlaps the host
    work that follows; PyTorch's pinned allocator keeps the staging buffer
    alive until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)
