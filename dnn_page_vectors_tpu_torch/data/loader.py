"""Host half of the data pipeline: corpus and tokenizer construction, the
shuffled train batches, the fixed-order bulk-embed sweep, the tokenizer
worker pool and the host->device prefetch.

Counterpart of the JAX package's data/loader.py. The
per-batch read + tokenize of the train batcher and of the bulk-embed
sweep can run on a pool of tokenizer worker threads
(``ordered_parallel_map``, ``data.tokenize_workers``), reassembled in
batch order, so the batches are byte for byte the serial path's: the
corpus reader keeps a file handle per thread and the C++ encoders drop
the GIL. ``prefetch_to_device`` moves batches to the card from a producer
thread through pinned host memory. With ``pack`` > 1 the train batcher
packs its pages into rows with segment ids (``pack_segments``, sequence
packing), byte for byte as the JAX package does.
"""
from __future__ import annotations

import collections
import concurrent.futures
import os
import queue as queue_mod
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.config import Config
from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
from dnn_page_vectors_tpu_torch.data.subword import SubwordTokenizer
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.data.trigram import TrigramTokenizer
from dnn_page_vectors_tpu_torch.data.words import WordTokenizer
from dnn_page_vectors_tpu_torch.utils.profiling import (
    NULL_PROFILER, PipelineProfiler)

Batch = Dict[str, np.ndarray]


def ordered_parallel_map(fn: Callable[[Any], Any], items: Iterable[Any],
                         workers: int, depth: int = 2) -> Iterator[Any]:
    """Maps `fn` over `items` on a pool of `workers` threads and yields the
    results in item order. At most workers + depth items are in flight, so
    host memory stays bounded and an abandoned consumer leaves no backlog.

    A worker's exception re-raises here, at its item's place in the order,
    where the serial path would have raised; later results are dropped and
    pending items cancelled. Closing the generator (abandoning it) shuts
    the pool down the same way. ``workers`` <= 1 maps in the caller's
    thread."""
    if workers <= 1:
        for item in items:
            yield fn(item)
        return
    ex = concurrent.futures.ThreadPoolExecutor(
        max_workers=workers, thread_name_prefix="tokenize-worker")
    futs: collections.deque = collections.deque()
    try:
        for item in items:
            futs.append(ex.submit(fn, item))
            if len(futs) >= workers + depth:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def read_workers(corpus, workers: int) -> int:
    """The tokenizer workers to read `corpus` with: `workers` where its
    reads run in parallel in threads (``threaded_reads``: JsonlCorpus's
    reads and the C++ encoders drop the GIL), else 1 (ToyCorpus makes
    its texts in Python under the GIL, where threads only contend: on
    the card they slowed its from-text rates, PERF.md §6)."""
    return max(1, workers) if getattr(corpus, "threaded_reads", False) else 1


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


def build_corpus(cfg: Config):
    d = cfg.data
    if d.corpus == "toy":
        return ToyCorpus(num_pages=d.num_pages, seed=d.seed,
                         page_len=d.page_len, query_len=d.query_len,
                         languages=d.languages, num_topics=d.num_topics)
    if d.corpus.startswith("jsonl:"):
        return JsonlCorpus(d.corpus[len("jsonl:"):])
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
    q.threads = tok.threads = d.tokenize_threads
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
    continues the exact batch order of an uninterrupted one.

    Across ranks (``process_count`` > 1: the mesh's data axis, one slice a
    data index): every rank derives the same global batch of
    ``batch_size`` ids and reads, tokenizes and packs only its
    ``process_index``-th contiguous slice of batch_size / process_count
    rows, its mined negatives with them; the slices in rank order are the
    global batch byte for byte.

    ``workers`` > 1 reads and tokenizes each batch (queries, pages and the
    mined negatives) on a pool of tokenizer workers, reassembled in batch
    order, where the corpus reads in parallel (``read_workers``): the
    batches are byte for byte the serial path's. The id
    schedule stays in one thread. A jsonl corpus with native subword
    tokenizers reads each record once and takes the fused C++ extract +
    encode for both fields (``fused_encode``; the same ids). ``profiler``
    gets the workers' ``read``, ``tokenize`` and ``pack`` seconds."""

    def __init__(self, corpus, query_tok, page_tok,
                 batch_size: int, seed: int = 0, start_step: int = 0,
                 hard_negative_lookup: Optional[
                     Callable[[np.ndarray], np.ndarray]] = None,
                 pack: int = 1, workers: int = 1,
                 profiler: Optional[PipelineProfiler] = None,
                 process_index: int = 0, process_count: int = 1):
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
        # maps [B] gold page ids -> [B, H] hard-negative page ids; called
        # from the worker threads (a read-only table gather)
        self.hard_negative_lookup = hard_negative_lookup
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not in "
                             f"[0, {process_count})")
        if batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} must divide over "
                             f"{process_count} data ranks")
        self.process_index = process_index
        self.process_count = process_count
        local = batch_size // process_count
        self.pack = max(1, pack)
        if self.pack > 1 and local % self.pack:
            raise ValueError(f"the batch of a rank, {local}, must divide "
                             f"train.pack_pages={self.pack}")
        self.workers = read_workers(corpus, workers)
        self.profiler = profiler or NULL_PROFILER
        # a jsonl corpus with native subword tokenizers: the raw lines go
        # to the fused C++ extract + encode (the same ids)
        self.fused = (fused_encode(corpus, query_tok)
                      and fused_encode(corpus, page_tok))

    @property
    def steps_per_epoch(self) -> int:
        return self.corpus.num_pages // self.batch_size

    def _id_stream(self) -> Iterator[np.ndarray]:
        n = self.corpus.num_pages
        epoch = self.start_step // self.steps_per_epoch
        skip = self.start_step % self.steps_per_epoch
        local = self.batch_size // self.process_count
        lo = self.process_index * local
        while True:
            order = np.random.default_rng(self.seed + epoch).permutation(n)
            for b in range(skip, self.steps_per_epoch):
                s = b * self.batch_size + lo
                yield order[s:s + local]          # this rank's slice
            skip = 0
            epoch += 1

    def __iter__(self) -> Iterator[Batch]:
        return ordered_parallel_map(self._materialize, self._id_stream(),
                                    self.workers)

    def _materialize(self, ids: np.ndarray) -> Batch:
        prof = self.profiler
        c = self.corpus
        if self.fused:
            # one read of each record serves both fields
            with prof.stage("read"):
                lines = c.page_lines(ids)
            with prof.stage("tokenize"):
                query = self.query_tok.encode_jsonl_lines(lines, "query")
                page = self.page_tok.encode_jsonl_lines(lines, "page")
        else:
            with prof.stage("read"):
                queries = query_texts(c, ids)
                pages = page_texts(c, ids)
            with prof.stage("tokenize"):
                query = self.query_tok.encode_batch(queries)
                page = self.page_tok.encode_batch(pages)
        batch: Batch = {"query": query, "page": page,
                        "page_id": ids.astype(np.int32)}
        if self.pack > 1:
            with prof.stage("pack"):
                rows, seg, pos = pack_segments(batch["page"], self.pack)
            batch["page"] = rows
            batch["page_seg"] = seg
            batch["page_pos"] = pos
        if self.hard_negative_lookup is not None:
            neg_ids = self.hard_negative_lookup(ids)              # [B, H]
            with prof.stage("read"):
                neg = (c.page_lines(neg_ids.reshape(-1)) if self.fused
                       else page_texts(c, neg_ids.reshape(-1)))
            with prof.stage("tokenize"):
                enc = (self.page_tok.encode_jsonl_lines(neg, "page")
                       if self.fused else self.page_tok.encode_batch(neg))
            batch["neg_page"] = enc.reshape(neg_ids.shape + enc.shape[1:])
        return batch


def page_texts(corpus, ids) -> list:
    """The page texts of `ids`: one bulk read where the corpus has one
    (JsonlCorpus's fast extract), else a text at a time."""
    bulk = getattr(corpus, "page_texts", None)
    if bulk is not None:
        return bulk(ids)
    return [corpus.page_text(int(i)) for i in ids]


def query_texts(corpus, ids) -> list:
    bulk = getattr(corpus, "query_texts", None)
    if bulk is not None:
        return bulk(ids)
    return [corpus.query_text(int(i)) for i in ids]


def fused_encode(corpus, page_tok) -> bool:
    """Whether the bulk-embed sweep takes the fused route: the corpus hands
    out raw jsonl lines and the tokenizer runs the C++ encoder, which
    extracts the page field and encodes it in one pass
    (SubwordTokenizer.encode_jsonl_lines). Byte for byte the plain route's
    ids."""
    return (getattr(corpus, "page_lines", None) is not None
            and getattr(page_tok, "encode_jsonl_lines", None) is not None
            and getattr(page_tok, "use_native", False))


def iter_corpus_batches(corpus, page_tok, batch_size: int,
                        start: int = 0, stop: Optional[int] = None,
                        workers: int = 1,
                        profiler: Optional[PipelineProfiler] = None
                        ) -> Iterator[Batch]:
    """Fixed-order corpus sweep for bulk embed; the last batch is padded to
    keep shapes static (pad rows are all-pad token rows flagged with
    page_id == -1).

    ``workers`` > 1 reads and tokenizes the batches on a pool of tokenizer
    workers, reassembled in order (``ordered_parallel_map``), where the
    corpus reads in parallel (``read_workers``): the batches are the
    serial path's byte for byte, and a worker's exception
    re-raises at its batch. A jsonl corpus with a native subword
    tokenizer takes the fused extract + encode (``fused_encode``)."""
    stop = corpus.num_pages if stop is None else min(stop, corpus.num_pages)
    prof = profiler or NULL_PROFILER
    fused = fused_encode(corpus, page_tok)

    def _make(s: int) -> Batch:
        ids = np.arange(s, min(s + batch_size, stop))
        if fused:
            with prof.stage("read"):
                lines = corpus.page_lines(ids)
            with prof.stage("tokenize"):
                enc = page_tok.encode_jsonl_lines(lines, "page")
        else:
            with prof.stage("read"):
                pages = page_texts(corpus, ids)
            with prof.stage("tokenize"):
                enc = page_tok.encode_batch(pages)
        if len(ids) < batch_size:
            pad = batch_size - len(ids)
            enc = np.concatenate(
                [enc, np.zeros((pad,) + enc.shape[1:], enc.dtype)])
            ids = np.concatenate([ids, -np.ones(pad, dtype=ids.dtype)])
        return {"page": enc, "page_id": ids.astype(np.int32)}

    return ordered_parallel_map(_make, range(start, stop, batch_size),
                                read_workers(corpus, workers))


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`. For the GPU the bytes go through
    pinned memory with a non-blocking copy, so the copy overlaps the host
    work that follows; PyTorch's pinned allocator keeps the staging buffer
    alive until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


_END = object()


def prefetch_to_device(it: Iterator[Batch], device: torch.device,
                       depth: int = 2,
                       profiler: Optional[PipelineProfiler] = None,
                       host_keys: Tuple[str, ...] = ()
                       ) -> Iterator[Dict[str, Any]]:
    """Batches of numpy arrays -> dicts of tensors on `device`, produced
    ahead of the consumer.

    A producer thread pulls batches from `it` (the tokenizer workers
    behind it) and, for the GPU, copies each array into pinned host
    memory; a queue of `depth` batches bounds how far it runs ahead. The
    consumer starts each batch's copies to the card with
    ``non_blocking=True`` on its current stream and records an event; the
    pinned tensors are kept until that event has completed, so no host
    buffer is released for reuse while its copy may still read it. On the
    CPU the tensors share the arrays' memory. Keys in `host_keys` stay
    numpy arrays on the host (the bulk embed's page ids).

    A producer's exception re-raises at the consumer, at its place in the
    stream (``RuntimeError("prefetch producer failed")`` from it), never as
    an early end. Abandoning the iterator (closing it) stops the producer
    once it has made its current batch, closes `it` and waits for both. ``profiler``
    gets ``produce_wait`` (the consumer blocked on the producer) and
    ``h2d`` (pinning and starting copies)."""
    prof = profiler or NULL_PROFILER
    q: "queue_mod.Queue[Any]" = queue_mod.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    cuda = device.type == "cuda"

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _host(batch: Batch) -> Dict[str, Any]:
        out = {k: v if k in host_keys
               else torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
        if cuda:
            with prof.stage("h2d"):
                out = {k: v if k in host_keys else v.pin_memory()
                       for k, v in out.items()}
        return out

    def _producer() -> None:
        try:
            for batch in it:
                if not _put(_host(batch)):
                    return
            _put(_END)
        except BaseException as e:      # re-raised at the consumer
            _put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=_producer, daemon=True,
                         name="prefetch-producer")
    t.start()
    inflight: collections.deque = collections.deque()
    try:
        while True:
            with prof.stage("produce_wait"):
                item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise RuntimeError("prefetch producer failed") from item
            if not cuda:
                yield item
                continue
            with prof.stage("h2d"):
                dev = {k: v if k in host_keys
                       else v.to(device, non_blocking=True)
                       for k, v in item.items()}
                ev = torch.cuda.Event()
                ev.record()
                inflight.append((ev, item))
                while inflight and inflight[0][0].query():
                    inflight.popleft()    # its copies are done
            yield dev
    finally:
        # the producer stops at its next put and closes `it`; joined here
        # (it may first finish the batch it is making), so no thread of
        # this iterator outlives it: a daemon thread still inside the
        # tokenizers when the process exits aborts it
        stop.set()
        t.join()
        for ev, _ in inflight:     # release no buffer a copy still reads
            ev.synchronize()
