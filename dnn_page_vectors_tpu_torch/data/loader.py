"""Host half of the data pipeline: corpus and tokenizer construction, the
fixed-order bulk-embed sweep, and the host->device copy.

Counterpart of the JAX package's data/loader.py. The host->device copy goes
through pinned memory with ``non_blocking=True``, so a copy overlaps the
host work that follows it; the JAX package's ``prefetch_to_device`` has no
counterpart here. The train batcher and sequence packing are later slices.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.config import Config
from dnn_page_vectors_tpu_torch.data.subword import SubwordTokenizer
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus

Batch = Dict[str, np.ndarray]


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
    """Builds (query_tok, page_tok). A trained vocab is cached under
    cache_dir so later runs reuse the EXACT vocab the model was trained
    with: page vectors are comparable across runs only if token ids are.

    Honesty contract: the built tokenizer's vocab_size must EQUAL
    config.data.vocab_size. Training raises rather than silently training
    something smaller, and a cached vocab is reused only when its recorded
    (vocab_size, corpus fingerprint) provenance matches the current config.
    """
    d = cfg.data
    if d.tokenizer not in ("wordpiece", "sentencepiece"):
        raise NotImplementedError(
            f"tokenizer {d.tokenizer!r} is not ported yet: the trigram and "
            "word tokenizers come with the CDSSM/Kim-CNN/LSTM slice (5)")
    cache = (os.path.join(cache_dir, f"tokenizer_{d.tokenizer}.json")
             if cache_dir else None)
    meta = {"vocab_size": d.vocab_size,
            "corpus": _corpus_fingerprint(corpus)}
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
