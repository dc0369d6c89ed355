"""Bulk synthetic-corpus writer: a ToyCorpus-structured query/page corpus
streamed to a jsonl file, the port's own copy of the JAX package's
data/synth.py (the same file, byte for byte, for the same arguments).

``ToyCorpus.page_text`` makes one page at a time from a fresh rng a page,
too slow to materialize a 1M-page corpus. This writer makes the same
corpus structure (per-topic vocabularies over syllable words, and two
page-unique key words shared with the gold query, so Recall@k stays
learnable and page i's gold query is record i's) with numpy sampling a
block of pages at a time and buffered writes. The output is a plain jsonl
file of {"query": ..., "page": ...} records for data/jsonl.py's
JsonlCorpus: generate once to disk, then train, embed and evaluate from
the file, as from a real crawl.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from dnn_page_vectors_tpu_torch.data.toy import _SYLLABLES, _make_word


def write_synth_jsonl(path: str, num_pages: int, seed: int = 0,
                      num_topics: int = 64, page_len: int = 48,
                      query_len: int = 8, block: int = 16_384,
                      start: int = 0, log: Optional[object] = None) -> str:
    """Write pages [start, num_pages) as jsonl records; returns `path`.

    Deterministic in (seed, num_topics, page_len, query_len, block): each
    block re-seeds from its first page id, so page i's text depends on
    which block grid it falls in — `block` is part of the corpus identity,
    NOT a pure performance knob. `start` writes a part of the corpus
    (several processes each write one file of a block-aligned range) and
    must be block-aligned, so each part draws the per-block streams a
    single writer would: the parts concatenated are the whole file.
    """
    if start % block:
        raise ValueError(f"start={start} must be a multiple of "
                         f"block={block} (block grid is part of the "
                         "corpus identity — see docstring)")
    master = np.random.default_rng(seed)
    # same construction order as ToyCorpus so the vocabularies match
    common = np.array(sorted({_make_word(master, 2) for _ in range(300)}),
                      dtype=object)
    topics = [np.array(sorted({_make_word(master, 3) for _ in range(48)}),
                       dtype=object) for _ in range(num_topics)]
    syll = np.array(_SYLLABLES, dtype=object)
    tmp = path + f".tmp.{os.getpid()}"
    t0 = time.perf_counter()
    written = 0
    with open(tmp, "w", buffering=1 << 22) as f:
        for lo in range(start, num_pages, block):
            hi = min(lo + block, num_pages)
            b = hi - lo
            rng = np.random.default_rng((seed * 1_000_003 + lo) & 0x7FFFFFFF)
            ids = np.arange(lo, hi)
            # page body: per-topic words w.p. 0.75 else common words
            topic_of = ids % num_topics
            body = np.empty((b, page_len), dtype=object)
            use_topic = rng.random((b, page_len)) < 0.75
            ci = rng.integers(0, len(common), size=(b, page_len))
            # raw draws mod the per-topic vocab size (set dedup makes each
            # topic's vocabulary a little under 48 words)
            ti = rng.integers(0, 1 << 30, size=(b, page_len))
            body[~use_topic] = common[ci[~use_topic]]
            for t in range(num_topics):          # group rows by topic
                rows = np.nonzero(topic_of == t)[0]
                if rows.size == 0:
                    continue
                m = use_topic[rows]
                sub = body[rows]
                sub[m] = topics[t][ti[rows][m] % len(topics[t])]
                body[rows] = sub
            # two key words per page (4 syllables; first carries the i%10
            # digit suffix like ToyCorpus._key_words), planted 3x each
            ks = rng.integers(0, len(syll), size=(b, 2, 4))
            key0 = syll[ks[:, 0, 0]] + syll[ks[:, 0, 1]] + \
                syll[ks[:, 0, 2]] + syll[ks[:, 0, 3]] + \
                np.array([str(i % 10) for i in ids], dtype=object)
            key1 = syll[ks[:, 1, 0]] + syll[ks[:, 1, 1]] + \
                syll[ks[:, 1, 2]] + syll[ks[:, 1, 3]]
            keys = np.stack([key0, key1], axis=1)
            for j in range(6):                   # each key appears 3x
                body[np.arange(b), (7 * (j + 1) + ids) % page_len] = \
                    keys[:, j % 2]
            # query: both keys + topic filler, deterministic shuffle
            qbody = np.empty((b, query_len), dtype=object)
            qti = rng.integers(0, 1 << 30, size=(b, query_len))
            for t in range(num_topics):
                rows = np.nonzero(topic_of == t)[0]
                if rows.size:
                    qbody[rows] = topics[t][qti[rows] % len(topics[t])]
            qpos = rng.integers(0, query_len - 1, size=b)
            qbody[np.arange(b), qpos] = keys[:, 0]
            qbody[np.arange(b), qpos + 1] = keys[:, 1]
            for r in range(b):
                f.write(json.dumps(
                    {"query": " ".join(qbody[r]), "page": " ".join(body[r])},
                    separators=(",", ":")))
                f.write("\n")
            written += b
            if log is not None and written % (block * 8) == 0:
                rate = written / (time.perf_counter() - t0)
                print(f"[synth] {written}/{num_pages - start} pages "
                      f"({rate:,.0f}/s)", file=log, flush=True)
    os.replace(tmp, path)
    return path
