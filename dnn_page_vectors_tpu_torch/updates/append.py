"""Append new and updated pages to an embedded store as one generation,
the port's copy of the JAX package's updates/append.py.

``embed_corpus`` sweeps the whole corpus into the base (generation 0);
this path embeds only the delta: the id range past the store's append
cursor (``next_page_id``, which counts quarantined ranges, so a lost
shard's ids are never re-issued) plus any explicitly updated pages, and
publishes it through the GenerationWriter: data files first, the
generation manifest last, so a failure mid-append costs the uncommitted
generation only and readers keep the previous one.

The page tower's float16 rows and the int8 quantization are those of the
bulk path. A shard of consecutive new ids is read and tokenized as the
bulk embed reads it (``iter_corpus_batches``: the tokenizer worker pool,
and a jsonl corpus's fused C++ encode), in ``eval.embed_batch_size`` rows
from the shard's first id, so an append whose shards start on the base's
shard bounds writes the rows a base embed of the same ids writes, byte
for byte; a shard holding updated ids goes through ``embed_texts``.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import numpy as np

from dnn_page_vectors_tpu_torch.data.loader import (
    iter_corpus_batches, read_workers)
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.maintenance.lease import AppendLease
from dnn_page_vectors_tpu_torch.utils import telemetry


def append_corpus(embedder, corpus, store: VectorStore,
                  start: Optional[int] = None, stop: Optional[int] = None,
                  tombstone: Iterable[int] = (),
                  update_ids: Iterable[int] = (),
                  batch_size: Optional[int] = None,
                  log=None, lease: bool = True,
                  attrs: Optional[int] = None) -> Dict:
    """Embed corpus pages [start, stop) (default: everything past the
    append cursor) plus `update_ids` (existing pages re-embedded from
    their current text) into a new generation on the embedder's device;
    `tombstone` ids are deleted. An updated id is tombstoned too, so its
    old row masks out while the new one serves.

    The cursor read, the embed and the commit run under the store's
    append lease (``updates.writer_lease_s`` ttl, renewed after every
    shard; ``updates.lease_wait_s`` of waiting, then LeaseHeld);
    `lease=False` is for a caller that serializes its writers itself.

    `attrs`: one packed attribute word (index/attrs.py ``pack_word``)
    stamped on every row this append writes, the grain of
    `cli append --attrs`. It needs a store with an attribute table
    (``init_attrs()``); on a store without one it raises before anything
    is embedded.

    Returns the stats (generation, appended, updated, tombstoned, id
    range, shards, seconds, append_docs_per_s). A delta with nothing new,
    updated or tombstoned writes no generation."""
    if store.model_step is None:
        raise ValueError(
            "store is unstamped (no model_step); run the base 'embed' "
            "before appending: appends must share the base weights")
    if attrs is not None and not store.attrs_enabled:
        raise ValueError(
            "append has --attrs but the store has no attribute table; "
            "initialize one first (cli append --init-attrs, or "
            "store.init_attrs())")
    upd_cfg = embedder.cfg.updates
    held = None
    if lease:
        held = AppendLease(store, ttl_s=upd_cfg.writer_lease_s,
                           wait_s=upd_cfg.lease_wait_s).acquire()
        # another writer may have committed while this one waited: the
        # cursor and the generation number are read as the lease found them
        store.reload()
        store.reload_generations()
    try:
        return _append_leased(embedder, corpus, store, start, stop,
                              tombstone, update_ids, batch_size, log, held,
                              attrs)
    finally:
        if held is not None:
            held.release()


def _append_leased(embedder, corpus, store, start, stop, tombstone,
                   update_ids, batch_size, log, held, attrs=None) -> Dict:
    cursor = store.next_page_id()
    start = cursor if start is None else int(start)
    if start < cursor:
        raise ValueError(
            f"append start={start} overlaps ids already assigned (append "
            f"cursor {cursor}, incl. quarantined ranges "
            f"{store.missing_id_ranges()}); appends must never re-issue "
            "an id: use update_ids to re-embed existing pages")
    stop = corpus.num_pages if stop is None else min(int(stop),
                                                     corpus.num_pages)
    update_ids = sorted({int(i) for i in update_ids})
    tombstone = sorted({int(i) for i in tombstone})
    for i in update_ids + tombstone:
        if i >= start:
            raise ValueError(
                f"page id {i} is not an existing page (append range starts "
                f"at {start}); only already-assigned ids can be updated or "
                "tombstoned")
    new_ids = list(range(start, stop))
    if not new_ids and not update_ids and not tombstone:
        return {"generation": store.generation, "appended": 0, "updated": 0,
                "tombstoned": 0, "shards": 0, "seconds": 0.0}
    t0 = time.perf_counter()
    # updated pages ride after the new range, so a pure append and an
    # append with updates share the new range's shard bytes
    all_ids = np.array(new_ids + update_ids, np.int64)
    writer = store.begin_generation(tombstones=set(tombstone) | set(update_ids))
    shard_size = store.manifest["shard_size"]
    bs = batch_size or embedder.cfg.eval.embed_batch_size
    try:
        for s in range(0, all_ids.shape[0], shard_size):
            ids = all_ids[s: s + shard_size]
            words = (np.full(ids.shape[0], int(attrs), np.uint32)
                     if attrs is not None else None)
            writer.write_shard(ids, _embed_ids(embedder, corpus, ids, bs),
                               attrs=words)
            if held is not None:
                # a long append must not outlive its lease; LeaseLost here
                # aborts before a commit could double-assign
                held.renew()
        man = writer.commit()
    except BaseException:
        writer.abort()     # readers never see a half-written generation
        raise
    dt = time.perf_counter() - t0
    stats = {
        "generation": man["gen"],
        "appended": len(new_ids),
        "updated": len(update_ids),
        "tombstoned": len(tombstone) + len(update_ids),
        "id_start": man["id_start"],
        "id_end": man["id_end"],
        "shards": len(man["shards"]),
        "seconds": round(dt, 3),
        "append_docs_per_s": round(all_ids.shape[0] / max(dt, 1e-9), 2),
    }
    reg = telemetry.default_registry()
    reg.counter("updates.docs_appended").inc(len(new_ids))
    reg.counter("updates.docs_updated").inc(len(update_ids))
    reg.counter("updates.docs_tombstoned").inc(stats["tombstoned"])
    reg.counter("updates.generations").inc()
    reg.gauge("updates.append_docs_per_s").set(stats["append_docs_per_s"])
    reg.event("generation_append", {
        "generation": man["gen"], "appended": len(new_ids),
        "updated": len(update_ids), "tombstoned": stats["tombstoned"]})
    if log is not None:
        log.write({"append_generation": man["gen"], **stats})
    return stats


def _embed_ids(embedder, corpus, ids: np.ndarray, bs: int) -> np.ndarray:
    """[n] page ids -> [n, D] float16 page rows. Consecutive ids go through
    the bulk embed's reader (batches from the first id, the last one
    padded with page_id -1 rows); any other list through embed_texts."""
    lo, n = int(ids[0]), int(ids.shape[0])
    if not np.array_equal(ids, np.arange(lo, lo + n)):
        return embedder.embed_texts([corpus.page_text(int(i)) for i in ids],
                                    tower="page", batch_size=bs)
    workers = read_workers(corpus, embedder.cfg.data.tokenize_workers)
    rows = []
    for batch in iter_corpus_batches(corpus, embedder.page_tok, bs,
                                     start=lo, stop=lo + n, workers=workers):
        out = embedder.embed_pages(batch["page"])
        rows.append(out[np.asarray(batch["page_id"]) >= 0])
    return np.concatenate(rows)
