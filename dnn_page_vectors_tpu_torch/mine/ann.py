"""Hard-negative miner: counterpart of the JAX package's mine/ann.py, on
one card.

Queries are embedded with the current weights, the vector store streams
past them one shard at a time through the exact top-k
(ops/topk.py ``topk_over_store``), or with `index` each query block goes
through the IVF index (index/ivf.py: its top-nprobe lists and an exact
re-rank), the gold page and empty slots are
dropped, and the first H of the rest, in score order, are the query's
negatives. The table feeds back into training through
``TrainBatcher.hard_negative_lookup`` (train/pipeline.py runs the loop).
Memory is one store shard on the card, and on the host one query block's
running top-k; with ``out_path`` the [nq, H] table is a memmap filled a
block at a time.

Not ported yet: the per-process slices of a multi-process mine, merged
through per-writer files (the multi-GPU slice); it raises
NotImplementedError.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.ops.topk import topk_over_store


class HardNegatives:
    """[num_queries, H] int32 table of page ids; called by TrainBatcher
    with a batch's [B] gold page ids, it returns their [B, H] rows.
    ``stats`` holds the host seconds of the mine that made it (empty for
    a loaded table)."""

    def __init__(self, table: np.ndarray):
        if table.ndim != 2:
            raise ValueError(f"a negatives table is [queries, H], got "
                             f"shape {table.shape}")
        # a memmap-backed table stays one (astype would read it into RAM)
        self.table = (table if table.dtype == np.int32
                      else table.astype(np.int32))
        self.stats: Dict[str, float] = {}

    @property
    def num_negatives(self) -> int:
        return self.table.shape[1]

    def __call__(self, gold_ids: np.ndarray) -> np.ndarray:
        if int(np.max(gold_ids)) >= self.table.shape[0]:
            raise ValueError(
                f"hard-negative table covers page ids < {self.table.shape[0]} "
                f"but batch contains id {int(np.max(gold_ids))}; mine over the "
                "full training corpus (num_queries=None) before training")
        return self.table[gold_ids]

    def save(self, path: str) -> None:
        """Writes the table whole (np.save through a side file and an
        atomic rename: a crash leaves the old file or the new one). For
        small tables; a mine at scale writes through
        ``mine_hard_negatives(out_path=...)`` a block at a time."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:        # a file handle: no .npy suffix
            np.save(f, self.table)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "HardNegatives":
        """Memory-maps the table: the batcher gathers [B, H] rows a step,
        so a 100M-page table (2.8 GB) need not be resident."""
        return cls(np.load(path, mmap_mode="r"))


def _pick_negatives(retrieved: np.ndarray, gold: np.ndarray,
                    num_negatives: int, num_pages: int) -> np.ndarray:
    """[B, H] int32 negatives from [B, k] retrieved page ids: the gold page
    and -1 slots dropped, score order kept (a stable argsort puts the
    valid ids first), cut to H. Rows left short (a store of fewer than
    H + 1 vectors) are filled by the filler loop: the pages after the
    gold one in id order, never the gold page, unique until the corpus is
    exhausted, then cycled."""
    B, k = retrieved.shape
    H = num_negatives
    out = np.full((B, H), -1, np.int64)
    m = min(k, H)
    valid = (retrieved >= 0) & (retrieved != gold[:, None])
    order = np.argsort(~valid, axis=1, kind="stable")[:, :m]
    out[:, :m] = np.where(np.take_along_axis(valid, order, axis=1),
                          np.take_along_axis(retrieved, order, axis=1), -1)
    for r in np.nonzero((out < 0).any(axis=1))[0]:
        negs = [int(p) for p in out[r] if p >= 0]
        qi, off = int(gold[r]), 1
        while len(negs) < H:
            cand = (qi + off) % num_pages
            if cand != qi and (cand not in negs or off > num_pages):
                negs.append(cand)
            off += 1
        out[r] = negs
    return out.astype(np.int32)


def _multi_process() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


def mine_hard_negatives(embedder, corpus, store,
                        num_negatives: int = 7, search_k: int = 100,
                        num_queries: Optional[int] = None,
                        query_block: Optional[int] = None,
                        out_path: Optional[str] = None,
                        index=None, nprobe: Optional[int] = None,
                        start: int = 0) -> HardNegatives:
    """The top-`search_k` pages of each training query (query i's gold page
    is page i), minus the gold page, cut to `num_negatives`, from the
    query tower's current weights.

    Queries go in blocks of `query_block` (default 8,192): embed a block,
    sweep the store past it once (``topk_over_store`` with
    ``eval.embed_batch_size`` queries at a time on the card), write its
    rows of the table. Host memory is O(query_block * search_k) whatever
    the corpus size; each block costs one store sweep. With `out_path` the
    table is a memmap filled in place in a side file (`.tmp`) that
    replaces `out_path` once complete, so an interrupted mine never leaves
    a table that looks whole, and the result is memory-mapped from
    `out_path`.

    `start` > 0 mines only queries [start, nq) (after a corpus append)
    into `.part` and splices them after rows [0, start) of the table at
    `out_path` (required), a block at a time, with an atomic replace.

    With `index` (an index.ivf.IVFIndex over this store) each block is
    retrieved through the index at `nprobe` instead of a store sweep:
    approximate, and sublinear in the store.

    One process: a mine inside a torch.distributed group of several
    processes raises NotImplementedError.

    The table's ``stats``: queries mined, and the host seconds of the
    query embeds (``embed_s``, tokenizing included), the retrievals
    (``sweep_s``: store sweeps or index searches), the picks
    (``pick_s``) and the whole mine. Each stage returns host arrays, so
    its time includes the card's work."""
    if _multi_process():
        raise NotImplementedError(
            "a multi-process mine (per-process query slices merged through "
            "per-writer files) is part of the multi-GPU slice of the port "
            "(ROADMAP.md queue 1); mine in one process")
    nq = min(num_queries or corpus.num_pages, corpus.num_pages)
    if corpus.num_pages < 2:
        raise ValueError("cannot mine negatives from a <2-page corpus")
    H = num_negatives
    k = min(search_k, store.num_vectors)
    prev = None
    if start:
        if out_path is None or not os.path.exists(out_path):
            raise ValueError(
                "start > 0 extends an existing mined table: pass out_path "
                "pointing at the previous mine's output")
        prev = np.load(out_path, mmap_mode="r")
        if prev.shape[0] < start or prev.shape[1] != H:
            raise ValueError(
                f"existing table {tuple(prev.shape)} at {out_path} cannot "
                f"seed start={start}, num_negatives={H}; run a full mine")
    lo, hi = start, nq
    qb = query_block or 8192
    if out_path is not None:
        my_path = out_path + (".part" if start else ".tmp")
        table = np.lib.format.open_memmap(
            my_path, mode="w+", dtype=np.int32, shape=(max(hi - lo, 0), H))
    else:
        table = np.zeros((max(hi - lo, 0), H), np.int32)
    stats = {"queries": hi - lo, "embed_s": 0.0, "sweep_s": 0.0,
             "pick_s": 0.0}
    t_start = time.perf_counter()
    for s in range(lo, hi, qb):
        e = min(s + qb, hi)
        t0 = time.perf_counter()
        qvecs = embedder.embed_texts(
            [corpus.query_text(i) for i in range(s, e)], tower="query")
        t1 = time.perf_counter()
        if index is not None:
            _, retrieved, _ = index.search(
                np.asarray(qvecs, np.float32), k=k, nprobe=nprobe)
        else:
            _, retrieved = topk_over_store(
                np.asarray(qvecs, np.float32), store, k=k,
                query_batch=embedder.cfg.eval.embed_batch_size,
                device=embedder.device)
        t2 = time.perf_counter()
        table[s - lo: e - lo] = _pick_negatives(
            retrieved, np.arange(s, e, dtype=np.int64), H, corpus.num_pages)
        stats["embed_s"] += t1 - t0
        stats["sweep_s"] += t2 - t1
        stats["pick_s"] += time.perf_counter() - t2
    if out_path is None:
        stats["seconds"] = time.perf_counter() - t_start
        negs = HardNegatives(table)
        negs.stats = stats
        return negs
    table.flush()
    del table
    if start:
        # splice: rows [0, start) of the previous table, then the freshly
        # mined [start, nq), in O(block) copies and an atomic replace, so
        # an interrupted splice leaves the previous table whole
        tmp = out_path + ".tmp"
        out = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=np.int32, shape=(nq, H))
        for b in range(0, start, qb):
            out[b: min(b + qb, start)] = prev[b: min(b + qb, start)]
        part = np.load(my_path, mmap_mode="r")
        for b in range(0, nq - start, qb):
            out[start + b: start + min(b + qb, nq - start)] = \
                part[b: min(b + qb, nq - start)]
        out.flush()
        del out, prev, part
        os.replace(tmp, out_path)
        os.remove(my_path)
    else:
        os.replace(my_path, out_path)
    stats["seconds"] = time.perf_counter() - t_start
    negs = HardNegatives.load(out_path)
    negs.stats = stats
    return negs
