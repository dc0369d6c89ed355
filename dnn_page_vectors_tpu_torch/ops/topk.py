"""Exact top-k over page vectors.

Counterpart of the JAX package's ops/topk.py: ``chunked_topk`` scores
queries against device-resident pages one chunk at a time with a float32
matmul (TF32 off: ranking fidelity depends on full precision, as the JAX
scorer's Precision.HIGHEST does) and keeps a running top-k with
``torch.topk``, so memory never holds more than one [Bq, chunk] score
block. Pages may be stored narrow (float16); each chunk is widened to
float32 as it is scored, which is exact. ``merge_topk_host`` is the host
merge of two candidate sets, copied from the JAX package.

``topk_over_store`` streams a vector store through ``chunked_topk`` one
disk shard at a time (each staged at float16, then ``merge_shard_topk``
per query block) and keeps the running top-k on the host, so the card holds one
shard and the host two (the sweep reads the next shard on a reader thread
while the card scores this one). It is the one-card counterpart of the
JAX sweep: the mesh, the row sharding of each shard over its data axis
and the zero padding of shards and query blocks to one compiled shape
have nothing to do on one card (PyTorch runs eagerly); a sweep over
several cards is a later slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.data.loader import to_device
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device


def chunked_topk(q: torch.Tensor, pages: torch.Tensor, k: int = 10,
                 chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k of q @ pages.T on one device.

    q: [Bq, D] (normalized for cosine); pages: [N, D] on q's device.
    Returns (scores [Bq, k] f32, indices [Bq, k] int64) with indices into
    `pages` rows; slots without a row (N < k) score -inf with index -1."""
    if pages.device != q.device:
        raise ValueError(f"pages on {pages.device}, queries on {q.device}")
    q = q.float()
    Bq = q.shape[0]
    N = pages.shape[0]
    best_s = torch.full((Bq, k), -torch.inf, dtype=torch.float32,
                        device=q.device)
    best_i = torch.full((Bq, k), -1, dtype=torch.int64, device=q.device)
    for c0 in range(0, N, chunk):
        block = pages[c0: c0 + chunk]
        s = q @ block.float().T                                   # [Bq, n]
        ids = torch.arange(c0, c0 + block.shape[0], device=q.device)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, ids[None].expand(Bq, -1)], dim=1)
        best_s, pos = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, pos)
    # an empty slot must not report a bogus row id
    best_i = torch.where(torch.isfinite(best_s), best_i,
                         torch.full_like(best_i, -1))
    return best_s, best_i


def merge_topk_host(best_s: np.ndarray, best_i: np.ndarray,
                    new_s: np.ndarray, new_i: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side running-top-k merge of two [Nq, k] candidate sets (ids are
    global page ids; -1 = empty slot).

    O(W) argpartition down to the winning k, then an O(k log k) sort of
    just those. Ties at the selection boundary may admit a different
    equal-scored candidate than a stable full sort would (scores are
    unchanged; only which of the tied ids survives)."""
    k = best_s.shape[1]
    cat_s = np.concatenate([best_s, new_s], axis=1)
    cat_i = np.concatenate([best_i, new_i], axis=1)
    cat_s = np.where(cat_i < 0, -np.inf, cat_s)
    if cat_s.shape[1] > k:
        part = np.argpartition(-cat_s, k - 1, axis=1)[:, :k]
        order = np.argsort(-np.take_along_axis(cat_s, part, axis=1),
                           axis=1, kind="stable")
        pos = np.take_along_axis(part, order, axis=1)
    else:
        pos = np.argsort(-cat_s, axis=1, kind="stable")
    return (np.take_along_axis(cat_s, pos, axis=1),
            np.take_along_axis(cat_i, pos, axis=1))


def merge_shard_topk(q: torch.Tensor, pages: torch.Tensor,
                     page_ids: np.ndarray, k: int, best_s: np.ndarray,
                     best_i: np.ndarray, chunk: int = 8192
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold one staged shard's top-k for the query block `q` into the
    running host top-k (best_s, best_i): rows mapped to page ids through
    `page_ids` (-1 kept for empty slots), non-finite scores masked to
    -inf, then ``merge_topk_host``. The edge cases live here once."""
    if pages.shape[0] == 0:     # empty shard: nothing to add
        return best_s, best_i
    sc, idx = chunked_topk(q, pages, k=k, chunk=chunk)
    sc, idx = sc.cpu().numpy(), idx.cpu().numpy()
    pids = np.where(idx >= 0, page_ids[np.clip(idx, 0, None)], -1)
    return merge_topk_host(best_s, best_i,
                           np.where(np.isfinite(sc), sc, -np.inf), pids)


def topk_over_store(query_vecs: np.ndarray, store, k: int = 10,
                    chunk: int = 8192, query_batch: int = 1024,
                    entries: Optional[List[Dict]] = None,
                    device: DeviceLike = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k of every query over the whole store, streamed one shard
    at a time (``store.iter_shards(prefetch=1)``: the next shard's disk
    read overlaps this one's scoring). Each shard is staged on `device` at
    its stored float16 (half the bytes of float32 over PCIe and in device
    memory; ``chunked_topk`` widens each chunk as it scores it) and scored
    in query blocks of `query_batch` rows; empty shards are skipped, not
    staged. `entries` sweeps the given shard
    entries instead of the store's manifest.

    query_vecs [Nq, D] (normalized for cosine). Returns (scores [Nq, k]
    float32, page_ids [Nq, k] int64), -inf / -1 in the slots no page
    fills (a store of fewer than k vectors)."""
    dev = resolve_device(device)
    nq = query_vecs.shape[0]
    best_s = np.full((nq, k), -np.inf, np.float32)
    best_i = np.full((nq, k), -1, np.int64)
    if entries is None:
        entries = store.shards()
    if nq == 0 or sum(s["count"] for s in entries) == 0:
        return best_s, best_i
    qb = min(query_batch, nq)
    queries = np.asarray(query_vecs, np.float32)
    blocks = [to_device(queries[s: s + qb], dev) for s in range(0, nq, qb)]
    for ids, vecs in store.iter_shards(prefetch=1, entries=entries):
        if vecs.shape[0] == 0:
            continue
        pages = to_device(vecs, dev)
        for b, q in enumerate(blocks):
            s = b * qb
            best_s[s: s + qb], best_i[s: s + qb] = merge_shard_topk(
                q, pages, ids, k, best_s[s: s + qb], best_i[s: s + qb],
                chunk=chunk)
        del pages
    return best_s, best_i
