"""Retrieval eval: Recall@k query->page on one device.

Counterpart of the JAX package's evals/recall.py: ``recall_at_k`` for
in-memory vectors and ``evaluate_recall`` for a store. The ANN
(IVF/PQ) recall and the store-streaming eval are later slices.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.ops.topk import chunked_topk
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device


def recall_at_k(query_vecs: np.ndarray, page_ids: np.ndarray,
                page_vecs, gold_ids: np.ndarray,
                k: int = 10, query_batch: int = 1024, chunk: int = 8192,
                device: DeviceLike = None) -> float:
    """Fraction of queries whose gold page id is in the top-k.

    query_vecs [Nq, D] and page_vecs [N, D] must be L2-normalized (the
    store's invariant); page_ids maps page rows -> page ids. page_vecs may
    be a numpy array or a tensor already on the device (a staged store)."""
    dev = resolve_device(device)
    hits = 0
    nq = query_vecs.shape[0]
    pages = (page_vecs.to(dev) if isinstance(page_vecs, torch.Tensor)
             else torch.as_tensor(np.asarray(page_vecs), device=dev))
    for s in range(0, nq, query_batch):
        q = torch.as_tensor(np.asarray(query_vecs[s: s + query_batch],
                                       np.float32), device=dev)
        _, idx = chunked_topk(q, pages, k=k, chunk=chunk)
        idx = idx.cpu().numpy()
        # -1 padding (store smaller than k) must not wrap to the last row
        retrieved = np.where(idx >= 0, page_ids[np.clip(idx, 0, None)], -1)
        gold = gold_ids[s: s + query_batch, None]
        hits += int((retrieved == gold).any(axis=1).sum())
    return hits / max(nq, 1)


def evaluate_recall(embedder, corpus, store, num_queries: Optional[int] = None,
                    k: int = 10) -> Tuple[float, int]:
    """Embeds the query texts of pages 0..n-1 with the query tower,
    searches the whole store staged on the embedder's device and returns
    (recall@k, n), the gold page of query i being page i (the toy
    corpus's invariant). n is ``num_queries`` (default
    ``eval.eval_queries``), at most the corpus size. One process: the
    JAX package's multi-host split of the query range is not ported."""
    nq = min(num_queries or embedder.cfg.eval.eval_queries, corpus.num_pages)
    query_vecs = embedder.embed_texts(
        [corpus.query_text(i) for i in range(nq)], tower="query")
    page_ids, page_vecs = store.load_all()
    pages = torch.from_numpy(page_vecs).to(embedder.device)
    return recall_at_k(query_vecs, page_ids, pages,
                       np.arange(nq, dtype=np.int64), k=k,
                       device=embedder.device), nq
