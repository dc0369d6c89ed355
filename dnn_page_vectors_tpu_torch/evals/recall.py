"""Retrieval eval: Recall@k query->page for in-memory vectors on one device.

Counterpart of the JAX package's evals/recall.py ``recall_at_k``; the
store-streaming eval is a later slice.
"""
from __future__ import annotations

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
