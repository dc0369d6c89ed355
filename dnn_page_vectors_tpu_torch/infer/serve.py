"""Query serving over a vector store staged whole on the card.

A lean counterpart of the JAX package's infer/serve.py ``SearchService``,
with the same constructor shape and the same result format. At
construction every shard of the store is read once and staged on the
device as one float16 [N, D] matrix (the page ids stay on the host).
``search_many`` tokenizes the queries, pads them with all-pad rows to a
multiple of the ``query_batch`` bucket (8), encodes them with the query
tower (the padding rows are the fully-masked-row case of the flash kernel),
runs the exact ``chunked_topk`` and formats page_id / score / snippet.

Later slices add the micro-batcher, the query and result caches, IVF/PQ
retrieval, partitions, filters, migration and telemetry.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.data.loader import to_device
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.ops.topk import chunked_topk


class SearchService:
    def __init__(self, cfg, embedder: BulkEmbedder, corpus,
                 store: VectorStore, preload_hbm_gb: float = 4.0,
                 snippet_chars: int = 160, query_batch: Optional[int] = None):
        if cfg.serve.index != "exact":
            raise NotImplementedError(
                f"serve.index={cfg.serve.index!r} is not ported yet (exact "
                "only; the IVF/PQ index is slice 6 of the port)")
        if embedder.query_tok is None:
            raise ValueError("SearchService needs an embedder with a query "
                             "tokenizer")
        self.cfg = cfg
        self.embedder = embedder
        self.corpus = corpus
        self.store = store
        self.snippet_chars = snippet_chars
        self.query_batch = query_batch or 8
        need = store.num_vectors * store.dim * 2
        if need > preload_hbm_gb * 1e9:
            raise ValueError(
                f"the store needs {need / 1e9:.3f} GB on the card, over the "
                f"preload budget of {preload_hbm_gb} GB; streaming shards from "
                "disk is a later slice of the port")
        ids, vecs = store.load_all()
        self.page_ids = ids                               # [N] int64, host
        self.pages = torch.from_numpy(vecs).to(embedder.device)  # [N, D] f16

    @property
    def num_vectors(self) -> int:
        return int(self.page_ids.shape[0])

    def encode_queries(self, queries: Sequence[str]) -> torch.Tensor:
        """[n] texts -> [n_padded, D] float32 query vectors on the device,
        n_padded a multiple of query_batch; the rows past n are all-pad."""
        enc = self.embedder.query_tok.encode_batch(list(queries))
        pad = -len(queries) % self.query_batch
        if pad:
            enc = np.concatenate(
                [enc, np.zeros((pad,) + enc.shape[1:], enc.dtype)])
        return self.embedder.encode_queries(to_device(enc, self.embedder.device))

    def search(self, query: str, k: Optional[int] = None) -> List[Dict]:
        """One query -> top-k results."""
        return self.search_many([query], k=k)[0]

    def search_many(self, queries: Sequence[str],
                    k: Optional[int] = None) -> List[List[Dict]]:
        """One result list per query, in order: dicts of page_id, score
        (rounded to 4 decimals) and snippet, best first."""
        k = k or self.cfg.eval.recall_k
        n = len(queries)
        if n == 0:
            return []
        if self.num_vectors == 0:
            return [[] for _ in range(n)]
        qv = self.encode_queries(queries)
        scores, idx = chunked_topk(qv[:n], self.pages, k=k)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        pids = np.where(idx >= 0, self.page_ids[np.clip(idx, 0, None)], -1)
        return [self._format(scores[i], pids[i]) for i in range(n)]

    def _format(self, scores, ids) -> List[Dict]:
        return [
            {"page_id": int(i), "score": round(float(s), 4),
             "snippet": self.corpus.page_text(int(i))[: self.snippet_chars]}
            for s, i in zip(scores, ids) if i >= 0]
