"""Query serving over a vector store: exact, staged whole on the card, or
through the IVF/PQ index.

A lean counterpart of the JAX package's infer/serve.py ``SearchService``,
with the same constructor shape and the same result format.
``search_many`` tokenizes the queries, pads them with all-pad rows to a
multiple of the ``query_batch`` bucket (8), encodes them with the query
tower (the padding rows are the fully-masked-row case of the flash kernel),
retrieves, and formats page_id / score / snippet.

``serve.index="exact"``: at construction every shard of the store is read
once and staged on the device as one [N, D] matrix at its stored width
(float16 rows, or int8 codes and their scales; the page ids stay on the
host), and a query block runs the exact ``chunked_topk``.

``serve.index="ivf"``: the index (index/ivf.py) is opened at construction
and the store is not staged: each request gathers its probed lists' rows
from the shards' mmaps (``IVFIndex.search`` at ``serve.nprobe``). While
the index is unavailable (missing, torn, quarantined, or stale against the
store's model step, checked per request) a request is answered by the
exact sweep of the store on the card (``topk_over_store``) and counted in
``ann_fallbacks``. ``metrics()`` carries the ``ann_*`` counters and the
``ann_index`` record only on such a service.

Later slices add the micro-batcher, the query and result caches, the
index's live update and hot posting set, partitions, filters, migration
and telemetry.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.data.loader import to_device
from dnn_page_vectors_tpu_torch.index.ivf import IndexUnavailable, IVFIndex
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.ops.topk import chunked_topk, topk_over_store


class SearchService:
    def __init__(self, cfg, embedder: BulkEmbedder, corpus,
                 store: VectorStore, preload_hbm_gb: float = 4.0,
                 snippet_chars: int = 160, query_batch: Optional[int] = None):
        if cfg.serve.index not in ("exact", "ivf"):
            raise ValueError(f"unknown serve.index {cfg.serve.index!r} "
                             "(want exact | ivf)")
        if embedder.query_tok is None:
            raise ValueError("SearchService needs an embedder with a query "
                             "tokenizer")
        self.cfg = cfg
        self.embedder = embedder
        self.corpus = corpus
        self.store = store
        self.snippet_chars = snippet_chars
        self.query_batch = query_batch or 8
        self.index: Optional[IVFIndex] = None
        self.index_error: Optional[str] = None
        if cfg.serve.index == "ivf":
            self.ann_lists_scanned = self.ann_candidates_reranked = 0
            self.ann_fallbacks = self.ann_gather_bytes = 0
            try:
                self.index = IVFIndex.open(store, device=embedder.device)
            except IndexUnavailable as e:
                self.index_error = str(e)
                print(f"WARNING: IVF index unavailable ({e}); serving the "
                      "exact path per request", flush=True)
            return
        need = store.num_vectors * store.row_bytes
        if need > preload_hbm_gb * 1e9:
            raise ValueError(
                f"the store needs {need / 1e9:.3f} GB on the card, over the "
                f"preload budget of {preload_hbm_gb} GB; streaming shards from "
                "disk is a later slice of the port")
        parts = list(store.iter_shards(raw=True))
        self.page_ids = np.concatenate(                   # [N] int64, host
            [p[0] for p in parts] or [np.zeros(0, np.int64)])
        rows = np.concatenate([np.asarray(p[1]) for p in parts]
                              or [np.zeros((0, store.dim), np.float16)])
        self.pages = torch.from_numpy(rows).to(embedder.device)  # [N, D]
        scales = [p[2] for p in parts if p[2] is not None]     # int8 only
        self.scales = (torch.from_numpy(np.concatenate(scales)).to(
            embedder.device) if scales else None)

    @property
    def num_vectors(self) -> int:
        return (self.store.num_vectors if self.cfg.serve.index == "ivf"
                else int(self.page_ids.shape[0]))

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
        if self.cfg.serve.index == "exact" and self.num_vectors == 0:
            return [[] for _ in range(n)]
        qv = self.encode_queries(queries)[:n]
        if self.cfg.serve.index == "ivf":
            scores, pids = self._ivf_topk(qv, k)
        else:
            scores, idx = chunked_topk(qv, self.pages, k=k,
                                       scales=self.scales)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
            pids = np.where(idx >= 0, self.page_ids[np.clip(idx, 0, None)],
                            -1)
        return [self._format(scores[i], pids[i]) for i in range(n)]

    def _ivf_topk(self, qv: torch.Tensor, k: int):
        """(scores [n, k], page ids [n, k]) through the index, or through
        the exact sweep while the index is unavailable or stale (counted in
        ann_fallbacks)."""
        q = qv.cpu().numpy()
        idx = self.index
        if idx is None or idx.model_step != self.store.model_step:
            self.ann_fallbacks += q.shape[0]
            return topk_over_store(q, self.store, k=k,
                                   device=self.embedder.device)
        serve = self.cfg.serve
        scores, pids, st = idx.search(q, k=k, nprobe=serve.nprobe,
                                      rerank=serve.pq_rerank or None)
        self.ann_lists_scanned += st.get("lists_scanned", 0)
        self.ann_candidates_reranked += st.get("candidates_reranked", 0)
        self.ann_gather_bytes += st.get("gather_bytes", 0)
        return scores, pids

    def metrics(self) -> Dict:
        """Serving counters: the retrieval mode, and on an IVF service the
        ann_* counters and the ann_index record (an exact service reports
        no ann_* key)."""
        rec: Dict = {"serve_index": self.cfg.serve.index,
                     "num_vectors": self.num_vectors}
        if self.cfg.serve.index != "exact":
            idx = self.index
            rec.update(
                ann_lists_scanned=self.ann_lists_scanned,
                ann_candidates_reranked=self.ann_candidates_reranked,
                ann_fallbacks=self.ann_fallbacks,
                ann_gather_bytes=self.ann_gather_bytes,
                ann_index={
                    "index": self.cfg.serve.index,
                    "nprobe": self.cfg.serve.nprobe,
                    "nlist": idx.nlist if idx else None,
                    "available": idx is not None,
                    "pq_m": idx.pq_m if idx else 0,
                    **({"error": self.index_error}
                       if self.index_error else {})})
        return rec

    def _format(self, scores, ids) -> List[Dict]:
        return [
            {"page_id": int(i), "score": round(float(s), 4),
             "snippet": self.corpus.page_text(int(i))[: self.snippet_chars]}
            for s, i in zip(scores, ids) if i >= 0]
