"""Corpus -> vector bulk-embed job on one device.

Counterpart of the JAX package's infer/bulk_embed.py. The towers run in
eval mode under ``torch.inference_mode`` (each encode sets eval mode, as
a Trainer that shares the model sets train mode at each step); every
output row is L2-normalized in float32.

Dtype contract (as in the JAX package): page vectors leave the card as
FLOAT16 (the store's own rounding, applied before the device->host copy,
which halves the bytes of the job's whole output), while query vectors stay
FLOAT32 (they feed the float32 top-k scorer directly and are never bulk
traffic).

The sweep overlaps host and device: a batch's encode is enqueued, its
float16 result is copied into pinned host memory without blocking, and the
host tokenizes the next batch before it waits on the previous batch's copy.
Shards are written in the sweep's thread; a background writer is later
work.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.config import Config
from dnn_page_vectors_tpu_torch.data.loader import iter_corpus_batches, to_device
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.models.losses import l2_normalize
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device


class BulkEmbedder:
    def __init__(self, cfg: Config, model: torch.nn.Module, page_tok,
                 query_tok=None, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.page_tok = page_tok
        self.query_tok = query_tok
        self.stats: Dict[str, float] = {}

    # -- device-side encodes ---------------------------------------------
    def _eval_mode(self) -> None:
        # a Trainer sharing the model (the mining pipeline) sets train mode
        # at each of its steps
        if self.model.training:
            self.model.eval()

    @torch.inference_mode()
    def encode_pages(self, ids: torch.Tensor) -> torch.Tensor:
        """[B, page_len] ids on the device -> [B, D] float16 rows, on the
        device."""
        self._eval_mode()
        return l2_normalize(self.model.encode_page(ids)).to(torch.float16)

    @torch.inference_mode()
    def encode_queries(self, ids: torch.Tensor) -> torch.Tensor:
        """[B, query_len] ids on the device -> [B, D] float32 rows, on the
        device."""
        self._eval_mode()
        return l2_normalize(self.model.encode_query(ids))

    # -- host in, host out -----------------------------------------------
    def embed_pages(self, ids: np.ndarray) -> np.ndarray:
        """[B, page_len] token ids -> [B, D] L2-normalized FLOAT16 rows."""
        return self.encode_pages(to_device(ids, self.device)).cpu().numpy()

    def embed_queries(self, ids: np.ndarray) -> np.ndarray:
        """[B, query_len] token ids -> [B, D] L2-normalized FLOAT32 rows."""
        return self.encode_queries(to_device(ids, self.device)).cpu().numpy()

    def embed_texts(self, texts: Sequence[str], tower: str = "query",
                    batch_size: Optional[int] = None) -> np.ndarray:
        """Tokenize + embed a list of texts, padding each batch to
        `batch_size` rows with all-pad rows. tower="page" yields FLOAT16
        rows and tower="query" FLOAT32 (see the module docstring)."""
        if tower not in ("query", "page"):
            raise ValueError(f"unknown tower {tower!r} (want query | page)")
        tok = self.query_tok if tower == "query" else self.page_tok
        run = self.embed_queries if tower == "query" else self.embed_pages
        bs = batch_size or self.cfg.eval.embed_batch_size
        chunks = []
        for s in range(0, len(texts), bs):
            part = list(texts[s: s + bs])
            enc = tok.encode_batch(part)
            if enc.shape[0] < bs:
                pad = bs - enc.shape[0]
                enc = np.concatenate(
                    [enc, np.zeros((pad,) + enc.shape[1:], enc.dtype)])
            chunks.append(run(enc)[: len(part)])
        if chunks:
            return np.concatenate(chunks)
        return np.zeros((0, self.cfg.model.out_dim),
                        np.float32 if tower == "query" else np.float16)

    # -- the bulk job -----------------------------------------------------
    def _to_host(self, vecs: torch.Tensor):
        """Start the device->host copy of `vecs`; returns (host tensor,
        event to wait on). On the CPU the tensor is already host memory."""
        if self.device.type == "cpu":
            return vecs, None
        host = torch.empty(vecs.shape, dtype=vecs.dtype, pin_memory=True)
        host.copy_(vecs, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def embed_corpus(self, corpus, store: VectorStore,
                     batch_size: Optional[int] = None, resume: bool = True
                     ) -> VectorStore:
        """Sweep the corpus into the store, one store shard at a time.

        Resume: completed shards are recorded in the store manifest (after
        their files are durably written) and skipped on restart; a shard
        whose bytes no longer match its record is quarantined first and
        re-embedded. Sets ``self.stats``: pages, seconds, pages_per_sec and
        the seconds spent producing batches on the host (read + tokenize),
        waiting on the device's results, and writing shards."""
        bs = batch_size or self.cfg.eval.embed_batch_size
        shard_size = store.manifest["shard_size"]
        if shard_size % bs and shard_size < corpus.num_pages:
            raise ValueError(f"store shard_size {shard_size} must be a "
                             f"multiple of the batch size {bs}")
        if resume:
            store.verify()
        done = store.completed_shards() if resume else set()
        # wall-time breakdown: host read+tokenize, waits on the device's
        # results, store writes; the rest is enqueueing work on the device
        t = {"produce": 0.0, "device_wait": 0.0, "write": 0.0}
        t0 = time.perf_counter()
        pages = 0
        for si in range(-(-corpus.num_pages // shard_size)):
            if si in done:
                continue
            lo = si * shard_size
            hi = min(lo + shard_size, corpus.num_pages)
            ids_acc: List[np.ndarray] = []
            vec_acc: List[np.ndarray] = []
            pending = None
            batches = iter_corpus_batches(corpus, self.page_tok, bs,
                                          start=lo, stop=hi)
            while True:
                tp = time.perf_counter()
                batch = next(batches, None)
                t["produce"] += time.perf_counter() - tp
                if batch is None:
                    break
                vecs = self.encode_pages(to_device(batch["page"], self.device))
                nxt = (batch["page_id"], *self._to_host(vecs))
                if pending is not None:
                    pages += self._collect(pending, ids_acc, vec_acc, t)
                pending = nxt
            if pending is not None:
                pages += self._collect(pending, ids_acc, vec_acc, t)
            tw = time.perf_counter()
            store.write_shard(si, np.concatenate(ids_acc),
                              np.concatenate(vec_acc))
            t["write"] += time.perf_counter() - tw
        dt = time.perf_counter() - t0
        self.stats = {"pages": pages, "seconds": dt,
                      "pages_per_sec": pages / max(dt, 1e-9),
                      **{f"{k}_s": v for k, v in t.items()}}
        return store

    @staticmethod
    def _collect(pending, ids_acc, vec_acc, t) -> int:
        page_ids, host, ev = pending
        if ev is not None:
            tw = time.perf_counter()
            ev.synchronize()
            t["device_wait"] += time.perf_counter() - tw
        ids_acc.append(page_ids)
        vec_acc.append(host.numpy())
        return int((page_ids >= 0).sum())
