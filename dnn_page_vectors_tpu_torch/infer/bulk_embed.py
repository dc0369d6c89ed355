"""Corpus -> vector bulk-embed job on one device.

Counterpart of the JAX package's infer/bulk_embed.py. The towers run in
eval mode under ``torch.inference_mode`` (each encode sets eval mode, as
a Trainer that shares the model sets train mode at each step); every
output row is L2-normalized in float32.

Dtype contract (as in the JAX package): page vectors leave the card as
FLOAT16 (the store's own rounding, applied before the device->host copy,
which halves the bytes of the job's whole output), while query vectors stay
FLOAT32 (they feed the float32 top-k scorer directly and are never bulk
traffic). An int8 store's rows are quantized on the device
(``quantize_rows``, the host quantization's math in torch ops on the
float16 rows), so only the int8 codes and float16 scales cross to the
host: 1 byte a dimension instead of 2.

The sweep overlaps three things: a pool of tokenizer workers
(``data.tokenize_workers``) reads and tokenizes the next batches while the
card encodes the current one, and a background writer thread writes the
last finished shard (``_ShardWriter``). A batch's encode is enqueued, its
result is copied into pinned host memory without blocking, and the host
waits on it only after the next batch's encode is enqueued. The stores are
byte for byte those of one worker.
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.config import Config
from dnn_page_vectors_tpu_torch.data.loader import (
    iter_corpus_batches, ordered_parallel_map, prefetch_to_device,
    read_workers, to_device)
from dnn_page_vectors_tpu_torch.infer.vector_store import (
    SCALE_FLOOR, VectorStore)
from dnn_page_vectors_tpu_torch.models.losses import l2_normalize
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device
from dnn_page_vectors_tpu_torch.utils.profiling import PipelineProfiler


def quantize_rows(v16: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float16 rows [n, D] on any device -> (int8 codes [n, D], float16
    scales [n]) on that device: the int8 store's quantization
    (infer/vector_store.py ``quantize_rows``) in torch ops. Every step is
    a correctly rounded float32 operation (max, the division by 127, the
    float16 round trip, the division by the scale, round half to even), so
    the codes and scales equal the host's byte for byte."""
    v = v16.float()
    scale = v.abs().amax(dim=-1) / 127.0
    safe = torch.clamp_min(scale.half().float(), float(SCALE_FLOOR))
    codes = torch.clamp(torch.round(v / safe[:, None]), -127, 127)
    return codes.to(torch.int8), safe.half()


class _ShardWriter:
    """The bulk embed's background store writer: a shard's concatenation
    and ``write_shard`` run on this thread, so the disk write of shard i
    overlaps the card's encodes of shard i+1.

    * At most `max_pending` shards wait in its queue; a slow disk holds
      the device loop back instead of filling host memory.
    * A shard is recorded complete only by ``write_shard``, after its data
      files are durable (fsynced, then the manifest), so a job killed
      mid-write never resumes past an unwritten shard.
    * The writer's first error re-raises, as itself, at the next
      ``submit`` (the device loop stops) or at ``close``, so the embed
      never returns over a failed write. ``close(raise_error=False)`` is
      the unwind path: an error already raised on the main path wins.
    """

    _SENTINEL = object()

    def __init__(self, store: VectorStore, q8: bool, max_pending: int = 2,
                 profiler: Optional[PipelineProfiler] = None):
        self._store = store
        self._q8 = q8
        self._prof = profiler
        self._q: "queue_mod.Queue[object]" = queue_mod.Queue(
            maxsize=max(1, max_pending))
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="shard-writer")
        self._t.start()

    def submit(self, index: int, ids_acc: List[np.ndarray],
               out_acc: List[Tuple[np.ndarray, ...]]) -> None:
        """Queues one finished shard (its batches' ids and outputs, joined
        on the writer's thread). Blocks while the queue is full; raises the
        writer's error as soon as there is one."""
        t0 = time.perf_counter()
        try:
            while True:
                if self._err is not None:
                    raise self._err
                try:
                    self._q.put((index, ids_acc, out_acc), timeout=0.1)
                    return
                except queue_mod.Full:
                    continue
        finally:
            if self._prof is not None:
                self._prof.add("write_wait", time.perf_counter() - t0)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            if self._err is not None:
                continue        # drain after a failure: submit never hangs
            try:
                index, ids_acc, out_acc = item
                t0 = time.perf_counter()
                ids = np.concatenate(ids_acc)
                cols = [np.concatenate(c) for c in zip(*out_acc)]
                if self._q8:
                    self._store.write_shard(index, ids, codes=cols[0],
                                            scales=cols[1])
                else:
                    self._store.write_shard(index, ids, cols[0])
                if self._prof is not None:
                    self._prof.add("write", time.perf_counter() - t0)
            except BaseException as e:
                self._err = e

    def close(self, raise_error: bool = True) -> None:
        """Joins the writer (writing what is queued) and re-raises its
        first error unless `raise_error` is False."""
        if self._t.is_alive():
            self._q.put(self._SENTINEL)
            self._t.join()
        if raise_error and self._err is not None:
            raise self._err


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
    def encode_pages_q8(self, ids: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, page_len] ids on the device -> (int8 codes [B, D], float16
        scales [B]) of the int8 store, quantized on the device."""
        return quantize_rows(self.encode_pages(ids))

    @torch.inference_mode()
    def encode_queries(self, ids: torch.Tensor,
                       model: Optional[torch.nn.Module] = None
                       ) -> torch.Tensor:
        """[B, query_len] ids on the device -> [B, D] float32 rows, on the
        device. `model` encodes with another tower of the same geometry
        (a rolling migration's target, infer/serve.py) instead of this
        embedder's."""
        if model is None:
            self._eval_mode()
            model = self.model
        elif model.training:
            model.eval()
        return l2_normalize(model.encode_query(ids))

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
        run = self.encode_queries if tower == "query" else self.encode_pages
        bs = batch_size or self.cfg.eval.embed_batch_size

        def tokenize(part):
            enc = tok.encode_batch(part)
            if enc.shape[0] < bs:
                pad = bs - enc.shape[0]
                enc = np.concatenate(
                    [enc, np.zeros((pad,) + enc.shape[1:], enc.dtype)])
            return enc, len(part)
        parts = [list(texts[s: s + bs]) for s in range(0, len(texts), bs)]
        chunks = []
        # the tokenizer pool's threads (the C++ encoders drop the GIL)
        # tokenize the next batches while each encode is only enqueued
        for enc, n in ordered_parallel_map(
                tokenize, parts,
                workers=min(self.cfg.data.tokenize_workers, len(parts))):
            chunks.append(run(to_device(enc, self.device))[:n])
        if chunks:
            return torch.cat(chunks).cpu().numpy()
        return np.zeros((0, self.cfg.model.out_dim),
                        np.float32 if tower == "query" else np.float16)

    # -- the bulk job -----------------------------------------------------
    def _to_host(self, tensors: Tuple[torch.Tensor, ...]):
        """Start the device->host copies of `tensors`; returns (host
        tensors, event to wait on). On the CPU they are already host
        memory."""
        if self.device.type == "cpu":
            return tensors, None
        hosts = []
        for t in tensors:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
        ev = torch.cuda.Event()
        ev.record()
        return tuple(hosts), ev

    def embed_corpus(self, corpus, store: VectorStore,
                     batch_size: Optional[int] = None, resume: bool = True,
                     workers: Optional[int] = None,
                     write_pending: Optional[int] = None,
                     profiler: Optional[PipelineProfiler] = None,
                     start: int = 0, stop: Optional[int] = None
                     ) -> VectorStore:
        """Sweep the corpus into the store, one store shard at a time.

        `start` / `stop` restrict the sweep to the pages [start, stop),
        both on store shard bounds (`stop` may be the corpus end): the
        manual fleet's slice, one process each, each with its own writer
        manifest (``VectorStore(writer_id=start // shard_size)``), merged
        by ``merge_writers`` once all are done.

        An int8 store gets codes and scales quantized on the device
        (``encode_pages_q8``); any other store float16 rows.

        Host pipeline: `workers` tokenizer workers (default
        ``data.tokenize_workers``; one for a corpus whose reads hold the
        GIL, ``read_workers``) read and tokenize batches concurrently,
        reassembled in order (``iter_corpus_batches``), and a producer
        thread pins them and feeds the card (``prefetch_to_device``); the
        shards are written on a background thread with at most
        `write_pending` (default ``eval.writeback_depth``) queued
        (``_ShardWriter``), which joins and re-raises before this returns.
        With any number of workers the store's files are those of one.

        Resume: completed shards are recorded in the store manifest (after
        their files are durably written) and skipped on restart; a shard
        whose bytes no longer match its record is quarantined first and
        re-embedded.

        Sets ``self.stats``: pages, seconds, pages_per_sec; the seconds the
        device loop waited for host batches (``produce_s``) and for the
        card's results (``device_wait_s``), and the writer's seconds
        (``write_s``); and `profiler`'s stage split (``stage_<name>_s`` and
        ``_n``: read, tokenize, produce_wait, h2d, compute, device_wait,
        write, write_wait; read and tokenize summed over the workers)."""
        bs = batch_size or self.cfg.eval.embed_batch_size
        if store.manifest.get("compacted_through"):
            # a compacted base holds rows by id order under new shard
            # indices: the per-index resume below would re-embed, and
            # double-assign, the whole base range
            raise ValueError(
                f"store at {store.directory} has been compacted (through "
                f"generation {store.manifest['compacted_through']}); the "
                "base embed is complete: append new pages with "
                "append_corpus / `cli append` instead")
        shard_size = store.manifest["shard_size"]
        if shard_size % bs and shard_size < corpus.num_pages:
            raise ValueError(f"store shard_size {shard_size} must be a "
                             f"multiple of the batch size {bs}")
        stop = corpus.num_pages if stop is None else min(stop,
                                                         corpus.num_pages)
        if start % shard_size:
            raise ValueError(f"start={start} must be a multiple of the store "
                             f"shard_size {shard_size}")
        if stop % shard_size and stop != corpus.num_pages:
            raise ValueError(f"stop={stop} must be shard-aligned (multiple of "
                             f"{shard_size}) or the corpus end "
                             f"{corpus.num_pages}")
        if resume:
            store.verify()
        done = store.completed_shards() if resume else set()
        q8 = store.manifest["dtype"] == "int8"
        encode = self.encode_pages_q8 if q8 else (
            lambda ids: (self.encode_pages(ids),))
        workers = read_workers(corpus, self.cfg.data.tokenize_workers
                               if workers is None else workers)
        write_pending = (self.cfg.eval.writeback_depth
                         if write_pending is None else write_pending)
        prof = PipelineProfiler() if profiler is None else profiler
        before = prof.stages()
        t0 = time.perf_counter()
        pages = 0
        writer = _ShardWriter(store, q8, max_pending=write_pending,
                              profiler=prof)
        try:
            for si in range(start // shard_size, -(-stop // shard_size)):
                if si in done:
                    continue
                lo = si * shard_size
                hi = min(lo + shard_size, corpus.num_pages)
                ids_acc: List[np.ndarray] = []
                out_acc: List[Tuple[np.ndarray, ...]] = []
                pending = None
                batches = iter_corpus_batches(
                    corpus, self.page_tok, bs, start=lo, stop=hi,
                    workers=workers, profiler=prof)
                for batch in prefetch_to_device(batches, self.device,
                                                profiler=prof,
                                                host_keys=("page_id",)):
                    with prof.stage("compute"):
                        nxt = (batch["page_id"],
                               *self._to_host(encode(batch["page"])))
                    if pending is not None:
                        pages += self._collect(pending, ids_acc, out_acc,
                                               prof)
                    pending = nxt
                if pending is not None:
                    pages += self._collect(pending, ids_acc, out_acc, prof)
                writer.submit(si, ids_acc, out_acc)
        except BaseException:
            writer.close(raise_error=False)   # the main path's error wins
            raise
        writer.close()
        dt = time.perf_counter() - t0
        st = prof.stages()
        spent = {k: st.get(k, 0.0) - before.get(k, 0.0)
                 for k in ("produce_wait", "device_wait", "write")}
        self.stats = {"pages": pages, "seconds": dt,
                      "pages_per_sec": pages / max(dt, 1e-9),
                      "produce_s": spent["produce_wait"],
                      "device_wait_s": spent["device_wait"],
                      "write_s": spent["write"], "workers": workers,
                      **prof.summary()}
        return store

    @staticmethod
    def _collect(pending, ids_acc, out_acc, prof) -> int:
        page_ids, hosts, ev = pending
        if ev is not None:
            with prof.stage("device_wait"):
                ev.synchronize()
        ids_acc.append(page_ids)
        out_acc.append(tuple(h.numpy() for h in hosts))
        return int((page_ids >= 0).sum())
