"""Query serving over a vector store, for one service on one card: the
port's counterpart of the JAX package's infer/serve.py ``SearchService``,
with its constructor shape, result format, micro-batcher, caches,
admission and metrics.

What a request goes through:

  * ``search(query)`` probes the result cache (``serve.result_cache``),
    then admission (``_admit``: an expired deadline, or one the windowed
    queue-wait p99 says cannot be met, is shed with DeadlineExceeded and
    counted in ``serve.deadline_shed``, never in ``serve.errors``); with
    the micro-batcher running (``start_batcher``) it then waits in a
    bounded queue, and one dispatcher thread coalesces what arrives within
    ``serve.batch_window_ms`` (fixed, or moved by ``AdaptiveWindow`` off
    the queue-wait p99) into one ``search_many`` per (k, nprobe), up to
    ``serve.max_batch``. A request whose deadline passes in the queue is
    shed at the door; a dispatch that raises is retried one request at a
    time, so the exception lands on exactly the failing request
    (``batch_retries`` counts each retry).
  * ``search_many(queries)`` embeds the queries through the LRU
    query-embedding cache (``serve.query_cache_size``; keyed on
    whitespace-normalized text and the store's model step): the misses,
    deduplicated within the call, are tokenized and encoded in one
    dispatch padded to a multiple of ``query_batch`` rows (8; the pad rows
    are all-pad, the fully masked row case of the flash kernel) on the
    card (``encodes`` counts dispatches; K1 launches once per layer of
    each). A hit launches nothing. The vectors stay on the card for the
    top-k; only the rows the cache keeps are copied to the host. Then the
    top-k and the formatting (page_id, score rounded to 4 decimals,
    snippet).

The top-k runs over one immutable ``_ServeView`` captured per call: the
store handle with its frozen generation chain and tombstones, and either
the store staged whole on the card as one [N, D] matrix at its stored
width (float16 rows, or int8 codes and their scales; the page ids stay on
the host), or nothing staged. The budget is decided before staging: a
store of at most ``preload_hbm_gb`` GiB is staged (a shard that fails to
stage raises), a larger one, or any store at ``preload_hbm_gb=0``, is
answered shard by shard from disk on the card by the streaming sweep
(``topk_over_store`` over the table of the view's store handle, whose
generation chain is frozen); ``preloaded`` says which.

``refresh()`` swaps in the store's current generation under live
traffic: it opens a fresh store handle, builds the new view beside the
old one and publishes it with one reference assignment, so a call that
captured the old view finishes on it and the next sees the new one. The
staged matrix lives in a buffer with room to grow: a view is its first N
rows. A refresh whose old rows are a prefix of the new table copies only
the appended rows from the host, into the rows past N (which no older
view reads), or, when the buffer is full, into a 1.25x larger buffer
after a copy of the old rows on the card. Rows a new tombstone killed
stay staged and are masked out of the top-k (``alive``), so a dead row
never takes a result slot; once they pass
``updates.restage_tombstone_density`` of the staged rows the live rows
are compacted on the card. A fresh stage copies live rows only.
``refresh()`` returns the JAX package's info dict, and the result cache's
key carries the view's store generation, so no entry of an older
generation is returned. ``refresh(update_index=...)`` also brings the IVF
index up to date (``IVFIndex.update``); an index that fails degrades that
view to exact search, recorded in ``index_error``.
Both give the same results except at ties. The staged top-k runs over
blocks of up to 256 query rows with 65,536-row chunks (eager PyTorch has
no compiled bucket shape to keep, so the top-k is not tiled by
``query_batch`` as the JAX program is). ``serve.index="ivf"`` opens the
IVF/PQ index (index/ivf.py) instead of staging; while it is unavailable
or stale against the store's model step a request is answered by the
exact sweep and counted in ``ann_fallbacks``.

Telemetry: every call runs under a request trace (utils/tracing.py): a
span tree of queue_wait (handed through the batcher's thread hop), then
tokenize / encode (cache hits annotated), topk, merge and format; traces
slower than ``obs.slow_ms`` land in the slow-query log. Counters,
histograms and events live in a per-service MetricsRegistry
(utils/telemetry.py) with windows of ``obs.window_s`` seconds:
``metrics()``, ``metrics_snapshot()`` and ``prometheus_text()``.

Rolling model migrations (maintenance/migrate.py): mid-sweep a store
holds two stamps, one a shard. ``begin_migration(model, step)`` attaches
the target tower; a view over a two-stamp store encodes each query once
per stamp (one dispatch a stamp: twice the K1 launches), keyed per stamp
in the query cache, and stacks the vectors [n, S*D] in ascending stamp
order (``_qv_blocks`` splits them). The staged matrix stays one [N, D]
buffer: its rows fall in runs of one stamp, each run is scored by its
stamp's query block on the card, and one top-k merges the runs' top-k's
(the streaming path sweeps each stamp's shards and merges on the host).
The IVF path serves exact while a view holds two stamps. A migrated
unit's rows replace staged rows at their positions: the refresh copies
the buffer on the card and writes only the unit's rows from the host
into the copy, so a call on the old view keeps reading its rows. The
``refresh()`` that sees the migration record gone adopts the target tower
as the embedder's model. The result cache's key composes the view's
stamps with its generation. ``start_maintenance()`` attaches the
MaintenanceService (maintenance/service.py) and, under
``maintenance.bg_rebuild``, defers drift rebuilds of the IVF index off
``refresh()`` to its rebuild pillar (the ``serve.index_rebuild_pending``
gauge).

Filtered retrieval (index/attrs.py): ``search``, ``search_many``,
``topk_vectors`` and the batcher take ``filters=`` (predicate text or a
compiled Predicate; a malformed one raises FilterError before admission).
The batcher coalesces per (k, nprobe, canonical text), the result cache
keys the canonical text, so a filtered entry never answers its
unfiltered twin, and every filtered dispatch records a
``filtered_query`` event. Through the index the predicate prefilters the
posting gather (escalating a short probe set by
``serve.filter_escalate``); on the exact path ``_filtered_exact`` masks
each shard's words on the host, gathers only the matching rows and
scores them on the card, one product a shard. ``serve.hot_postings_gb``
stages the index's hot posting set per view (``IVFIndex.stage_hot``)
after the index opens, with the popularity window of the view it
replaces; a stage that fails raises (no quiet fall back to the mmap
path). ``restage_hot()`` re-ranks and re-stages the current view's hot
set (a ``hot_restaged`` event).

Partitioned and replicated serving (infer/partition.py): with
``serve.partitions`` or ``serve.replicas`` above 1 the service holds a
``PartitionSet`` of P contiguous shard ranges x R replicas, each replica a
view of its own (``_build_view(entries=, hot_gb=)``: its rows staged, its
``IVFIndex.partition_view`` and its cut of the hot set). ``search_many``
encodes a bucket once (both stamps while a migration runs), snapshots the
published table, and scatters the matrix to one routed replica a
partition; the partitions' top-k's fold through ``merge_partition_topk``.
A predicate rides the scatter unchanged. ``refresh()`` rebuilds the table
partition by partition and publishes it with one assignment (its info
gains ``partitions``: each replica's restage milliseconds), and
``metrics()`` gains the partition block (``serve_partitions``,
``serve_replicas``, ``replica_shed``, ``partition_degraded``,
``partitions``).

The fleet over the wire (infer/partition_host.py): ``attach_gateway(gw)``
puts a ``WorkerGateway`` in the query path. A bucket is still encoded once
and its matrix copied to the host once; the gateway fans it out to one
routed partition worker a partition (hedged, with deadlines, and served
locally on the front end's own view when a worker fails), and routing sees
the workers' liveness (``set_liveness``). ``refresh()`` then broadcasts
the new generation to the workers (its info gains ``workers_refresh``),
and ``metrics()``'s transport block gains ``hedge_fires`` and the
gateway's counts (``rpcs``, ``rpc_fallbacks``, ``workers_live``, ...).
With ``serve.result_cache_fleet`` the result cache is shared between front
ends: ``attach_cache_peers`` takes the siblings' socket clients, a local
miss probes them (``T_CACHE_LOOKUP``) and a fill is pushed to them
(``T_CACHE_PUT``), each peer behind a circuit breaker of its own; the
socket front end answers the peers' frames (``_result_cache_wire_get`` /
``_result_cache_wire_put``).

Left for a later slice (ROADMAP.md queue 1, item 8): the degraded mode.
"""
from __future__ import annotations

import contextlib
import queue as queue_mod
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.data.loader import to_device
from dnn_page_vectors_tpu_torch.index.attrs import compile_filters
from dnn_page_vectors_tpu_torch.index.ivf import IndexUnavailable, IVFIndex
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.transport import DeadlineExceeded
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.ops.topk import (
    chunked_topk, merge_topk_host, topk_over_store)
from dnn_page_vectors_tpu_torch.utils import faults
from dnn_page_vectors_tpu_torch.utils.profiling import (
    LatencyStats, PipelineProfiler)
from dnn_page_vectors_tpu_torch.utils.telemetry import MetricsRegistry
from dnn_page_vectors_tpu_torch.utils.tracing import Tracer

# the staged top-k's query block and row chunk: one [256, 65,536] float32
# score block (64 MiB) at most, 16 chunks over a 1M-row store
_TOPK_ROWS = 256
_TOPK_CHUNK = 65_536


def _host_rows(qv, n: int) -> np.ndarray:
    """The first n rows of host or device query vectors as a writable
    float32 host array."""
    if isinstance(qv, torch.Tensor):
        return qv[:n].float().cpu().numpy()
    return np.array(qv[:n], np.float32)


class _MicroBatcher:
    """Dynamic request coalescing for SearchService.search().

    Callers enqueue (query, k, Future) onto a bounded queue; ONE dispatcher
    thread pulls the first pending request, waits up to the window for
    more (never past `max_batch`), and answers the batch with one
    search_many call per distinct (k, nprobe, filters). The bounded queue
    backpressures callers when the dispatcher falls behind.

    Failure isolation: when a coalesced dispatch raises, the batch is
    retried one request at a time so the exception lands on exactly the
    failing request's future; the rest still get results. Each retried
    request counts in the service's ``batch_retries``.

    The window is read from the service per batch (`window_s`, a
    callable): fixed, or wherever AdaptiveWindow has moved it; every
    measured queue wait feeds the serve.queue_wait_ms histogram the
    controller reads."""

    _STOP = object()

    def __init__(self, svc: "SearchService", window_s, max_batch: int,
                 max_queue: int):
        self._svc = svc
        self._window_s = window_s            # () -> seconds, read per batch
        self._max = max(1, int(max_batch))
        self._q: "queue_mod.Queue[object]" = queue_mod.Queue(
            maxsize=max(self._max, int(max_queue)))
        self.batch_sizes: List[int] = []     # dispatch telemetry
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="serve-batcher")
        self._t.start()

    def submit(self, query: str, k: Optional[int],
               nprobe: Optional[int] = None,
               deadline: Optional[float] = None,
               filters: Optional[str] = None) -> Future:
        """Enqueue one request. `deadline` is ABSOLUTE on the service
        clock; admission-time shedding happens in the caller
        (`SearchService._admit`) before anything touches this queue.
        `filters` is the canonical predicate text or None: a filtered
        request never shares a dispatch with another filter's."""
        fut: Future = Future()
        # the caller's span rides the queue: the dispatcher runs on another
        # thread, where the contextvar chain breaks
        ctx = self._svc.tracer.current()
        self._q.put((query, (k, nprobe, filters), fut, time.perf_counter(),
                     ctx, deadline))
        return fut

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            batch = [item]
            deadline = time.perf_counter() + max(0.0, self._window_s())
            while len(batch) < self._max:
                rem = deadline - time.perf_counter()
                try:
                    nxt = (self._q.get_nowait() if rem <= 0
                           else self._q.get(timeout=rem))
                except queue_mod.Empty:
                    break
                if nxt is self._STOP:
                    self._dispatch(batch)
                    return
                batch.append(nxt)
            self._dispatch(batch)
            self._svc._adapt_window()

    def _dispatch(self, batch) -> None:
        svc = self._svc
        tracer = svc.tracer
        # the door: a request whose deadline expired while it queued is
        # rejected before it takes a bucket slot; its wait does not feed
        # the queue-wait instrument (it never dispatched)
        live = []
        for item in batch:
            deadline = item[5]
            if deadline is not None and svc._clock() >= deadline:
                item[2].set_exception(
                    svc._shed_deadline("expired_in_queue", deadline,
                                       trace=item[4]))
            else:
                live.append(item)
        if not live:
            return
        batch = live
        now = time.perf_counter()
        for _, _, _, t0, ctx, _ in batch:
            svc.profiler.add("queue_wait", now - t0)
            svc._m_queue_wait.observe((now - t0) * 1000.0)
            if ctx is not None:
                ctx.child("queue_wait", now - t0, t0=t0)
        # single writer: only the dispatcher thread appends
        self.batch_sizes.append(len(batch))
        by_key: Dict[tuple, list] = {}
        for query, key, fut, _, ctx, deadline in batch:
            by_key.setdefault(key, []).append((query, fut, ctx, deadline))
        for (k, nprobe, ftext), items in by_key.items():
            deadlines = [d for _, _, _, d in items if d is not None]
            group_dl = min(deadlines) if deadlines else None
            try:
                # the coalesced dispatch traces once under a detached root;
                # every request adopts the finished subtree
                with tracer.trace("dispatch", record=False,
                                  batch_size=len(items)) as dsp:
                    res = svc.search_many(
                        [q for q, _, _, _ in items], k=k, nprobe=nprobe,
                        filters=ftext, _record=False, deadline=group_dl)
            except BaseException:  # noqa: BLE001 — isolate per request
                for q, fut, ctx, deadline in items:
                    svc._m_retries.inc()
                    try:
                        with tracer.use(ctx):
                            fut.set_result(svc.search_many(
                                [q], k=k, nprobe=nprobe, filters=ftext,
                                _record=False, deadline=deadline)[0])
                    except BaseException as e:  # noqa: BLE001
                        fut.set_exception(e)
                continue
            for (_, fut, ctx, _), r in zip(items, res):
                if ctx is not None:
                    ctx.adopt(dsp)
                fut.set_result(r)

    def close(self) -> None:
        self._q.put(self._STOP)
        self._t.join()


class AdaptiveWindow:
    """Telemetry-driven micro-batch window controller (the JAX package's).

    Moves the window between `base_ms` and `max_ms` off one signal, the
    windowed queue-wait p99 of the serve.queue_wait_ms histogram:

      * pressure — queue-wait p99 >= `pressure_ratio` x the current window
        (requests stack behind in-flight dispatches) -> double the window,
        capped at `max_ms`;
      * idle — no queue-wait samples in the window, or a p99 below
        `idle_ratio` x the current window -> halve back toward `base_ms`.

    A lone caller's queue wait is about the window itself, between the two
    thresholds, so a trickle of traffic holds the window steady. Every
    change sets the serve.batch_window_ms gauge and calls `on_change`
    (the service emits a `window_adapt` event)."""

    def __init__(self, base_ms: float, max_ms: float, queue_wait,
                 gauge=None, on_change=None, pressure_ratio: float = 1.5,
                 idle_ratio: float = 0.25, min_samples: int = 4):
        self.base_ms = max(0.1, float(base_ms))
        self.max_ms = max(self.base_ms, float(max_ms))
        self._queue_wait = queue_wait        # Histogram (windowed)
        self._gauge = gauge
        self._on_change = on_change
        self.pressure_ratio = float(pressure_ratio)
        self.idle_ratio = float(idle_ratio)
        self.min_samples = max(1, int(min_samples))
        self._cur = self.base_ms
        self._lock = threading.Lock()
        if gauge is not None:
            gauge.set(self._cur)

    @property
    def current_ms(self) -> float:
        with self._lock:
            return self._cur

    def current_s(self) -> float:
        return self.current_ms / 1000.0

    def update(self) -> float:
        """One control step: read the windowed queue-wait stats, move the
        window if warranted, return the (possibly new) window in ms."""
        n = self._queue_wait.window_count()
        p99 = self._queue_wait.window_percentile(99)
        with self._lock:
            cur = self._cur
            new, reason = cur, None
            if n >= self.min_samples and p99 >= self.pressure_ratio * cur:
                new, reason = min(self.max_ms, cur * 2.0), "pressure"
            elif cur > self.base_ms and (
                    n == 0 or p99 <= self.idle_ratio * cur):
                new, reason = max(self.base_ms, cur / 2.0), "idle"
            if new == cur:
                return cur
            self._cur = new
        if self._gauge is not None:
            self._gauge.set(new)
        if self._on_change is not None:
            self._on_change(cur, new, p99, reason)
        return new


class _ServeView:
    """One serving snapshot: the store handle with its frozen generation
    chain and tombstone map, and what was made from it (the staged rows,
    their page ids and dead-row mask, or the IVF index). A call captures
    the view once, so everything it reads belongs together; ``refresh()``
    replaces the whole view with one reference assignment."""

    __slots__ = ("store", "entries", "restricted", "generation",
                 "docs_appended", "tombstoned", "num_vectors", "maint_stats",
                 "steps", "pages", "scales", "page_ids", "alive",
                 "dead_rows", "buf", "scale_buf", "keys", "slots",
                 "row_stamp", "runs", "top_gen", "stage_info", "index",
                 "index_error", "index_info")

    def __init__(self, store: VectorStore,
                 entries: Optional[List[Dict]] = None):
        self.store = store
        # the whole table, or (partitioned serving) one partition's
        # contiguous shard range: `restricted` keeps the staging, the
        # streaming sweep and the index to these entries
        self.entries: List[Dict] = (store.shards() if entries is None
                                    else list(entries))
        self.restricted = entries is not None
        self.generation = store.generation
        self.docs_appended = store.appended_vectors()
        self.tombstoned = store.tombstoned_count()
        self.num_vectors = store.num_vectors
        self.maint_stats: Dict = store.maintenance_stats()
        # the distinct stamps of the table, ascending: two mid-migration,
        # and then every query is encoded once per stamp; store-wide even
        # on a restricted view, so every partition splits a stacked query
        # matrix in the same block order
        self.steps: List[int] = store.model_steps()
        self.pages: Optional[torch.Tensor] = None    # [N, D] on the card
        self.scales: Optional[torch.Tensor] = None   # [N] (int8 stores)
        self.page_ids: Optional[np.ndarray] = None   # [N] int64, host
        # [N] bool on the card, False at staged rows a tombstone killed;
        # None when every staged row is live
        self.alive: Optional[torch.Tensor] = None
        self.dead_rows = 0
        # the buffers the staged rows are the head of (room to grow)
        self.buf: Optional[torch.Tensor] = None
        self.scale_buf: Optional[torch.Tensor] = None
        # (gen, index, count, vec CRC, stamp) of each staged entry, in
        # order; where its rows sit ((row offset, rows, the raw rows staged
        # or None for all), None once the rows were compacted on the card);
        # the runs of rows of one stamp ((start, end, stamp)); and the
        # chain generation the staged rows' tombstones were read at
        self.keys: List[tuple] = []
        self.slots: Optional[List[tuple]] = None
        self.row_stamp: Optional[np.ndarray] = None
        self.runs: List[tuple] = []
        self.top_gen = store.chain_generation
        self.stage_info: Dict = {}
        self.index: Optional[IVFIndex] = None
        self.index_error: Optional[str] = None
        self.index_info: Optional[Dict] = None


def _entry_key(store: VectorStore, entry: Dict) -> tuple:
    """(gen, index, count, vec CRC, stamp): the first three place an
    entry's rows; the last two say whether the rows are the same."""
    return (entry.get("gen", 0), entry["index"], entry["count"],
            entry.get("crc", {}).get("vec"), store.entry_step(entry))


def _stamp(key: tuple) -> int:
    return -1 if key[4] is None else int(key[4])


def _stamp_runs(row_stamp: np.ndarray) -> List[tuple]:
    """[(start, end, stamp)] runs of equal stamps over the staged rows."""
    n = int(row_stamp.shape[0])
    if n == 0:
        return []
    cut = np.flatnonzero(np.diff(row_stamp)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [n]])
    return [(int(a), int(b), int(row_stamp[a])) for a, b in zip(starts, ends)]


def _view_rows(view: _ServeView) -> int:
    """The rows a view answers from: the store's live rows, or on a
    restricted view its entries' rows (tombstones masked at read time)."""
    if view.restricted:
        return sum(int(e["count"]) for e in view.entries)
    return int(view.num_vectors)


def _live_rows(view: _ServeView) -> int:
    """A view's live rows: staged less masked dead, else `_view_rows`."""
    if view.pages is not None:
        return int(view.page_ids.shape[0]) - view.dead_rows
    return _view_rows(view)


class SearchService:
    def __init__(self, cfg, embedder: BulkEmbedder, corpus,
                 store: VectorStore, preload_hbm_gb: float = 4.0,
                 snippet_chars: int = 160, query_batch: Optional[int] = None,
                 log=None, profiler: Optional[PipelineProfiler] = None,
                 registry: Optional[MetricsRegistry] = None, clock=None):
        if cfg.serve.index not in ("exact", "ivf"):
            raise ValueError(f"unknown serve.index {cfg.serve.index!r} "
                             "(want exact | ivf)")
        if embedder.query_tok is None and not getattr(
                embedder, "vectors_only", False):
            # a partition worker's DeviceEmbedder serves vectors only
            raise ValueError("SearchService needs an embedder with a query "
                             "tokenizer")
        self.cfg = cfg
        self.embedder = embedder
        self.corpus = corpus
        self.store = store
        # the extra query towers of a rolling migration, keyed by stamp
        # (begin_migration): replaced whole on write, read as a snapshot
        self._towers: Dict[int, torch.nn.Module] = {}
        self.snippet_chars = snippet_chars
        serve, obs = cfg.serve, cfg.obs
        # stage seconds (queue_wait / tokenize / encode / topk / merge /
        # format), shared by the batcher and concurrent callers
        self.profiler = profiler or PipelineProfiler()
        self._window_s = obs.window_s
        self.registry = registry or MetricsRegistry(events=obs.events)
        self.tracer = Tracer(enabled=obs.enabled, slow_ms=obs.slow_ms,
                             slow_log_size=obs.slow_log_size,
                             buffer=obs.trace_buffer)
        reg, win, cap = self.registry, obs.window_s, obs.reservoir
        self._m_requests = reg.counter("serve.requests", window_s=win)
        self._m_errors = reg.counter("serve.errors", window_s=win)
        self._m_latency = reg.histogram("serve.latency_ms", window_s=win,
                                        cap=cap)
        self._m_cache_hits = reg.counter("serve.cache_hits", window_s=win)
        self._m_cache_misses = reg.counter("serve.cache_misses",
                                           window_s=win)
        # one per query-tower dispatch
        self._m_encodes = reg.counter("serve.encodes")
        self._m_retries = reg.counter("serve.batch_retries")
        # the queue-wait distribution behind the adaptive window and the
        # admission's SLO budget
        self._m_queue_wait = reg.histogram("serve.queue_wait_ms",
                                           window_s=win, cap=cap)
        # a shed at the door counts here and ONLY here: a shed is not an
        # error
        self._m_deadline_shed = reg.counter("serve.deadline_shed",
                                            window_s=win)
        # the socket front end's wire bytes (infer/server.py); raw is the
        # uncompressed equivalent of the same traffic
        self._m_wire_bytes = reg.counter("serve.wire_bytes")
        self._m_wire_raw = reg.counter("serve.wire_raw_bytes")
        # hedged RPCs of the worker gateway; the gateway itself once
        # attached (attach_gateway), None: the in-process scatter
        self._m_hedge_fired = reg.counter("serve.hedge_fired")
        self._fanout = None
        self._m_ann_lists = reg.counter("serve.ann_lists_scanned")
        self._m_ann_reranked = reg.counter("serve.ann_candidates_reranked")
        self._m_ann_fallbacks = reg.counter("serve.ann_fallbacks")
        self._m_ann_gather = reg.counter("serve.ann_gather_bytes")
        # live updates: hot swaps, how the index followed, and the staged
        # rows a tombstone killed (kept masked, or compacted on the card)
        self._m_refreshes = reg.counter("serve.refreshes")
        self._m_incremental = reg.counter("serve.incremental_updates")
        self._m_rebuilds = reg.counter("serve.full_rebuilds")
        self._m_restage_skipped = reg.counter("serve.restage_skipped")
        self._m_restage_forced = reg.counter("serve.restage_forced")
        upd = cfg.updates
        self._rebuild_drift = upd.rebuild_drift
        self._auto_update_index = upd.auto_update_index
        self._restage_density = upd.restage_tombstone_density
        self._refresh_lock = threading.Lock()   # one refresh at a time
        # LRU query-embedding cache: (model step, normalized text) -> host
        # float32 query vector; the step in the key means a store restamp
        # invalidates without a flush
        self._cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._cache_cap = serve.query_cache_size      # guarded-by: _cache_lock
        self._cache_lock = threading.Lock()
        # result cache: the JAX package's key -> formatted hits, probed
        # before admission
        self._rcache_cap = (serve.result_cache_size if serve.result_cache
                            else 0)
        self._rcache: "OrderedDict[tuple, list]" = OrderedDict()
        self._rcache_bytes = 0                        # guarded-by: _rcache_lock
        self._rcache_lock = threading.Lock()
        # the fleet result cache rides on the local one: the sibling front
        # ends' socket clients (attach_cache_peers), each with a breaker
        self._rcache_fleet = bool(self._rcache_cap
                                  and serve.result_cache_fleet)
        self._rcache_peers: list = []               # guarded-by: _rcache_lock
        self._rcache_peer_breakers: list = []       # guarded-by: _rcache_lock
        self._m_rcache_hits = reg.counter("serve.result_cache_hits",
                                          window_s=win)
        self._m_rcache_misses = reg.counter("serve.result_cache_misses",
                                            window_s=win)
        self._serve_index = serve.index
        self._nprobe = serve.nprobe
        self._pq_rerank = serve.pq_rerank
        # a short filtered probe set widens by filter_escalate (serve.filters
        # is the socket front end's); hot_postings_gb is each view's hot set
        # budget
        self._filter_escalate = serve.filter_escalate
        self._hot_gb = serve.hot_postings_gb
        # partitioned and replicated serving (infer/partition.py): P x R
        # workers behind the scatter-gather; 1 x 1 is the single view
        self._m_replica_shed = reg.counter("serve.replica_shed")
        self._m_partition_degraded = reg.counter("serve.partition_degraded")
        # the admission clock is injectable so deadlines are testable on a
        # fake clock; the rest of the query path reads time.perf_counter
        self._clock = clock if clock is not None else time.perf_counter
        self._deadline_ms = serve.deadline_ms
        self._window_base_ms = serve.batch_window_ms
        win_gauge = reg.gauge("serve.batch_window_ms")
        win_gauge.set(self._window_base_ms)
        self._window_ctl: Optional[AdaptiveWindow] = None
        if serve.batch_window_adaptive:
            self._window_ctl = AdaptiveWindow(
                self._window_base_ms, serve.batch_window_max_ms,
                self._m_queue_wait, gauge=win_gauge,
                on_change=self._on_window_adapt)
        self._batcher: Optional[_MicroBatcher] = None
        self._batch_sizes: List[int] = []   # telemetry after close()
        # the MaintenanceService (start_maintenance); with it attached and
        # maintenance.bg_rebuild, refresh() defers drift rebuilds of the
        # index to its rebuild pillar
        self._maintenance = None
        self._defer_rebuilds = False
        reg.gauge("serve.index_rebuild_pending").set(0.0)
        self._log = log
        self.query_batch = query_batch or 8
        self.warm_latency_ms: Optional[float] = None
        self._preload_gb = preload_hbm_gb
        self._pset = None
        if serve.partitions * serve.replicas > 1:
            from dnn_page_vectors_tpu_torch.infer.partition import (
                PartitionSet)
            self._pset = PartitionSet(self, store,
                                      partitions=serve.partitions,
                                      replicas=serve.replicas,
                                      shed_queue=serve.replica_shed_queue)
            # the control view: partition 0's primary (its store-level
            # fields are the same on every view of the table)
            self._view = self._pset.primary_view()
        else:
            self._view = self._build_view(store)
        reg.gauge("serve.preloaded").set(1.0 if self.preloaded else 0.0)
        reg.gauge("serve.store_generation").set(self._view.generation)
        if self._view.index is not None:
            reg.gauge("serve.index_generation").set(
                self._view.index.index_generation)
        if log is not None:
            log.write({
                "serve_hbm_resident": self.preloaded,
                "serve_vectors": self._view.num_vectors,
                "serve_query_batch": self.query_batch,
                "serve_query_cache_size": self._cache_cap,
                "serve_index": self._serve_index,
                "serve_ann_available": self._view.index is not None})

    # -- the view ----------------------------------------------------------
    def _build_view(self, store: VectorStore,
                    reuse: Optional[_ServeView] = None,
                    update_index: bool = False,
                    entries: Optional[List[Dict]] = None,
                    hot_gb: Optional[float] = None) -> _ServeView:
        """One serving view over `store`: the IVF index (brought up to
        date first with `update_index`), or the store staged when it fits
        the budget (reusing `reuse`'s staged rows where it can), or
        neither (the streaming sweep). Partitioned serving passes one
        partition's `entries` and its cut `hot_gb` of the hot posting
        set's budget."""
        view = _ServeView(store, entries=entries)
        ms = view.maint_stats
        self.registry.gauge("serve.tombstone_density").set(
            ms["tombstone_density"])
        self.registry.gauge("serve.dead_rows").set(ms["dead_rows"])
        self.registry.gauge("serve.reclaimable_bytes").set(
            ms["reclaimable_bytes"])
        if self._serve_index == "ivf":
            self._attach_index(view, update_index, reuse,
                               self._hot_gb if hot_gb is None else hot_gb)
            if (reuse is not None and reuse.index_error is not None
                    and view.index is not None):
                self.registry.event("index_restored", {
                    "was": reuse.index_error[:200],
                    "index_generation": view.index.index_generation})
            return view
        # the budget is decided before anything is staged
        rows = _view_rows(view)
        if rows > 0 and rows * store.row_bytes <= self._preload_gb * 2 ** 30:
            self._stage_view(view, reuse)
        return view

    def _attach_index(self, view: _ServeView, update_index: bool,
                      reuse: Optional[_ServeView] = None,
                      hot_gb: float = 0.0) -> None:
        """The view's IVF index: IVFIndex.update (incremental or a full
        rebuild) or IVFIndex.open, and on a restricted view its partition's
        ``partition_view``. An index that cannot serve (unavailable, or an
        update that raised: the refresh goes on without it) leaves
        `index_error` set, and the view answers exactly per request
        (counted in ann_fallbacks). On a PQ index with a `hot_gb` budget
        the hot posting set is staged, ranked by the popularity window of
        `reuse`'s index (the traffic did not change with the view); a
        stage that fails raises."""
        dev = self.embedder.device
        sv = self.cfg.serve
        failures = Exception if update_index else IndexUnavailable
        try:
            if update_index:
                view.index, view.index_info = IVFIndex.update(
                    view.store, rebuild_drift=self._rebuild_drift,
                    nlist=sv.nlist, iters=sv.kmeans_iters,
                    init=sv.kmeans_init,
                    defer_rebuild=self._defer_rebuilds, device=dev)
                action = view.index_info.get("action")
                if action == "incremental":
                    self._m_incremental.inc()
                elif action == "rebuild":
                    self._m_rebuilds.inc()
                    self.registry.event("drift_rebuild", {
                        "reason": view.index_info.get("reason"),
                        "nlist": view.index.nlist})
                # a drift past the limit deferred off this caller: the
                # hand-off to the background rebuild, cleared by its swap
                self.registry.gauge("serve.index_rebuild_pending").set(
                    1.0 if view.index_info.get("rebuild_pending") else 0.0)
            else:
                view.index = IVFIndex.open(view.store, device=dev)
        except failures as e:  # noqa: BLE001 -- the view serves exactly
            view.index = None
            view.index_error = f"{type(e).__name__}: {e}"
            self.registry.event("index_degraded",
                                {"reason": view.index_error[:200],
                                 "mode": "exact"})
            print(f"WARNING: IVF index unavailable ({view.index_error}); "
                  "serving the exact path per request", flush=True)
            return
        if view.restricted:
            # partitioned serving: this view gathers, scores and stages
            # only its partition's slice of the inverted file
            view.index = view.index.partition_view(
                [e["index"] for e in view.entries])
        idx = view.index
        if (reuse is not None and reuse.index is not None
                and reuse.index.nlist == idx.nlist):
            idx.scan_counts = reuse.index.scan_counts.copy()
        if idx.pq is not None and hot_gb > 0:
            # staged per view: a refresh re-opens the index, so the staged
            # codes and their dead-row marks follow the store's generations
            hot = idx.stage_hot(hot_gb * 2 ** 30)
            if view.index_info is not None:
                view.index_info = {**view.index_info, **hot}

    def _stage_view(self, view: _ServeView,
                    reuse: Optional[_ServeView] = None) -> None:
        """Stage the view's live rows on the card at their stored width.

        With `reuse` (the view being replaced), when its staged entries sit
        at the same places as this view's first entries, only the rows
        that changed are read and copied from the host: the entries past
        that prefix, into `reuse`'s buffer past its rows when they fit (no
        older view reads there), else into a buffer 1.25x the new row
        count after a copy of the old rows on the card; and the entries of
        the prefix whose rows changed in place (a migrated unit: the same
        ids, new vectors and stamp), written at their rows of a copy of
        the buffer made on the card, so a call on the old view keeps its
        rows. The old rows a newer tombstone killed stay, masked in
        `alive`, until they pass ``restage_tombstone_density`` of the
        rows; then the live rows are compacted on the card. Otherwise
        every live row is read and copied. A shard that fails to read or
        copy raises. ``view.stage_info`` records the rows and bytes each
        way."""
        store, dev = view.store, self.embedder.device
        q8 = store.manifest["dtype"] == "int8"
        entries = [e for e in view.entries if e["count"] > 0]
        keys = [_entry_key(store, e) for e in entries]
        n_keep = 0
        replace: List[int] = []
        if (reuse is not None and reuse.buf is not None and reuse.keys
                and [k[:3] for k in keys[: len(reuse.keys)]]
                == [k[:3] for k in reuse.keys]):
            replace = [i for i, k in enumerate(reuse.keys) if keys[i] != k]
            if replace and reuse.slots is None:
                replace = []      # the old rows were compacted: restage
            else:
                n_keep = len(reuse.keys)
        # the rows to copy from the host: every entry past the kept
        # prefix, its dead rows dropped before the copy (ids first, so the
        # buffer is sized before a vector is read)
        copy = [(e, store.load_ids(e)) for e in entries[n_keep:]]
        new_ids = (np.concatenate([ids[ids >= 0] for _, ids in copy])
                   if copy else np.zeros((0,), np.int64)).astype(np.int64)
        m = int(new_ids.shape[0])
        row_bytes = store.row_bytes
        pos = np.zeros((0,), np.int64)
        # the bytes each way: rows at their stored width (int8 scales
        # included), and the int64 row positions of the mask and compaction
        info = {"reused_entries": n_keep - len(replace),
                "replaced_entries": len(replace), "replaced_rows": 0,
                "copied_entries": len(entries) - n_keep, "h2d_rows": m,
                "h2d_bytes": m * row_bytes, "d2d_bytes": 0,
                "newly_dead_rows": 0, "compacted_on_card": False,
                "grew_buffer": False}
        slots: Optional[List[tuple]] = []
        if n_keep:
            n_old = int(reuse.page_ids.shape[0])
            slots = list(reuse.slots) if reuse.slots is not None else None
            # ids a generation past the old view's chain tombstoned: the
            # old rows they kill stay staged, masked
            old_ids = reuse.page_ids
            dead_new = np.array(sorted(
                i for i, g in store._tomb_gen.items() if g > reuse.top_gen),
                np.int64)
            pos = (np.flatnonzero(np.isin(old_ids, dead_new))
                   if dead_new.size else np.zeros((0,), np.int64))
            page_ids = np.concatenate([old_ids, new_ids])
            page_ids[pos] = -1
            info["newly_dead_rows"] = int(pos.size)
            buf, sbuf = reuse.buf, reuse.scale_buf
            n = n_old + m
            if n > buf.shape[0] or replace:
                # a fresh buffer (room to grow, or the old view's rows kept
                # whole under rows this view replaces), filled on the card
                cap = (max(n, -(-n * 5 // 4)) if n > buf.shape[0]
                       else int(buf.shape[0]))
                nb = torch.empty((cap, store.dim), dtype=buf.dtype,
                                 device=dev)
                nb[:n_old].copy_(buf[:n_old])
                info["d2d_bytes"] += n_old * store.dim * buf.element_size()
                if q8:
                    ns = torch.empty((cap,), dtype=torch.float16, device=dev)
                    ns[:n_old].copy_(sbuf[:n_old])
                    info["d2d_bytes"] += n_old * 2
                    sbuf = ns
                buf = nb
                info["grew_buffer"] = n > reuse.buf.shape[0]
            alive = None
            dead = reuse.dead_rows + int(pos.size)
            if dead:
                alive = torch.ones((n,), dtype=torch.bool, device=dev)
                if reuse.alive is not None:
                    alive[:n_old].copy_(reuse.alive)
                if pos.size:
                    alive[to_device(pos, dev)] = False
                    info["h2d_bytes"] += int(pos.size) * 8
            for i in replace:
                # a migrated entry: the same raw ids, so its rows go back
                # where the entry's rows were staged
                off, cnt, keep = slots[i]
                _, vecs, scl = store._load_entry(entries[i], raw=True)
                rows = np.array(vecs) if keep is None else \
                    np.asarray(vecs)[keep]
                if rows.shape[0] != cnt:
                    raise RuntimeError(
                        f"shard {entries[i]['index']} has {rows.shape[0]} "
                        f"rows to restage at {cnt} staged rows")
                buf[off: off + cnt].copy_(torch.from_numpy(rows))
                if q8:
                    sbuf[off: off + cnt].copy_(torch.from_numpy(
                        np.array(scl) if keep is None
                        else np.asarray(scl)[keep]))
                info["replaced_rows"] += cnt
            info["h2d_rows"] += info["replaced_rows"]
            info["h2d_bytes"] += info["replaced_rows"] * row_bytes
        else:
            n = m
            page_ids = new_ids
            buf = torch.empty((n, store.dim),
                              dtype=torch.int8 if q8 else torch.float16,
                              device=dev)
            sbuf = (torch.empty((n,), dtype=torch.float16, device=dev)
                    if q8 else None)
            n_old, alive, dead = 0, None, 0
        # the stamp of every staged row, for the runs of one stamp
        row_stamp = np.empty((n,), np.int64)
        if n_keep:
            row_stamp[:n_old] = reuse.row_stamp
            for i in replace:
                off, cnt, _ = slots[i]
                row_stamp[off: off + cnt] = _stamp(keys[i])
        o = n_old
        new_slots = []
        for (entry, ids), key in zip(copy, keys[n_keep:]):
            _, vecs, scl = store._load_entry(entry, raw=True)
            keep = ids >= 0
            whole = bool(keep.all())
            r = int(keep.sum())
            buf[o: o + r].copy_(torch.from_numpy(
                np.array(vecs) if whole else np.asarray(vecs)[keep]))
            if q8:
                sbuf[o: o + r].copy_(torch.from_numpy(
                    np.array(scl) if whole else np.asarray(scl)[keep]))
            new_slots.append((o, r, None if whole else keep))
            row_stamp[o: o + r] = _stamp(key)
            o += r
        if o != n_old + m:
            raise RuntimeError(f"staged {o - n_old} rows, want {m}")
        if slots is not None:
            slots += new_slots
        if n_keep and pos.size:
            # the restage policy, over the staged matrix as one block
            if dead / max(n, 1) > self._restage_density:
                # past the threshold: the live rows compacted on the card
                keep_pos = np.flatnonzero(page_ids >= 0)
                kp = to_device(keep_pos, dev)
                info["h2d_bytes"] += int(keep_pos.size) * 8
                nb = buf[:n].index_select(0, kp)
                info["d2d_bytes"] += 2 * int(keep_pos.size) * store.dim \
                    * buf.element_size()
                if q8:
                    sbuf = sbuf[:n].index_select(0, kp)
                buf, page_ids = nb, page_ids[keep_pos]
                row_stamp = row_stamp[keep_pos]
                n, alive, dead = int(keep_pos.size), None, 0
                slots = None         # the entries' rows moved
                info["compacted_on_card"] = True
                self._m_restage_forced.inc()
            else:
                self._m_restage_skipped.inc()
        view.buf, view.scale_buf = buf, sbuf
        view.pages = buf[:n]
        view.scales = sbuf[:n] if q8 else None
        view.page_ids, view.alive, view.dead_rows = page_ids, alive, dead
        view.keys = keys
        view.slots = slots
        view.row_stamp = row_stamp
        view.runs = _stamp_runs(row_stamp)
        view.stage_info = info

    @property
    def preloaded(self) -> bool:
        """True when the store is staged on the card; False when the
        streaming sweep (or the IVF index) answers."""
        return self._view.pages is not None

    @property
    def pages(self) -> Optional[torch.Tensor]:
        return self._view.pages

    @property
    def scales(self) -> Optional[torch.Tensor]:
        return self._view.scales

    @property
    def page_ids(self) -> Optional[np.ndarray]:
        return self._view.page_ids

    @property
    def index(self) -> Optional[IVFIndex]:
        return self._view.index

    @property
    def index_error(self) -> Optional[str]:
        return self._view.index_error

    @property
    def num_vectors(self) -> int:
        """Live rows: the staged rows less the masked dead ones, or the
        store's rows when nothing is staged; partitioned, the sum over the
        partitions' primary views."""
        if self._pset is not None:
            return sum(_live_rows(row[0]) for row in self._pset.table())
        return _live_rows(self._view)

    # -- the hot swap ------------------------------------------------------
    def refresh(self, update_index: Optional[bool] = None) -> Dict:
        """Swap in the store's current generation chain under live traffic.

        Opens a fresh store handle (its open checks every shard's bytes,
        the appended ones included), builds the new view beside the old
        one (``_stage_view`` copies from the host only what the old view
        does not hold; with ``serve.index="ivf"`` the index is brought up
        to date when `update_index`, default ``updates.auto_update_index``)
        and publishes it with one reference assignment: a call that
        captured the old view finishes on it, the next one sees the new.
        One refresh runs at a time. Returns the JAX package's info dict
        (store_generation, index_generation, docs_appended, new_docs,
        tombstoned, vectors, refresh_seconds, swap_ms, and index_update /
        index_error when they apply) plus ``stage``: the rows and bytes
        the staging moved each way."""
        t0 = time.perf_counter()
        part_info = None
        with self._refresh_lock:
            old = self._view
            new_store = VectorStore(self.store.directory)
            upd = (self._auto_update_index if update_index is None
                   else update_index)
            if self._pset is not None:
                # partitioned: a rolling swap, one partition restaging at a
                # time while the others serve untouched, the IVF update
                # once on the first view, one publish of the whole table
                part_info = self._pset.refresh(new_store, update_index=upd)
                view = self._pset.primary_view()
                self._view = view
                swap_ms = self._pset.last_swap_ms
            else:
                view = self._build_view(new_store, reuse=old,
                                        update_index=upd)
                if (view.pages is not None
                        and view.pages.device.type == "cuda"):
                    # the copies land before the view is published
                    torch.cuda.synchronize(view.pages.device)
                t_swap = time.perf_counter()
                self._view = view    # THE swap: one reference assignment
                swap_ms = (time.perf_counter() - t_swap) * 1000.0
            self.store = new_store
            self._m_refreshes.inc()
            # the tower adoption: once the migration record is gone the
            # sweep completed (the target tower becomes THE query tower)
            # or a reset abandoned it; either way the extra towers go
            adopted_step = None
            tw = self._towers
            if tw and new_store.migration is None:
                if new_store.model_step in tw:
                    model = tw[new_store.model_step]
                    self.embedder.model = model
                    adopted_step = int(new_store.model_step)
                self._towers = {}
        info = {
            "store_generation": view.generation,
            "index_generation": (view.index.index_generation
                                 if view.index is not None else None),
            "docs_appended": view.docs_appended,
            "new_docs": view.docs_appended - old.docs_appended,
            "tombstoned": view.tombstoned,
            "vectors": view.num_vectors,
            "refresh_seconds": round(time.perf_counter() - t0, 3),
            "swap_ms": round(swap_ms, 3),
        }
        if part_info is not None:
            # each partition's rows, shards, and each replica's restage
            # milliseconds and staging record
            info["partitions"] = part_info
        elif view.stage_info:
            info["stage"] = dict(view.stage_info)
        if self._fanout is not None:
            # the workers rebuild onto this generation on T_REFRESH, no
            # restart; until each acks, its slice serves from the view just
            # published, so the broadcast does not hold the refresh
            info["workers_refresh"] = self._fanout.broadcast_refresh(
                view.generation)
        if view.index_info is not None:
            info["index_update"] = view.index_info
        if view.index_error is not None:
            info["index_error"] = view.index_error
        mig = view.store.migration
        if mig is not None:
            # the sweep's progress: the stamps this view serves, and how
            # many of its shards carry the target stamp
            info["migration"] = {
                "from_step": mig.get("from_step"),
                "to_step": mig.get("to_step"),
                "shards_migrated": sum(
                    1 for e in view.store.shards()
                    if view.store.entry_step(e) == mig.get("to_step")),
                "shards_total": len(view.store.shards()),
                "stamps_serving": list(view.steps)}
        if adopted_step is not None:
            info["migration_adopted_step"] = adopted_step
        cur = self.tracer.current()
        self.registry.event("view_swap", {
            "store_generation": view.generation,
            "new_docs": info["new_docs"], "swap_ms": info["swap_ms"],
            "index_error": view.index_error,
        }, trace_id=cur.trace_id if cur is not None else None)
        self.registry.gauge("serve.store_generation").set(view.generation)
        self.registry.gauge("serve.preloaded").set(
            1.0 if view.pages is not None else 0.0)
        if view.index is not None:
            self.registry.gauge("serve.index_generation").set(
                view.index.index_generation)
        if self._log is not None:
            self._log.write({"serve_refresh": self.refreshes, **info})
        return info

    def restage_hot(self) -> Dict:
        """Re-rank and re-stage the current view's hot posting set by its
        popularity window (``IVFIndex.stage_hot``, which then halves the
        window), or every view's of a partitioned table: no store re-open
        and no view swap. The staged state is published with one
        assignment, so a search in flight finishes on the residency it
        captured. Returns the stage_hot summary ({} when there is nothing
        to restage: exact serving, no PQ index, or no budget) and records
        a `hot_restaged` event."""
        pset = self._pset
        views = ([(view, spec.hot_gb)
                  for spec, row in zip(pset.specs(), pset.table())
                  for view in row] if pset is not None
                 else [(self._view, self._hot_gb)])
        out: Dict = {}
        with self._refresh_lock:
            for view, gb in views:
                idx = view.index if view is not None else None
                if idx is None or idx.pq is None or gb <= 0:
                    continue
                # partitioned, each view at its partition's cut of the
                # budget, and the summary sums them
                for key, val in idx.stage_hot(gb * 2 ** 30).items():
                    out[key] = (out.get(key, False) or val
                                if isinstance(val, bool)
                                else out.get(key, 0) + val)
            if out and self.embedder.device.type == "cuda":
                # the replicas read the staged sets on streams of their own
                torch.cuda.synchronize(self.embedder.device)
        if out:
            self.registry.event("hot_restaged", dict(out))
        return out

    def begin_migration(self, model: torch.nn.Module, step: int) -> None:
        """Attach the TARGET model of a rolling migration as a second query
        tower (the JAX package's ``begin_migration(params, step)``). Until
        the completion flip every query that misses the cache is encoded
        by both towers and each shard is scored with its stamp's; the
        refresh() that sees the flip adopts this tower and drops the old
        one. Idempotent per step."""
        model = model.to(self.embedder.device).eval()
        self._towers = {**self._towers, int(step): model}
        if self._log is not None:
            self._log.write({"serve_migration_tower": int(step),
                             "serving_step": self.store.model_step})

    def start_maintenance(self, threads: bool = True):
        """Attach the background MaintenanceService to this service: its
        compaction, rebuild, janitor and migrate pillars run on this store
        and hot-swap their work in through refresh(). Under
        ``maintenance.bg_rebuild`` a drift rebuild of the IVF index is
        deferred off refresh() from here on, to the rebuild pillar.
        `threads=False` attaches it without its workers (the caller drives
        ``run_once()``). Idempotent; close() stops it."""
        if self._maintenance is None:
            from dnn_page_vectors_tpu_torch.maintenance.service import (
                MaintenanceService)
            if self.cfg.maintenance.bg_rebuild:
                self._defer_rebuilds = True
            self._maintenance = MaintenanceService(
                self.cfg, self.store.directory, device=self.embedder.device,
                svc=self)
            if threads:
                self._maintenance.start()
        return self._maintenance

    # -- counters (registry instruments) ----------------------------------
    @property
    def cache_hits(self) -> int:
        return self._m_cache_hits.value

    @property
    def cache_misses(self) -> int:
        return self._m_cache_misses.value

    @property
    def result_cache_hits(self) -> int:
        return self._m_rcache_hits.value

    @property
    def result_cache_misses(self) -> int:
        return self._m_rcache_misses.value

    @property
    def encodes(self) -> int:
        """Query-tower dispatches so far (one per call with misses)."""
        return self._m_encodes.value

    @property
    def batch_retries(self) -> int:
        """Requests the micro-batcher retried alone after their coalesced
        dispatch raised."""
        return self._m_retries.value

    @property
    def ann_lists_scanned(self) -> int:
        return self._m_ann_lists.value

    @property
    def ann_candidates_reranked(self) -> int:
        return self._m_ann_reranked.value

    @property
    def ann_fallbacks(self) -> int:
        return self._m_ann_fallbacks.value

    @property
    def ann_gather_bytes(self) -> int:
        return self._m_ann_gather.value

    @property
    def refreshes(self) -> int:
        return self._m_refreshes.value

    @property
    def incremental_updates(self) -> int:
        """refresh()es whose IVF update appended to the index."""
        return self._m_incremental.value

    @property
    def full_rebuilds(self) -> int:
        """refresh()es whose IVF update rebuilt the index in full."""
        return self._m_rebuilds.value

    @property
    def restage_skipped(self) -> int:
        """refresh()es that kept newly tombstoned staged rows, masked."""
        return self._m_restage_skipped.value

    @property
    def restage_forced(self) -> int:
        """refresh()es that compacted the staged rows on the card."""
        return self._m_restage_forced.value

    @property
    def replica_shed(self) -> int:
        """Requests routed off a partition's primary replica (restaging,
        degraded or over its queue budget)."""
        return self._m_replica_shed.value

    @property
    def partition_degraded_serves(self) -> int:
        """Requests a partition answered on a degraded replica because
        every replica of it was degraded."""
        return self._m_partition_degraded.value

    @property
    def partition_set(self):
        """The PartitionSet (None on a single-view service)."""
        return self._pset

    @property
    def deadline_sheds(self) -> int:
        return self._m_deadline_shed.value

    @property
    def hedge_fires(self) -> int:
        return self._m_hedge_fired.value

    @property
    def fanout(self):
        """The attached WorkerGateway (None: the in-process scatter)."""
        return self._fanout

    def attach_gateway(self, gateway) -> None:
        """Put a partition_host.WorkerGateway in the query path: the
        scatter becomes an RPC fan-out to the registered workers, and
        routing takes the workers' liveness on top of the replicas'
        health, so a replica whose worker is lost sheds with reason
        "liveness". ``attach_gateway(None)`` detaches (whoever opened the
        gateway closes it)."""
        self._fanout = gateway
        pset = gateway.partition_set if gateway is not None else self._pset
        if pset is not None:
            pset.set_liveness(
                gateway.worker_alive if gateway is not None else None)

    @property
    def wire_bytes(self) -> int:
        return self._m_wire_bytes.value

    @property
    def wire_raw_bytes(self) -> int:
        """Raw-frame equivalent of wire_bytes; equals wire_bytes when no
        connection negotiated compression."""
        return self._m_wire_raw.value

    @property
    def batch_sizes(self) -> List[int]:
        """The size of every coalesced dispatch so far."""
        b = self._batcher
        return list(b.batch_sizes if b is not None else self._batch_sizes)

    # -- admission ---------------------------------------------------------
    def default_deadline(self, deadline_ms: Optional[float] = None
                         ) -> Optional[float]:
        """Resolve a RELATIVE deadline budget (ms; None = the
        serve.deadline_ms default; <= 0 = none) into an ABSOLUTE deadline
        on the service clock, or None."""
        dl = self._deadline_ms if deadline_ms is None else deadline_ms
        if dl is None or dl <= 0:
            return None
        return self._clock() + dl / 1000.0

    def _shed_deadline(self, reason: str, deadline: Optional[float],
                       queue_wait_p99_ms: Optional[float] = None,
                       trace=None) -> DeadlineExceeded:
        """Count and record one shed and BUILD (not raise) the exception:
        admission raises it, the micro-batch door sets it on the shed
        request's future."""
        self._m_deadline_shed.inc()
        rem_ms = (None if deadline is None
                  else round((deadline - self._clock()) * 1000.0, 3))
        cur = trace if trace is not None else self.tracer.current()
        attrs = {"reason": reason, "remaining_ms": rem_ms}
        if queue_wait_p99_ms is not None:
            attrs["queue_wait_p99_ms"] = round(queue_wait_p99_ms, 3)
        self.registry.event("deadline_shed", attrs,
                            trace_id=getattr(cur, "trace_id", None))
        msg = f"request shed at admission ({reason}"
        if rem_ms is not None:
            msg += f"; {rem_ms} ms remaining"
        if queue_wait_p99_ms is not None:
            msg += f"; queue-wait p99 {queue_wait_p99_ms:.1f} ms"
        return DeadlineExceeded(msg + ")")

    def _admit(self, deadline: Optional[float]) -> None:
        """Admission: (1) a deadline that has already passed is shed; (2)
        with the batcher on, a request whose remaining budget is below the
        windowed queue-wait p99 (at least 4 samples) cannot make it and is
        shed before it takes queue capacity or a bucket slot. Raises
        DeadlineExceeded; a request without a deadline always admits."""
        if deadline is None:
            return
        rem_ms = (deadline - self._clock()) * 1000.0
        if rem_ms <= 0.0:
            raise self._shed_deadline("expired", deadline)
        if self._batcher is not None:
            qw = self._m_queue_wait
            if qw.window_count() >= 4:
                p99 = qw.window_percentile(99)
                if p99 > rem_ms:
                    raise self._shed_deadline("slo_budget", deadline,
                                              queue_wait_p99_ms=p99)

    @contextlib.contextmanager
    def _stage(self, name: str, **attrs):
        """One serving stage, observed twice from one clock: cumulative
        seconds into the PipelineProfiler and a span on the active request
        trace. Yields the span so call sites can attach attributes."""
        t0 = time.perf_counter()
        with self.tracer.span(name, **attrs) as sp:
            try:
                yield sp
            finally:
                self.profiler.add(name, time.perf_counter() - t0)

    # -- adaptive batching -------------------------------------------------
    @property
    def batch_window_ms(self) -> float:
        """The micro-batch window in force (ms)."""
        return (self._window_ctl.current_ms if self._window_ctl is not None
                else self._window_base_ms)

    def _adapt_window(self) -> None:
        if self._window_ctl is not None:
            self._window_ctl.update()

    def _on_window_adapt(self, old_ms: float, new_ms: float,
                         queue_wait_p99_ms: float, reason: str) -> None:
        cur = self.tracer.current()
        self.registry.event("window_adapt", {
            "old_ms": round(old_ms, 3), "new_ms": round(new_ms, 3),
            "queue_wait_p99_ms": round(queue_wait_p99_ms, 3),
            "reason": reason,
        }, trace_id=cur.trace_id if cur is not None else None)

    # -- the query encode and its cache -----------------------------------
    @staticmethod
    def _normalize(query: str) -> str:
        return " ".join(query.split())

    def _tokenize(self, queries: Sequence[str]) -> np.ndarray:
        """[n] texts -> query token ids padded with all-pad rows to a
        multiple of query_batch."""
        with self._stage("tokenize", queries=len(queries)):
            enc = self.embedder.query_tok.encode_batch(list(queries))
        pad = -len(queries) % self.query_batch
        if pad:
            enc = np.concatenate(
                [enc, np.zeros((pad,) + enc.shape[1:], enc.dtype)])
        return enc

    def _encode(self, enc: np.ndarray,
                model: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """Token ids -> [rows, D] float32 query vectors on the device: one
        query-tower dispatch (`model`: a migration's other tower)."""
        self._m_encodes.inc()
        ids = to_device(enc, self.embedder.device)
        if model is None:
            return self.embedder.encode_queries(ids)
        return self.embedder.encode_queries(ids, model=model)

    def _tower(self, step) -> Optional[torch.nn.Module]:
        """The query tower of `step`: a migration's tower attached for that
        stamp, else None (the embedder's own)."""
        tw = self._towers
        return tw.get(step) if step is not None else None

    def encode_queries(self, queries: Sequence[str]) -> torch.Tensor:
        """[n] texts -> [n_padded, D] float32 query vectors on the device,
        n_padded a multiple of query_batch, in one dispatch; no cache."""
        return self._encode(self._tokenize(queries))

    def clear_cache(self) -> None:
        """Flush the query-embedding cache and the result cache, and emit
        a `cache_cleared` event."""
        with self._cache_lock:
            embed_n = len(self._cache)
            self._cache.clear()
        with self._rcache_lock:
            result_n = len(self._rcache)
            self._rcache.clear()
            self._rcache_bytes = 0
        ev = {"embed_entries": embed_n, "result_entries": result_n}
        mig = self.store.migration
        if mig is not None:
            ev["migration"] = (f"{mig.get('from_step')}->"
                               f"{mig.get('to_step')}")
        self.registry.event("cache_cleared", ev)
        if self._log is not None:
            self._log.write({"serve_cache_cleared": True, **ev})

    def _embed_queries_cached(self, view: _ServeView,
                              queries: Sequence[str]) -> torch.Tensor:
        """[n] texts -> [n, D] float32 query vectors on the device through
        the LRU cache, or, when the view serves several stamps (a rolling
        migration), [n, S*D]: one D-wide block a stamp in ascending order,
        each encoded by its stamp's tower in its own dispatch and cache
        keyspace (``_qv_blocks`` splits them)."""
        steps = view.steps
        if len(steps) <= 1 and (not steps
                                or steps[0] == view.store.model_step):
            return self._embed_queries_step(queries, view.store.model_step)
        return torch.cat([self._embed_queries_step(queries, s)
                          for s in steps], dim=1)

    def _embed_queries_step(self, queries: Sequence[str],
                            step) -> torch.Tensor:
        """[n] texts -> [n, D] float32 query vectors of ONE stamp on the
        device through the LRU cache. Only the misses, deduplicated, pay
        tokenize + encode, all in one dispatch padded to a multiple of
        query_batch rows. The vectors stay on the device for the top-k:
        the host copy is made only of the rows the cache keeps."""
        model = self._tower(step)
        keys = [(step, self._normalize(q)) for q in queries]
        dev = self.embedder.device
        hits: List[int] = []
        hit_vecs: List[np.ndarray] = []
        miss: List[int] = []
        if self._cache_cap > 0:
            with self._cache_lock:
                for i, key in enumerate(keys):
                    vec = self._cache.get(key)
                    if vec is not None:
                        self._cache.move_to_end(key)
                        hits.append(i)
                        hit_vecs.append(vec)
                    else:
                        miss.append(i)
            self._m_cache_hits.inc(len(hits))
            self._m_cache_misses.inc(len(miss))
        else:
            miss = list(range(len(queries)))
        # an all-hit request has no tokenize/encode spans: say why
        cur = self.tracer.current()
        if cur is not None:
            cur.set_attrs(cache_hits=len(hits), cache_misses=len(miss))
        if hits:
            cached = to_device(np.stack(hit_vecs), dev)
            if not miss:
                return cached
        # repeats within the call encode once (they still count as misses):
        # slot[j] is the encoded row of miss[j]
        first: Dict[tuple, int] = {}
        slot: List[int] = []
        uniq: List[str] = []
        for i in miss:
            s = first.get(keys[i])
            if s is None:
                s = first[keys[i]] = len(uniq)
                uniq.append(queries[i])
            slot.append(s)
        # index rows go to the device before the encode is issued, so no
        # copy waits on it
        plain = not hits and slot == list(range(len(queries)))
        if not plain:
            rows = to_device(np.asarray(slot, np.int64), dev)
        if hits:
            hit_rows = to_device(np.asarray(hits, np.int64), dev)
            miss_rows = to_device(np.asarray(miss, np.int64), dev)
        enc = self._tokenize(uniq)
        with self._stage("encode", queries=len(uniq)):
            # [n_padded, D] on the device
            vecs = (self._encode(enc) if model is None
                    else self._encode(enc, model))
            if self._cache_cap > 0:
                host = vecs[: len(uniq)].cpu().numpy()
        if plain:
            out = vecs[: len(queries)]
        elif not hits:
            out = vecs.index_select(0, rows)
        else:
            out = torch.empty((len(queries), vecs.shape[1]),
                              dtype=vecs.dtype, device=vecs.device)
            out.index_copy_(0, hit_rows, cached.to(vecs.dtype))
            out.index_copy_(0, miss_rows, vecs.index_select(0, rows))
        if self._cache_cap > 0:
            with self._cache_lock:
                for i, s in zip(miss, slot):
                    self._cache[keys[i]] = host[s]
                    self._cache.move_to_end(keys[i])
                while len(self._cache) > self._cache_cap:
                    self._cache.popitem(last=False)
        return out

    # -- the result cache --------------------------------------------------
    def _result_cache_key(self, query: str, k: Optional[int],
                          nprobe: Optional[int],
                          view: Optional[_ServeView] = None,
                          filters=None) -> Optional[tuple]:
        """(normalized text, k, nprobe, store generation with the view's
        stamp in its high 32 bits, index generation, canonical filter text
        or ""), as the JAX package keys it; None when the cache is off. A
        filtered entry and its unfiltered twin have different keys. The
        stamp is
        the highest the view serves: the model step outside a migration,
        the target step once a unit of the sweep serves, so an answer
        scored with one tower never answers a query of another, whatever
        the generation (which every migration flip moves too)."""
        if self._rcache_cap <= 0:
            return None
        view = self._view if view is None else view
        index_gen = (view.index.index_generation
                     if view.index is not None else -1)
        stamp = max(view.steps) if view.steps else view.store.model_step
        sgen = ((int(view.generation) & 0xFFFFFFFF)
                | ((int(stamp or 0) & 0xFFFFFFFF) << 32))
        return (self._normalize(query), int(k or self.cfg.eval.recall_k),
                int(nprobe or 0), sgen, int(index_gen),
                str(getattr(filters, "text", filters) or ""))

    def _result_cache_get(self, key: Optional[tuple],
                          count: bool = True) -> Optional[list]:
        if key is None:
            return None
        with self._rcache_lock:
            hits = self._rcache.get(key)
            if hits is not None:
                self._rcache.move_to_end(key)
        if hits is None:
            if count:
                self._m_rcache_misses.inc()
            return None
        if count:
            self._m_rcache_hits.inc()
        # a copy per hit: callers may mutate what they receive
        return [dict(h) for h in hits]

    def _result_cache_put(self, key: Optional[tuple], hits: list) -> None:
        if key is None:
            return
        entry = [dict(h) for h in hits]
        with self._rcache_lock:
            old = self._rcache.pop(key, None)
            if old is not None:
                self._rcache_bytes -= self._entry_bytes(old)
            self._rcache[key] = entry
            self._rcache_bytes += self._entry_bytes(entry)
            while len(self._rcache) > self._rcache_cap:
                _, ev = self._rcache.popitem(last=False)
                self._rcache_bytes -= self._entry_bytes(ev)

    @staticmethod
    def _entry_bytes(hits: list) -> int:
        return 96 + sum(64 + len(h.get("snippet") or "") for h in hits)

    # -- the fleet result cache --------------------------------------------
    def attach_cache_peers(self, clients: Sequence) -> None:
        """Share the result cache with sibling front ends: their
        SocketSearchClient handles (built with result_cache=True). A local
        miss probes each peer's cache before computing, and a local fill
        is pushed to every peer without waiting. A peer that did not
        negotiate FLAG_RESULT_CACHE is a no-op. Each peer has a circuit
        breaker (``serve.breaker_*``): after K consecutive failed probes
        a down sibling costs one dial an open interval, not one a miss;
        ``serve.breaker_failures <= 0`` turns them off."""
        sv = self.cfg.serve
        with self._rcache_lock:
            self._rcache_peers = list(clients)
            self._rcache_peer_breakers = [
                faults.CircuitBreaker(
                    failures=sv.breaker_failures, open_s=sv.breaker_open_s,
                    max_open_s=sv.breaker_max_s,
                    on_open=lambda b: faults.count(
                        "cache_peer_breaker_open"))
                if sv.breaker_failures > 0 else None
                for _ in self._rcache_peers]

    def _peers_with_breakers(self) -> list:
        with self._rcache_lock:
            return list(zip(self._rcache_peers,
                            self._rcache_peer_breakers))

    def _peer_lookup(self, key: tuple) -> Optional[list]:
        """Probe the peers for a local miss; a hit is formatted against
        the local corpus (the same fleet-wide) and cached locally, so its
        next repeat stays in process."""
        peers = self._peers_with_breakers()
        if not peers:
            return None
        text, k, nprobe, store_gen, index_gen, ftext = key
        if ftext:
            # the wire key has no predicate slot: filtered entries stay
            # local, so a probe never aliases an unfiltered sibling entry
            return None
        for peer, br in peers:
            if br is not None and not br.allow():
                continue         # the breaker is open: skip that sibling
            try:
                got = peer.cache_lookup(text, k=k, nprobe=nprobe,
                                        store_gen=store_gen,
                                        index_gen=index_gen)
            except Exception:  # noqa: BLE001 -- a broken peer never
                if br is not None:     # breaks a query
                    br.record_failure()
                continue
            if br is not None:
                br.record_success()
            if got is None:
                continue
            scores, ids = got
            hits = self._format(scores[0], ids[0])
            self._result_cache_put(key, hits)
            return hits
        return None

    def _peer_put(self, key: Optional[tuple], hits: list) -> None:
        if key is None:
            return
        peers = self._peers_with_breakers()
        if not peers:
            return
        text, k, nprobe, store_gen, index_gen, ftext = key
        if ftext:
            return               # filtered fills never go to peers
        scores = np.full((k,), -np.inf, np.float32)
        ids = np.full((k,), -1, np.int64)
        for i, h in enumerate(hits[:k]):
            scores[i] = h["score"]
            ids[i] = h["page_id"]
        for peer, br in peers:
            if br is not None and not br.allow():
                continue
            try:
                # False: the frame never left (a broken connection, or a
                # peer without the flag), which feeds the breaker
                ok = peer.cache_put(text, k=k, nprobe=nprobe,
                                    store_gen=store_gen,
                                    index_gen=index_gen,
                                    scores=scores, ids=ids)
            except Exception:  # noqa: BLE001 -- as in _peer_lookup
                ok = False
            if br is not None:
                if ok:
                    br.record_success()
                else:
                    br.record_failure()

    def _result_cache_wire_get(self, ck) -> Optional[tuple]:
        """A peer's CacheKey probe (the socket front end's T_CACHE_LOOKUP):
        ([1, k] scores, [1, k] ids) on a hit, None on a miss, with the
        cache off, or for other generations. Never computes."""
        if not self._rcache_fleet:
            return None
        key = (self._normalize(ck.query), ck.k, int(ck.nprobe),
               ck.store_gen, ck.index_gen, "")
        hits = self._result_cache_get(key)
        if hits is None:
            return None
        scores = np.full((1, ck.k), -np.inf, np.float32)
        ids = np.full((1, ck.k), -1, np.int64)
        for i, h in enumerate(hits[:ck.k]):
            scores[0, i] = h["score"]
            ids[0, i] = h["page_id"]
        return scores, ids

    def _result_cache_wire_put(self, ck, scores: np.ndarray,
                               ids: np.ndarray) -> bool:
        """A peer's CacheKey fill (T_CACHE_PUT). Its generations are held
        against the live view's: a stale push (a peer behind a refresh) is
        dropped, never cached under a reachable key. The hits are
        formatted against the local corpus."""
        if not self._rcache_fleet:
            return False
        live = self._result_cache_key(ck.query, ck.k, ck.nprobe or None)
        if live is None or (live[3], live[4]) != (ck.store_gen,
                                                  ck.index_gen):
            return False
        key = (self._normalize(ck.query), ck.k, int(ck.nprobe),
               ck.store_gen, ck.index_gen, "")
        self._result_cache_put(
            key, self._format(np.asarray(scores).reshape(-1),
                              np.asarray(ids).reshape(-1)))
        return True

    # -- the micro-batcher -------------------------------------------------
    def start_batcher(self) -> "SearchService":
        """Route later search() calls through the micro-batcher.
        Idempotent; close() stops it."""
        if self._batcher is None:
            s = self.cfg.serve
            window_s = (self._window_ctl.current_s
                        if self._window_ctl is not None
                        else lambda: self._window_base_ms / 1000.0)
            self._batcher = _MicroBatcher(self, window_s, s.max_batch,
                                          s.max_queue)
        return self

    @property
    def batching(self) -> bool:
        return self._batcher is not None

    def close(self) -> None:
        if self._maintenance is not None:
            self._maintenance.close()
            self._maintenance = None
        if self._pset is not None:
            self._pset.close()
        if self._batcher is not None:
            self._batcher.close()
            # the batch sizes outlive the thread
            self._batch_sizes = self._batcher.batch_sizes
            self._batcher = None
        if self._log is not None:
            self._log.write(self.metrics())

    def __enter__(self) -> "SearchService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- metrics -----------------------------------------------------------
    def metrics(self) -> Dict:
        """Serving counters, the windowed view and the stage seconds,
        metrics-log ready. The counters of parts the port does not have
        yet (degraded mode, recompiles) are left out, not reported as 0."""
        total = self.cache_hits + self.cache_misses
        view = self._view
        rec = {
            "serve_index": self._serve_index,
            "num_vectors": self.num_vectors,
            "serve_preloaded": self.preloaded,
            # the generation this service answers from, and how it got it
            "store_generation": view.generation,
            "index_generation": (view.index.index_generation
                                 if view.index is not None else None),
            "docs_appended": view.docs_appended,
            "tombstoned": view.tombstoned,
            "refreshes": self.refreshes,
            "incremental_updates": self.incremental_updates,
            "full_rebuilds": self.full_rebuilds,
            "restage_skipped": self.restage_skipped,
            "restage_forced": self.restage_forced,
            "tombstone_density": view.maint_stats["tombstone_density"],
            "dead_rows": view.maint_stats["dead_rows"],
            "reclaimable_bytes": view.maint_stats["reclaimable_bytes"],
            "serve_cache_hits": self.cache_hits,
            "serve_cache_misses": self.cache_misses,
            "serve_cache_hit_rate": round(self.cache_hits / total, 4)
            if total else 0.0,
            "serve_encodes": self.encodes,
            "serve_batch_retries": self.batch_retries,
            "serve_batch_window_ms": round(self.batch_window_ms, 3),
            **self._window_metrics(),
            **self.profiler.summary(prefix="serve_stage_"),
        }
        sizes = self.batch_sizes
        if sizes:
            rec["serve_batches"] = len(sizes)
            rec["serve_mean_batch"] = round(sum(sizes) / len(sizes), 2)
        if self._pset is not None:
            # the partitioned topology and its routing health: each
            # partition's and replica's qps, p99, queue, sheds and
            # degraded serves (the loadtest report reads it as it is)
            rec["serve_partitions"] = self._pset.partitions
            rec["serve_replicas"] = self._pset.replicas
            rec["replica_shed"] = self.replica_shed
            rec["partition_degraded"] = self.partition_degraded_serves
            rec["partitions"] = self._pset.stats()
        # the wire block only when there is something in it
        transport: Dict = {}
        if self.wire_bytes:
            transport["wire_bytes"] = self.wire_bytes
            if self.wire_raw_bytes > self.wire_bytes:
                transport["wire_raw_bytes"] = self.wire_raw_bytes
                transport["wire_compression_ratio"] = round(
                    self.wire_raw_bytes / self.wire_bytes, 3)
        if self.deadline_sheds:
            transport["deadline_sheds"] = self.deadline_sheds
        if self.hedge_fires:
            transport["hedge_fires"] = self.hedge_fires
        if self._fanout is not None:
            transport.update(self._fanout.stats())
        if transport:
            rec["transport"] = transport
        if self._rcache_cap > 0:
            rhits, rmiss = self.result_cache_hits, self.result_cache_misses
            with self._rcache_lock:
                entries, rbytes = len(self._rcache), self._rcache_bytes
            rec["result_cache"] = {
                "hits": rhits, "misses": rmiss,
                "hit_rate": round(rhits / (rhits + rmiss), 4)
                if (rhits + rmiss) else 0.0,
                "entries": entries, "bytes": rbytes,
                "capacity": self._rcache_cap}
        if self._serve_index != "exact":
            idx = self.index
            rec.update(
                ann_lists_scanned=self.ann_lists_scanned,
                ann_candidates_reranked=self.ann_candidates_reranked,
                ann_fallbacks=self.ann_fallbacks,
                ann_gather_bytes=self.ann_gather_bytes,
                ann_index={
                    "index": self._serve_index, "nprobe": self._nprobe,
                    "nlist": idx.nlist if idx else None,
                    "available": idx is not None,
                    "pq_m": idx.pq_m if idx else 0,
                    "hot_rows": idx.hot_rows if idx else 0,
                    **({"error": self.index_error}
                       if self.index_error else {})})
        return rec

    def _window_metrics(self) -> Dict[str, float]:
        """Rates and tail latency over the last obs.window_s seconds: the
        "qps at p99 under X ms" pair reads straight off these."""
        req_w = self._m_requests.window_count()
        err_w = self._m_errors.window_count()
        hit_w = self._m_cache_hits.window_count()
        miss_w = self._m_cache_misses.window_count()
        lat = self._m_latency
        return {
            "serve_window_s": self._window_s,
            "serve_window_qps": round(self._m_requests.rate(), 3),
            "serve_window_error_rate": round(
                err_w / (req_w + err_w), 4) if (req_w + err_w) else 0.0,
            "serve_window_cache_hit_rate": round(
                hit_w / (hit_w + miss_w), 4) if (hit_w + miss_w) else 0.0,
            "serve_window_p50_ms": round(lat.window_percentile(50), 3),
            "serve_window_p95_ms": round(lat.window_percentile(95), 3),
            "serve_window_p99_ms": round(lat.window_percentile(99), 3),
            "serve_window_queue_wait_p99_ms": round(
                self._m_queue_wait.window_percentile(99), 3),
        }

    def autoscale_signals(self) -> Dict[str, float]:
        """The windowed pressure signals: queue-wait p99 and the deadline
        shed rate, read from the instruments the batcher and the door
        feed."""
        return {
            "queue_wait_p99_ms": round(
                self._m_queue_wait.window_percentile(99), 3),
            "queue_wait_samples": float(self._m_queue_wait.window_count()),
            "shed_rate": round(self._m_deadline_shed.rate(), 4),
            "window_s": self._window_s,
        }

    def metrics_snapshot(self) -> Dict:
        """metrics() plus the registry's typed instruments and event ring,
        all JSON-serializable (`cli serve-metrics --json`, `:metrics`)."""
        return {"metrics": self.metrics(), **self.registry.snapshot()}

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()

    # -- search ------------------------------------------------------------
    def warmup(self, k: Optional[int] = None, timing_iters: int = 3) -> None:
        """One search to warm the card, then `timing_iters` timed searches
        with both caches bypassed (the real encode path); their median is
        `warm_latency_ms`."""
        self.search_many(["warmup"], k=k)
        lat = LatencyStats()
        cap, self._cache_cap = self._cache_cap, 0
        rcap, self._rcache_cap = self._rcache_cap, 0
        try:
            for _ in range(max(1, timing_iters)):
                with lat.timed():
                    self.search_many(["warmup"], k=k)
        finally:
            self._cache_cap = cap
            self._rcache_cap = rcap
        self.warm_latency_ms = lat.percentile_ms(50)

    def search(self, query: str, k: Optional[int] = None,
               nprobe: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               deadline: Optional[float] = None,
               filters=None) -> List[Dict]:
        """One query -> top-k results. With the micro-batcher running the
        call enqueues and blocks on its future; otherwise it is a direct
        one-query search_many. `deadline_ms` is a relative budget (None =
        serve.deadline_ms; <= 0 = none), `deadline` an absolute one on the
        service clock; a request that cannot make it raises
        DeadlineExceeded (counted in serve.deadline_shed). `filters` keeps
        the rows whose attribute word matches the predicate (text or a
        Predicate, index/attrs.py); a malformed one raises FilterError (a
        ValueError) before admission."""
        pred = compile_filters(filters)
        if deadline is None:
            deadline = self.default_deadline(deadline_ms)
        # a repeat answers from the result cache before admission, so a
        # hit is never shed and never takes a bucket slot
        rkey = self._result_cache_key(query, k, nprobe, filters=pred)
        if rkey is not None:
            t0 = time.perf_counter()
            hits = self._result_cache_get(rkey, count=False)
            if hits is None:
                hits = self._peer_lookup(rkey)
            if hits is not None:
                self._m_rcache_hits.inc()
                self._m_requests.inc()
                self._m_latency.observe((time.perf_counter() - t0) * 1000.0)
                return hits
            self._m_rcache_misses.inc()
        self._admit(deadline)
        b = self._batcher
        if b is None:
            return self.search_many([query], k=k, nprobe=nprobe,
                                    filters=pred, deadline=deadline,
                                    _probe_cache=False)[0]
        t0 = time.perf_counter()
        try:
            with self.tracer.trace("search",
                                   k=k or self.cfg.eval.recall_k,
                                   query=self._normalize(query)[:80]):
                res = b.submit(query, k, nprobe, deadline=deadline,
                               filters=None if pred is None
                               else pred.text).result()
        except DeadlineExceeded:
            raise           # shed at the door: counted there, not an error
        except BaseException:
            self._m_errors.inc()
            raise
        self._m_requests.inc()
        self._m_latency.observe((time.perf_counter() - t0) * 1000.0)
        return res

    def search_many(self, queries: Sequence[str], k: Optional[int] = None,
                    nprobe: Optional[int] = None, filters=None,
                    *, _record: bool = True, _probe_cache: bool = True,
                    deadline: Optional[float] = None) -> List[List[Dict]]:
        """One result list per query, in order: dicts of page_id, score
        (rounded to 4 decimals) and snippet, best first. Direct callers
        (`_record`) count every query into the windowed request, error
        and latency instruments; the batcher records its requests itself.
        An all-hit call answers from the result cache. `filters` applies
        one predicate to the whole call."""
        k = k or self.cfg.eval.recall_k
        n = len(queries)
        if n == 0:
            return []
        pred = compile_filters(filters)
        if _record and _probe_cache and self._rcache_cap > 0:
            t0 = time.perf_counter()
            cached = [self._result_cache_get(
                self._result_cache_key(q, k, nprobe, filters=pred),
                count=False) for q in queries]
            miss_n = sum(1 for c in cached if c is None)
            if miss_n == 0:
                self._m_rcache_hits.inc(n)
                self._m_requests.inc(n)
                self._m_latency.observe(
                    (time.perf_counter() - t0) * 1000.0, n=n)
                return cached
            self._m_rcache_misses.inc(miss_n)
        # one view for the whole call; partitioned, one table, whose
        # partition 0 primary keys the result cache
        table = self._pset.table() if self._pset is not None else None
        view = table[0][0] if table is not None else self._view
        t0 = time.perf_counter()
        try:
            with self.tracer.root_or_span("search_many", n_queries=n, k=k):
                out = self._search_view(view, list(queries), n, k, nprobe,
                                        predicate=pred, table=table,
                                        deadline=deadline)
        except BaseException:
            if _record:
                self._m_errors.inc(n)
            raise
        if _record:
            self._m_requests.inc(n)
            self._m_latency.observe((time.perf_counter() - t0) * 1000.0,
                                    n=n)
        return out

    def _search_view(self, view: _ServeView, queries: List[str], n: int,
                     k: int, nprobe: Optional[int], predicate=None,
                     table: Optional[tuple] = None,
                     deadline: Optional[float] = None) -> List[List[Dict]]:
        if predicate is not None:
            # one event a filtered dispatch: its predicate and queries
            self.registry.event("filtered_query", {
                "predicate": predicate.text[:200], "n_queries": n})
        # the query is encoded once, before any scatter
        qv = self._embed_queries_cached(view, queries)
        fanout = self._fanout
        if fanout is not None and fanout.active():
            # over the wire (infer/partition_host.py): one RPC a partition
            # to the registered workers, deadlines, hedging, and a slice
            # served locally when its worker fails
            best_s, best_i = fanout.topk(qv, n, k, nprobe,
                                         deadline=deadline,
                                         predicate=predicate)
        elif table is not None:
            # partitioned: the matrix goes to one replica per partition of
            # `table`, each splitting it by its own stamps (_qv_blocks)
            best_s, best_i = self._pset.topk(qv, n, k, nprobe,
                                             predicate=predicate,
                                             table=table)
        else:
            best_s, best_i, _ = self._topk_view(view, qv, n, k, nprobe,
                                                predicate=predicate)
        with self._stage("format"):
            out = [self._format(best_s[i], best_i[i]) for i in range(n)]
        if self._rcache_cap > 0:
            for q, hits in zip(queries, out):
                key = self._result_cache_key(q, k, nprobe, view=view,
                                             filters=predicate)
                self._result_cache_put(key, hits)
                self._peer_put(key, hits)
        return out

    def topk_vectors(self, qv: np.ndarray, k: Optional[int] = None,
                     nprobe: Optional[int] = None,
                     deadline: Optional[float] = None,
                     filters=None) -> tuple:
        """Raw retrieval for pre-computed query vectors: (scores [n, k]
        float32, page_ids [n, k] int64, -1-padded), with no encode and no
        snippets (the socket front end's vector protocol)."""
        k = k or self.cfg.eval.recall_k
        pred = compile_filters(filters)
        if not isinstance(qv, torch.Tensor):
            qv = np.asarray(qv, np.float32)
        fanout = self._fanout
        if fanout is not None and fanout.active():
            return fanout.topk(qv, qv.shape[0], k, nprobe, deadline=deadline,
                               predicate=pred)
        if self._pset is not None:
            return self._pset.topk(qv, qv.shape[0], k, nprobe,
                                   predicate=pred)
        s, i, _ = self._topk_view(self._view, qv, qv.shape[0], k, nprobe,
                                  predicate=pred)
        return s, i

    def _qv_blocks(self, view: _ServeView, qv) -> Dict:
        """Split a query matrix into [n, D] blocks by stamp, ascending: the
        inverse of the stacked encode of ``_embed_queries_cached``. A wide
        matrix on a one-stamp view (a stacked encode that crossed the
        completion flip) gives this view's block by the migration's stamp
        order, else the last; a narrow one on a two-stamp view scores
        every shard with it (``serve_stamp_skew``)."""
        D = int(view.store.dim)
        w = int(qv.shape[1])
        if w % D:
            raise ValueError(f"query shapes [n, {w}] do not fit the store's "
                             f"{D}-d rows (a {D}-wide block a stamp)")
        steps = view.steps
        if len(steps) <= 1:
            step = steps[0] if steps else None
            if w <= D:
                return {step: qv}
            nb = w // D
            mig = view.store.migration or {}
            order = sorted({int(x) for x in (mig.get("from_step"),
                                             mig.get("to_step"))
                            if x is not None})
            at = (order.index(step)
                  if step in order and order.index(step) < nb else nb - 1)
            return {step: qv[:, at * D:(at + 1) * D]}
        if w <= D:
            faults.count("serve_stamp_skew")
            return {x: qv for x in steps}
        nb = w // D
        return {x: qv[:, min(i, nb - 1) * D:(min(i, nb - 1) + 1) * D]
                for i, x in enumerate(steps)}

    def _topk_view(self, view: _ServeView, qv: np.ndarray, n: int, k: int,
                   nprobe: Optional[int] = None, predicate=None):
        """(scores [n, k] float32, page_ids [n, k] int64, scan_bytes) of
        the first n rows of qv (float32, on the host or the device; [n,
        S*D] on a view of S stamps) over one view: through the index, the
        staged rows, or the streaming sweep; with a `predicate` off the
        index, ``_filtered_exact``. Each shard is scored with its stamp's
        block; a view of two stamps never consults the index."""
        blocks = self._qv_blocks(view, qv)
        if self._serve_index == "ivf":
            res = (self._ann_topk(view,
                                  _host_rows(next(iter(blocks.values())), n),
                                  k, nprobe, predicate)
                   if len(view.steps) <= 1 else None)
            if res is not None:
                return res
            self._m_ann_fallbacks.inc(n)   # the exact sweep serves it
        if predicate is not None:
            # the staged and the streaming top-k score every row, so
            # neither keeps a filtered query's scan to its matching rows
            return self._filtered_exact(view, blocks, n, k, predicate)
        dev = self.embedder.device
        if view.pages is None:
            with self._stage("topk", path="streaming"):
                scores, ids = self._stream_topk(view, blocks, n, k, dev)
            return scores, ids, _view_rows(view) * view.store.row_bytes
        with self._stage("topk", rows=view.num_vectors):
            q = {x: (b[:n].to(dev, torch.float32)
                     if isinstance(b, torch.Tensor)
                     else to_device(_host_rows(b, n), dev))
                 for x, b in blocks.items()}
            parts = [self._staged_topk(view, q, s, k)
                     for s in range(0, n, _TOPK_ROWS)]
        with self._stage("merge"):
            scores = torch.cat([p[0] for p in parts]).cpu().numpy()
            idx = torch.cat([p[1] for p in parts]).cpu().numpy()
        pids = np.where(idx >= 0, view.page_ids[np.clip(idx, 0, None)], -1)
        return (scores.astype(np.float32), pids.astype(np.int64),
                int(view.pages.shape[0]) * view.store.row_bytes)

    def _staged_topk(self, view: _ServeView, q: Dict, s0: int, k: int):
        """The top-k of one block of query rows over the staged matrix:
        each run of one stamp scored with that stamp's queries on the
        card, then one top-k over the runs' candidates."""
        runs = view.runs
        if len(runs) <= 1:
            step = runs[0][2] if runs else None
            qb = (q.get(step) if step in q else next(iter(q.values())))
            return chunked_topk(qb[s0: s0 + _TOPK_ROWS], view.pages, k=k,
                                chunk=_TOPK_CHUNK, scales=view.scales,
                                alive=view.alive)
        cand_s, cand_i = [], []
        for a, b, step in runs:
            qb = q[step] if step in q else next(iter(q.values()))
            sc, ix = chunked_topk(
                qb[s0: s0 + _TOPK_ROWS], view.pages[a:b], k=k,
                chunk=_TOPK_CHUNK,
                scales=None if view.scales is None else view.scales[a:b],
                alive=None if view.alive is None else view.alive[a:b])
            cand_s.append(sc)
            cand_i.append(torch.where(ix >= 0, ix + a, ix))
        best_s, at = torch.topk(torch.cat(cand_s, dim=1), k, dim=1)
        best_i = torch.gather(torch.cat(cand_i, dim=1), 1, at)
        return best_s, torch.where(torch.isfinite(best_s), best_i,
                                   torch.full_like(best_i, -1))

    def _stream_topk(self, view: _ServeView, blocks: Dict, n: int, k: int,
                     dev) -> tuple:
        """The streaming sweep over the view's store handle, once per
        stamp over that stamp's shards, merged on the host."""
        if len(view.steps) <= 1:
            qb = next(iter(blocks.values()))
            return topk_over_store(_host_rows(qb, n), view.store, k=k,
                                   chunk=_TOPK_CHUNK,
                                   query_batch=_TOPK_ROWS,
                                   entries=(view.entries if view.restricted
                                            else None), device=dev)
        best_s = np.full((n, k), -np.inf, np.float32)
        best_i = np.full((n, k), -1, np.int64)
        for step in view.steps:
            group = [e for e in view.entries
                     if view.store.entry_step(e) == step]
            if not group:
                continue
            sc, ids = topk_over_store(
                _host_rows(blocks[step], n), view.store, k=k,
                chunk=_TOPK_CHUNK, query_batch=_TOPK_ROWS, entries=group,
                device=dev)
            best_s, best_i = merge_topk_host(best_s, best_i, sc, ids)
        return best_s, best_i

    def _ann_topk(self, view: _ServeView, qv: np.ndarray, k: int,
                  nprobe: Optional[int], predicate=None):
        """(scores, page_ids, gather_bytes) through the IVF index, or None
        for the exact sweep (the index is unavailable, or stale against
        the store's model step, checked per request). A `predicate` goes
        into the index's gather, widened by ``serve.filter_escalate``."""
        idx = view.index
        if (idx is None or idx.model_step != view.store.model_step
                or len(view.steps) > 1):
            return None
        with self._stage("topk") as sp:
            scores, pids, st = idx.search(qv, k=k,
                                          nprobe=nprobe or self._nprobe,
                                          rerank=self._pq_rerank or None,
                                          predicate=predicate,
                                          escalate=self._filter_escalate)
            sp.set_attrs(lists_scanned=st.get("lists_scanned", 0),
                         gather_bytes=st.get("gather_bytes", 0),
                         rows_reranked=st.get("candidates_reranked", 0),
                         filter_escalations=st.get("filter_escalations", 0))
        self._m_ann_lists.inc(st.get("lists_scanned", 0))
        self._m_ann_reranked.inc(st.get("candidates_reranked", 0))
        self._m_ann_gather.inc(st.get("gather_bytes", 0))
        return (np.asarray(scores, np.float32), np.asarray(pids, np.int64),
                int(st.get("gather_bytes", 0)))

    def _filtered_exact(self, view: _ServeView, blocks: Dict, n: int,
                        k: int, predicate) -> tuple:
        """Exact filtered retrieval over one view: per shard the predicate
        is evaluated on the host against the attribute words, only the
        matching live rows are read at stored width and copied to the
        card, and they are scored there in one product with the block of
        the shard's stamp (int8 rows widened with their scales); one top-k
        over the shards' top-k's ends it. scan_bytes: the words read (4 B
        a row of the view) plus the matching rows at stored width, so a
        predicate of selectivity s scans about s times the unfiltered
        exact bytes."""
        store, dev = view.store, self.embedder.device
        row_bytes = store.row_bytes
        q = {x: (b[:n].to(dev, torch.float32) if isinstance(b, torch.Tensor)
                 else to_device(_host_rows(b, n), dev))
             for x, b in blocks.items()}
        fallback = next(iter(q.values()))
        cand_s, cand_i = [], []
        scan = 0
        with self._stage("topk", path="filtered_exact"):
            for entry in view.entries:
                if entry["count"] == 0:
                    continue
                words = store.load_attrs(entry)
                scan += int(words.nbytes)
                keep = predicate.matches(words)
                if not keep.any():
                    continue
                ids, vecs, scl = store._load_entry(entry, raw=True)
                keep &= ids >= 0         # a tombstoned row matches nothing
                if not keep.any():
                    continue
                rows = to_device(np.asarray(vecs)[keep], dev).float()
                if scl is not None:
                    rows = rows * to_device(np.asarray(scl)[keep],
                                            dev).float()[:, None]
                scan += int(rows.shape[0]) * row_bytes
                qb = q.get(store.entry_step(entry), fallback)
                sc, at = torch.topk(qb @ rows.T, min(k, rows.shape[0]),
                                    dim=1)
                cand_s.append(sc)
                cand_i.append(to_device(ids[keep], dev)[at])
        out_s = np.full((n, k), -np.inf, np.float32)
        out_i = np.full((n, k), -1, np.int64)
        if cand_s:
            with self._stage("merge"):
                all_s = torch.cat(cand_s, dim=1)
                best_s, at = torch.topk(all_s, min(k, all_s.shape[1]), dim=1)
                best_i = torch.gather(torch.cat(cand_i, dim=1), 1, at)
                kk = best_s.shape[1]
                out_s[:, :kk] = best_s.cpu().numpy()
                out_i[:, :kk] = best_i.cpu().numpy()
        return out_s, out_i, scan

    def _format(self, scores, ids) -> List[Dict]:
        return [
            {"page_id": int(i), "score": round(float(s), 4),
             "snippet": self.corpus.page_text(int(i))[: self.snippet_chars]}
            for s, i in zip(scores, ids) if i >= 0]
