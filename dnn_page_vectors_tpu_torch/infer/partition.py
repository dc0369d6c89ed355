"""Partitioned and replicated serving inside one process: the port's copy
of the JAX package's infer/partition.py.

  * ``PartitionSpec``: one partition's ownership contract, a contiguous
    shard range balanced by row count (``parallel/multihost.py:
    partition_shard_ranges``), which implies its slice of the IVF posting
    files (``IVFIndex.partition_view``) and its cut of
    ``serve.hot_postings_gb``, in proportion to its rows.
  * ``_PartitionReplica``: one worker, a thread draining a task queue and
    owning a ``_ServeView`` of its own over the spec's entries. On the
    card each replica runs its tasks on a CUDA stream of its own: a task
    waits on an event recorded after the query encode, and its results
    reach the host through a synchronizing copy.
  * ``PartitionSet``: P specs x R replicas and the router. ``topk()`` is
    the scatter-gather: the query matrix, encoded once, goes to one
    routed replica per partition, each answers its local top-k through
    ``SearchService._topk_view`` over only its shard range, and the
    partitions' winners fold through ``ops/topk.py:
    merge_partition_topk``.

Health-based routing: the router prefers the first replica that is not
restaging, not degraded and under ``serve.replica_shed_queue`` requests
in flight. Leaving the primary counts in ``serve.replica_shed`` and
records a ``replica_shed`` event on a change of state, not per request.
Degraded here means a view that serves by the streaming sweep because
its rows did not fit ``preload_hbm_gb``, with no index: a configured,
visible state (a shard that fails to stage raises, it never degrades a
view quietly). When every replica of a partition is degraded, one still
serves (``serve.partition_degraded``, a ``partition_degraded`` event),
never an empty slice of results.

The refresh builds every partition's next views beside the serving
table, partition by partition (a replica that restages sheds to a
sibling; with R=1 the old view serves until the publish) and publishes
the finished table with one reference assignment. A scatter snapshots the
table once and takes its width from the snapshot, so no result set mixes
store generations or partition splits. ``resize()`` re-splits at a new
width the same way.

``simulate()`` runs each partition's task in turn on the caller and
returns the critical path (the slowest partition plus the merge), the
one-box stand-in for P hosts; on one card the partitions share the SMs,
so it claims no scaling with P.

``set_liveness`` is the seam the worker gateway of the fleet over the
wire (infer/partition_host.py) installs through
``SearchService.attach_gateway``: a replica whose worker process stopped
heartbeating or lost its connection sheds with reason "liveness". Its
default, None, counts every replica as live.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dnn_page_vectors_tpu_torch.ops.topk import merge_partition_topk
from dnn_page_vectors_tpu_torch.parallel.multihost import (
    partition_shard_ranges)
from dnn_page_vectors_tpu_torch.utils.profiling import LatencyStats


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """One partition's ownership contract: its contiguous slice of the
    store's shard table (entry dicts frozen at spec time), the shard
    indices of the IVF posting files it owns, its row count, and its cut
    of the hot posting set's budget (in proportion to its rows)."""

    pid: int
    entries: Tuple[Dict, ...]
    shard_indices: Tuple[int, ...]
    rows: int
    hot_gb: float


def make_partition_specs(entries: Sequence[Dict], partitions: int,
                         hot_gb: float = 0.0) -> List[PartitionSpec]:
    """Split a shard table into at most `partitions` contiguous,
    row-balanced PartitionSpecs (pure arithmetic over the table, so every
    worker derives the same split)."""
    entries = list(entries)
    total = sum(e["count"] for e in entries) or 1
    ranges = partition_shard_ranges([e["count"] for e in entries],
                                    partitions)
    specs = []
    for pid, (lo, hi) in enumerate(ranges):
        part = entries[lo:hi]
        rows = sum(e["count"] for e in part)
        specs.append(PartitionSpec(
            pid=pid, entries=tuple(part),
            shard_indices=tuple(e["index"] for e in part),
            rows=rows, hot_gb=hot_gb * rows / total))
    return specs


def _sync(device: torch.device) -> None:
    """Wait for the card: views built on one stream are read on the
    replicas' streams once published."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _PartitionReplica:
    """One partition worker: a task-queue thread owning a view of its own
    over its spec's shard range, and on the card a CUDA stream of its own.
    The health state (restaging, queue depth, per-replica stats) is
    lock-guarded; the view is replaced by one reference assignment and
    read as a snapshot by the tasks in flight."""

    _STOP = object()

    def __init__(self, spec: PartitionSpec, rid: int, device: torch.device):
        self.spec = spec
        self.rid = rid
        self.view = None                  # _ServeView; swapped by refresh
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._lock = threading.Lock()
        self._q: "queue_mod.Queue[object]" = queue_mod.Queue()
        self._outstanding = 0             # guarded-by: _lock
        self._restaging = False           # guarded-by: _lock
        self.requests = 0                 # guarded-by: _lock
        self.scan_bytes = 0               # guarded-by: _lock
        self.lat = LatencyStats()         # guarded-by: _lock
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name=f"serve-part{spec.pid}r{rid}")
        self._t.start()

    # -- health ------------------------------------------------------------
    @property
    def restaging(self) -> bool:
        with self._lock:
            return self._restaging

    def set_restaging(self, flag: bool) -> None:
        with self._lock:
            self._restaging = bool(flag)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._outstanding

    @property
    def degraded(self) -> bool:
        """The view serves by the streaming sweep (its rows did not fit
        the staging budget, and it has no index), or there is no view
        yet: this replica answers, slowly, and routing prefers a sibling.
        A view over no rows is not degraded."""
        view = self.view
        return view is None or (
            view.pages is None and view.index is None
            and any(e["count"] > 0 for e in view.entries))

    # -- work --------------------------------------------------------------
    def _on_stream(self, fn, ready):
        """fn() on this replica's stream, after the event `ready` (the
        query encode) on the caller's."""
        if self.stream is None:
            return fn()
        with torch.cuda.stream(self.stream):
            if ready is not None:
                self.stream.wait_event(ready)
            return fn()

    def submit(self, fn, ready=None) -> Future:
        fut: Future = Future()
        with self._lock:
            self._outstanding += 1
        self._q.put((fn, ready, fut))
        return fut

    def run_inline(self, fn, ready=None):
        """Run one task on the caller (``simulate``): returns (result,
        seconds), the seconds of one simulated host."""
        t0 = time.perf_counter()
        res = self._on_stream(fn, ready)
        dt = time.perf_counter() - t0
        self._record(res, dt)
        return res, dt

    def _record(self, res, dt: float) -> None:
        with self._lock:
            self.requests += 1
            self.lat.add(dt)
            if isinstance(res, tuple) and len(res) == 3:
                self.scan_bytes += int(res[2])

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            fn, ready, fut = item
            t0 = time.perf_counter()
            try:
                res = self._on_stream(fn, ready)
            except BaseException as e:  # noqa: BLE001 -- the error rides
                fut.set_exception(e)    # the future back to the gather
                res = None
            else:
                fut.set_result(res)
            dt = time.perf_counter() - t0
            with self._lock:
                self._outstanding -= 1
            self._record(res, dt)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "replica": self.rid,
                "requests": self.requests,
                "p50_ms": round(self.lat.percentile_ms(50), 3),
                "p99_ms": round(self.lat.percentile_ms(99), 3),
                "scan_bytes": self.scan_bytes,
                "queue": self._outstanding,
                "restaging": self._restaging,
                "degraded": self.degraded,
            }

    def close(self) -> None:
        self._q.put(self._STOP)
        self._t.join()


class PartitionSet:
    """P partitions x R replicas behind one scatter-gather router."""

    def __init__(self, svc, store, partitions: int, replicas: int,
                 shed_queue: int = 8):
        self._svc = svc
        self._device = svc.embedder.device
        self._shed_queue = max(0, int(shed_queue))
        specs = make_partition_specs(store.shards(), partitions,
                                     hot_gb=svc._hot_gb)
        self.partitions = len(specs)
        self.replicas = max(1, int(replicas))
        # the replica grid only grows (resize never removes rows): a
        # scatter in flight that captured a wider table keeps routing into
        # the tail rows until it finishes; rows past self.partitions are
        # never routed by new scatters
        self._parts: List[List[_PartitionReplica]] = []
        table: List[tuple] = []
        try:
            for spec in specs:
                reps: List[_PartitionReplica] = []
                self._parts.append(reps)
                for rid in range(self.replicas):
                    rep = _PartitionReplica(spec, rid, self._device)
                    reps.append(rep)
                    # each replica stages a view of its own (its own
                    # device rows, its own restricted index): the one-card
                    # simulation of R copies on R hosts
                    rep.view = svc._build_view(store,
                                               entries=list(spec.entries),
                                               hot_gb=spec.hot_gb)
                table.append(tuple(rep.view for rep in reps))
        except BaseException:
            self.close()         # a view that fails to stage raises
            raise
        _sync(self._device)
        # THE generation anchor: every scatter snapshots this table once,
        # and refresh() publishes a finished replacement with one
        # reference assignment
        self._view_table = tuple(table)
        self.last_swap_ms = 0.0
        self._route_lock = threading.Lock()
        self._sheds = [0] * self.partitions        # guarded-by: _route_lock
        self._degraded_serves = [0] * self.partitions  # guarded-by: _route_lock
        self._last_health: Dict[int, tuple] = {}   # guarded-by: _route_lock
        # the liveness oracle of the worker gateway: (pid, rid) -> alive;
        # None counts every replica as live. Set by one assignment
        self._liveness = None
        self._t0 = time.perf_counter()

    def primary_view(self):
        """Partition 0's primary view: the service's control view (its
        store-level fields are the same on every view of a table)."""
        return self._parts[0][0].view

    def table(self) -> tuple:
        """The published table of views: [partition][replica]."""
        return self._view_table

    def specs(self) -> List[PartitionSpec]:
        return [reps[0].spec for reps in self._parts[:self.partitions]]

    # -- routing -----------------------------------------------------------
    def set_liveness(self, fn) -> None:
        """Install (or clear, with None) the worker-liveness oracle
        `fn(pid, rid) -> bool`, which the worker gateway drives from
        registrations and heartbeats."""
        self._liveness = fn

    def _alive(self, pid: int, rid: int) -> bool:
        fn = self._liveness
        return True if fn is None else bool(fn(pid, rid))

    def _route(self, pid: int) -> _PartitionReplica:
        """The replica that answers partition `pid`'s next request, in
        order of preference: live and healthy (not restaging, not
        degraded, under the queue budget) > live over the budget > healthy
        with a dead worker > degraded. Leaving the primary is a shed;
        serving on a degraded replica because every sibling is degraded
        too is a degraded serve. Events fire on a change of state."""
        reps = self._parts[pid]
        primary = reps[0]
        chosen = None
        degraded_serve = False
        for r in reps:
            if (not r.restaging and not r.degraded
                    and self._alive(pid, r.rid)
                    and r.queue_depth <= self._shed_queue):
                chosen = r
                break
        if chosen is None:
            for r in reps:
                if (not r.restaging and not r.degraded
                        and self._alive(pid, r.rid)):
                    chosen = r
                    break
        if chosen is None:
            # no replica has a live worker: a healthy one still serves its
            # local view, which is not a degraded serve
            for r in reps:
                if not r.restaging and not r.degraded:
                    chosen = r
                    break
        if chosen is None:
            for r in reps:
                if not r.restaging:
                    chosen = r
                    degraded_serve = True
                    break
        if chosen is None:
            # every replica restaging: the primary's old view is still
            # whole (the swap is one assignment), so it serves
            chosen = primary
            degraded_serve = primary.degraded
        svc = self._svc
        shed = chosen is not primary
        reason = None
        if shed:
            reason = ("restaging" if primary.restaging
                      else "degraded" if primary.degraded
                      else "liveness" if not self._alive(pid, primary.rid)
                      else "queue")
            svc._m_replica_shed.inc()
        if degraded_serve:
            svc._m_partition_degraded.inc()
        state = (chosen.rid, reason, degraded_serve)
        with self._route_lock:
            if shed:
                self._sheds[pid] += 1
            if degraded_serve:
                self._degraded_serves[pid] += 1
            changed = self._last_health.get(pid) != state
            self._last_health[pid] = state
        if changed:
            if shed:
                svc.registry.event("replica_shed", {
                    "partition": pid, "from_replica": primary.rid,
                    "to_replica": chosen.rid, "reason": reason})
            if degraded_serve:
                svc.registry.event("partition_degraded", {
                    "partition": pid, "replica": chosen.rid})
        return chosen

    def _ready(self):
        """An event on the caller's stream after the query encode: each
        replica's stream waits on it before reading the query matrix."""
        if self._device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    # -- the scatter-gather ------------------------------------------------
    def topk(self, qv, n: int, k: int, nprobe: Optional[int] = None,
             predicate=None, table: Optional[tuple] = None) -> tuple:
        """Scatter the encoded query matrix (host or device, [n, S*D]
        during a migration) to one routed replica per partition, gather
        each partition's local top-k and fold them through the merge tree.
        Returns (scores [n, k] float32, page_ids [n, k] int64). A
        `predicate` rides the scatter unchanged: each partition runs its
        own filtered search and the merge is blind to it. `table` is a
        snapshot the caller took (the service takes one per call, for its
        result cache's key); by default the published one."""
        svc = self._svc
        # ONE snapshot for the whole scatter, its width included: a
        # refresh or a resize published mid-scatter cannot mix store
        # generations or partition splits inside one result set
        if table is None:
            table = self._view_table
        ready = self._ready()
        with svc._stage("scatter", partitions=len(table)):
            futs = []
            for pid in range(len(table)):
                rep = self._route(pid)
                view = table[pid][rep.rid]
                futs.append(rep.submit(
                    lambda v=view: svc._topk_view(v, qv, n, k, nprobe,
                                                  predicate=predicate),
                    ready))
            parts = [f.result() for f in futs]
        with svc._stage("merge"):
            return merge_partition_topk([(s, i) for s, i, _ in parts])

    def simulate(self, qv, n: int, k: int, nprobe: Optional[int] = None,
                 predicate=None) -> Dict:
        """Run every partition's task in turn on the caller, timing each,
        then the merge. The simulated latency is the critical path, the
        slowest partition plus the merge: what P hosts would give, with
        each partition's scan bytes beside it. Returns {scores, ids,
        partition_seconds, merge_seconds, critical_path_seconds,
        scan_bytes}."""
        svc = self._svc
        table = self._view_table
        ready = self._ready()
        parts, times, scans = [], [], []
        for pid in range(len(table)):
            rep = self._route(pid)
            view = table[pid][rep.rid]
            res, dt = rep.run_inline(
                lambda v=view: svc._topk_view(v, qv, n, k, nprobe,
                                              predicate=predicate), ready)
            parts.append(res)
            times.append(dt)
            scans.append(int(res[2]))
        t0 = time.perf_counter()
        s, i = merge_partition_topk([(s_, i_) for s_, i_, _ in parts])
        merge_s = time.perf_counter() - t0
        return {
            "scores": s, "ids": i,
            "partition_seconds": times,
            "merge_seconds": merge_s,
            "critical_path_seconds": max(times) + merge_s,
            "scan_bytes": scans,
        }

    # -- the rolling refresh and the re-split ------------------------------
    def _restage(self, new_store, specs: List[PartitionSpec],
                 update_index: bool = False) -> List[Dict]:
        """Build every partition's next views beside the serving table,
        partition by partition and replica by replica (the replica being
        rebuilt is marked restaging, so routing sheds it), the IVF update
        once on the first view, then publish the table with one
        assignment. Returns the per-partition restage record."""
        svc = self._svc
        out: List[Dict] = []
        new_table: List[tuple] = []
        first = True
        for spec in specs:
            row, swaps, stages = [], [], []
            for rep in self._parts[spec.pid]:
                t0 = time.perf_counter()
                rep.set_restaging(True)
                try:
                    view = svc._build_view(
                        new_store, reuse=rep.view,
                        update_index=update_index and first,
                        entries=list(spec.entries), hot_gb=spec.hot_gb)
                finally:
                    rep.set_restaging(False)
                first = False
                row.append(view)
                swaps.append(round((time.perf_counter() - t0) * 1000.0, 3))
                stages.append(dict(view.stage_info))
            new_table.append(tuple(row))
            out.append({"partition": spec.pid,
                        "shards": list(spec.shard_indices),
                        "rows": spec.rows, "restage_ms": swaps,
                        "stage": stages})
        _sync(self._device)       # the copies land before the publish
        t_swap = time.perf_counter()
        self._view_table = tuple(new_table)  # THE swap: one assignment
        self.last_swap_ms = (time.perf_counter() - t_swap) * 1000.0
        self.partitions = len(specs)
        for spec, row in zip(specs, new_table):
            for rep, view in zip(self._parts[spec.pid], row):
                # health follows the published table; tasks in flight keep
                # the view they took from their snapshot
                rep.view = view
                rep.spec = spec
        return out

    def refresh(self, new_store, update_index: bool = False) -> List[Dict]:
        """Bring every replica onto `new_store`'s current generation: the
        next views build beside the serving table, one partition at a
        time, and publish together. A shrunken table (fewer balanced
        ranges than live partitions) gives the tail partitions empty
        specs: they serve nothing rather than a stale view."""
        specs = make_partition_specs(new_store.shards(), self.partitions,
                                     hot_gb=self._svc._hot_gb)
        while len(specs) < self.partitions:
            specs.append(PartitionSpec(pid=len(specs), entries=(),
                                       shard_indices=(), rows=0,
                                       hot_gb=0.0))
        return self._restage(new_store, specs, update_index=update_index)

    def resize(self, new_store, partitions: int) -> List[Dict]:
        """Re-split the store over a new partition width (a worker joined
        or left), with refresh()'s discipline: every partition's view over
        its new slice builds beside the serving table, and the table at
        the new width publishes with one assignment. Rows a shrink strands
        stay in the replica grid for scatters in flight but are never
        routed again."""
        specs = make_partition_specs(new_store.shards(),
                                     max(1, int(partitions)),
                                     hot_gb=self._svc._hot_gb)
        while len(self._parts) < len(specs):     # clamped to the shards
            pid = len(self._parts)
            self._parts.append([_PartitionReplica(specs[pid], rid,
                                                  self._device)
                                for rid in range(self.replicas)])
            with self._route_lock:
                self._sheds.append(0)
                self._degraded_serves.append(0)
        return self._restage(new_store, specs)

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> List[Dict]:
        """Per-partition topology and routing health: the metrics() and
        loadtest "partitions" block."""
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        with self._route_lock:
            sheds = list(self._sheds)
            degr = list(self._degraded_serves)
        out = []
        # bounded by the live width: rows a shrink stranded are no longer
        # part of the serving topology
        for pid, reps in enumerate(self._parts[:self.partitions]):
            rstats = [r.stats() for r in reps]
            out.append({
                "partition": pid,
                "shards": list(reps[0].spec.shard_indices),
                "rows": reps[0].spec.rows,
                "qps": round(sum(r["requests"] for r in rstats) / elapsed,
                             3),
                "p99_ms": max((r["p99_ms"] for r in rstats), default=0.0),
                "sheds": sheds[pid],
                "degraded_serves": degr[pid],
                "replicas": rstats,
            })
        return out

    def close(self) -> None:
        for reps in self._parts:
            for rep in reps:
                rep.close()
