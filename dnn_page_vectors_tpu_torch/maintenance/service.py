"""The background maintenance service, the port's copy of the JAX
package's maintenance/service.py (same pillars, triggers, counters, gauges
and events; a ``device`` where the JAX service takes a mesh).

`MaintenanceService` runs one worker thread a pillar, each checking its
trigger every ``maintenance.interval_s`` seconds and running its job under
one shared mutation lock (two pillars never interleave manifest flips;
the lock is held across a job's flips and never across a search):

  * **compactor**: when the chain's tombstone density reaches
    ``maintenance.compact_tombstone_density``, fold the chain into a fresh
    compacted base (maintenance/compact.py), rebuild the IVF index over it
    when one exists, hot-swap the serving view, then purge the old
    chain's bytes;
  * **rebuild pillar**: when a drift rebuild was deferred off refresh()
    (``serve.index_rebuild_pending``) or the live index degraded to exact,
    build the next index generation BESIDE the live one
    (``IVFIndex.build(dirname=...)`` with the recorded PQ and balance
    settings), flip the store's index-dir pointer atomically and hot-swap
    through refresh();
  * **janitor**: remove expired append leases, index directories the
    pointer moved off, migration unit directories no manifest references
    and compaction debris. A directory goes one full pass after it went
    stale (run_once runs the janitor first), so a reader on the previous
    view never loses a file it was given;
  * **migrator**: once armed by ``request_migration``, re-embed the store
    to a new model step one unit a pass (``migrate.units_per_pass``)
    through ``MigrationPlan``, hot-swapping the serving view between
    units; superseded files are purged only after the view moved
    (``migrate.purge``); at completion the index is rebuilt over the new
    stamp and the serving refresh adopts the new tower;
  * **autoscaler**: ladder a worker fleet's size off the serving
    telemetry (windowed queue-wait p99, deadline-shed rate), acting only
    through hooks given to ``attach_scaler`` (observable only without
    them) and rate-limited by ``maintenance.autoscale_cooldown_s``.

A pillar's exception is counted (``maintenance_<pillar>_errors``) and
logged, and never kills its worker. API: ``start()``, ``pause()`` /
``resume()``, ``drain()``, ``run_once()`` (one synchronous pass of every
pillar, with or without the threads), ``stats()``, ``close()``. Driven by
`cli maintain [--once]`, or attached to a SearchService by its
``start_maintenance()``.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import shutil
import threading
import time
from typing import Callable, Dict, Optional

from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.maintenance.compact import (
    compact_store, purge_stale)
from dnn_page_vectors_tpu_torch.maintenance.lease import expire_stale_lease
from dnn_page_vectors_tpu_torch.maintenance.migrate import MigrationPlan
from dnn_page_vectors_tpu_torch.utils import faults, telemetry
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike

_INDEX_DIR_RE = re.compile(r"^ivf(-\d+)?$")
_DATA_FILES = ("vec", "ids", "scl")


def _next_index_dirname(current: str) -> str:
    """ivf -> ivf-0001 -> ivf-0002 ...: the next index generation's
    directory, built beside the live one and flipped to."""
    m = re.match(r"^ivf-(\d+)$", current)
    return f"ivf-{(int(m.group(1)) if m else 0) + 1:04d}"


class MaintenanceService:
    """The pillar workers over one store. `svc` (optional) attaches a live
    SearchService: its registry carries the maintenance instruments,
    finished work hot-swaps in through ``svc.refresh()``, and background
    rebuilds count in its ``full_rebuilds``. `device` runs the rebuild's
    k-means and assignment (None: cuda; the attached service's device when
    one is given)."""

    PILLARS = ("compaction", "rebuild", "janitor", "autoscale", "migrate")

    def __init__(self, cfg, store_dir: str, device: DeviceLike = None,
                 svc=None, registry=None):
        self._cfg = cfg
        self._store_dir = store_dir
        self._device = (svc.embedder.device
                        if device is None and svc is not None else device)
        self._svc = svc
        self.registry = registry or (
            svc.registry if svc is not None
            else telemetry.default_registry())
        m = cfg.maintenance
        self._density = m.compact_tombstone_density
        self._interval_s = m.interval_s
        self._as_on = bool(m.autoscale)
        self._as_min = int(m.autoscale_min_workers)
        self._as_max = int(m.autoscale_max_workers)
        self._as_up_queue = float(m.autoscale_up_queue_p99_ms)
        self._as_up_shed = float(m.autoscale_up_shed_rate)
        self._as_down_queue = float(m.autoscale_down_queue_p99_ms)
        self._as_cooldown_s = float(m.autoscale_cooldown_s)
        # the autoscaler acts only through these hooks (attach_scaler);
        # touched under the mutation lock or before start()
        self._spawn_hook: Optional[Callable[[int], None]] = None
        self._drain_hook: Optional[Callable[[int], None]] = None
        self._size_hook: Optional[Callable[[], int]] = None
        self._last_scale_t: Optional[float] = None
        mg = cfg.migrate
        self._mig_batch_rows = int(mg.batch_rows)
        self._mig_units = int(mg.units_per_pass)
        self._mig_purge = bool(mg.purge)
        self._migrate_req: Optional[Dict] = None   # guarded-by: _mlock
        # injectable for fake-clock tests of the autoscaler
        self._clock: Callable[[], float] = time.monotonic
        self._lock = threading.Lock()
        # one mutation at a time across the pillars and run_once
        # (re-entrant: run_once holds it across every pillar); the outer
        # lock of the hierarchy: _mlock < _lock, _mlock < the fault counters
        self._mlock = threading.RLock()
        self._stop = threading.Event()
        self._threads: list = []
        self._paused = False                  # guarded-by: _lock
        self._busy = 0                        # guarded-by: _lock
        self._stats: Dict[str, int] = {}      # guarded-by: _lock
        self._last: Dict[str, Dict] = {}      # guarded-by: _lock

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MaintenanceService":
        """Start one worker a pillar (idempotent)."""
        if self._threads:
            return self
        for name, job in (("compaction", self._compact_once),
                          ("rebuild", self._rebuild_once),
                          ("janitor", self._janitor_once),
                          ("autoscale", self._autoscale_once),
                          ("migrate", self._migrate_once)):
            t = threading.Thread(target=self._run_worker, args=(name, job),
                                 daemon=True, name=f"maint-{name}")
            self._threads.append(t)
            t.start()
        return self

    def attach_scaler(self, spawn: Callable[[int], None],
                      drain: Callable[[int], None],
                      size: Optional[Callable[[], int]] = None) -> None:
        """The autoscaler's actuators: `spawn(index)` starts the worker of
        the next tail partition, `drain(index)` drains the highest one,
        `size()` reports the fleet's size. Call before start(); without
        them the pillar only observes."""
        self._spawn_hook = spawn
        self._drain_hook = drain
        self._size_hook = size

    def _run_worker(self, name: str, job: Callable[[], Optional[Dict]]
                    ) -> None:
        while not self._stop.wait(self._interval_s):
            with self._lock:
                paused = self._paused
            if paused:
                continue
            self._guarded_job(name, job)

    def _guarded_job(self, name: str, job: Callable[[], Optional[Dict]]
                     ) -> Optional[Dict]:
        """One supervised pillar pass: the mutation lock held, an
        exception counted and reported, never raised into the worker."""
        with self._lock:
            self._busy += 1
        try:
            with self._mlock:
                res = job()
        except Exception as e:  # noqa: BLE001 -- the worker must survive
            res = {"error": f"{type(e).__name__}: {e}"[:300]}
            faults.count(f"maintenance_{name}_errors")
            faults.warn(f"maintenance {name} pass failed "
                        f"({res['error']}); the worker keeps polling")
        finally:
            with self._lock:
                self._busy -= 1
        if res is not None:
            with self._lock:
                self._stats[name] = self._stats.get(name, 0) + 1
                self._last[name] = res
        return res

    @contextlib.contextmanager
    def exclusive(self):
        """Hold the mutation lock across a store mutation made beside the
        pillars (an append): no pillar flips a manifest under it, so a
        migration's completion never misses a generation committed
        meanwhile. Waits for a pass in flight."""
        with self._mlock:
            yield

    def pause(self) -> None:
        """Trigger no new job (one in flight finishes; see drain)."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Wait until no pillar job is in flight. True when drained."""
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while True:
            with self._lock:
                if self._busy == 0:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def close(self) -> None:
        """Stop the workers and join them (a job in flight finishes)."""
        self._stop.set()
        for t in self._threads:
            t.join()
        self._threads = []

    def run_once(self) -> Dict:
        """One synchronous pass of every pillar, the janitor first (a
        crashed run's debris never confuses a trigger): `cli maintain
        --once` and the load generator's mutator. Works with or without
        the workers."""
        out: Dict[str, Dict] = {}
        with self._mlock:
            for name, job in (("janitor", self._janitor_once),
                              ("compaction", self._compact_once),
                              ("rebuild", self._rebuild_once),
                              ("migrate", self._migrate_once),
                              ("autoscale", self._autoscale_once)):
                res = self._guarded_job(name, job)
                if res is not None:
                    out[name] = res
        return out

    def stats(self) -> Dict:
        """Pass counts and each pillar's last result."""
        with self._lock:
            return {"passes": dict(self._stats),
                    "last": {k: dict(v) for k, v in self._last.items()}}

    # -- pillar: generation compaction -------------------------------------
    def _compact_once(self) -> Optional[Dict]:
        # the trigger reads an unverified handle (a CRC sweep every
        # interval would re-read every shard); the compaction re-opens
        # with the check
        store = VectorStore(self._store_dir, verify=False)
        ms = store.maintenance_stats()
        reg = self.registry
        reg.gauge("maintenance.tombstone_density").set(
            ms["tombstone_density"])
        reg.gauge("maintenance.dead_rows").set(ms["dead_rows"])
        reg.gauge("maintenance.reclaimable_bytes").set(
            ms["reclaimable_bytes"])
        if (store.migration is not None
                or store.chain_generation <= store.compacted_through
                or ms["tombstone_density"] < self._density):
            # mid-migration a fold would mix stamps within one shard: the
            # migrator owns the store until the completion flip
            return None
        store = VectorStore(self._store_dir)
        had_index = os.path.exists(os.path.join(
            store.directory, store.index_dirname, "manifest.json"))
        stats = compact_store(store, registry=reg)
        if stats.get("action") != "compacted":
            return stats
        if had_index:
            # rebuilt over the compacted base BEFORE the serving refresh,
            # so the view swaps store and index together
            stats["index_rebuild"] = self._swap_index(
                store, reason=f"generation compaction epoch "
                              f"{stats['epoch']}", refresh=False)
        if self._svc is not None:
            info = self._svc.refresh()
            stats["refresh_swap_ms"] = info.get("swap_ms")
        # reclaimed only after the serving view moved over
        stats["purged"] = purge_stale(store, stats)
        stats.pop("stale_dirs", None)
        stats.pop("stale_files", None)
        return stats

    # -- pillar: off-path index rebuilds -----------------------------------
    def _rebuild_once(self) -> Optional[Dict]:
        svc = self._svc
        if VectorStore(self._store_dir, verify=False).migration is not None:
            # an index built mid-migration would mix two towers' geometry;
            # serving runs exact on two stamps and the migrator rebuilds at
            # the completion flip
            return None
        reason = None
        store0 = VectorStore(self._store_dir, verify=False)
        mpath = os.path.join(store0.directory, store0.index_dirname,
                             "manifest.json")
        if svc is not None:
            if svc._serve_index != "ivf":
                return None
            pending = svc.registry.gauge(
                "serve.index_rebuild_pending").value > 0
            err = svc._view.index_error
            if pending:
                reason = "drift rebuild deferred off the refresh path"
            elif err is not None and os.path.exists(mpath):
                reason = f"live index degraded ({err[:120]})"
        elif os.path.exists(mpath):
            reason = self._standalone_rebuild_reason(store0, mpath)
        if reason is None:
            return None
        store = VectorStore(self._store_dir)
        if store.num_vectors == 0:
            return None
        return self._swap_index(store, reason=reason)

    def _standalone_rebuild_reason(self, store,
                                   mpath: str) -> Optional[str]:
        """With no service attached, decide from the index on disk: a
        drift past updates.rebuild_drift, or a staleness open() rejects
        (compaction, quarantine, a re-stamp)."""
        from dnn_page_vectors_tpu_torch.index.ivf import (
            IndexUnavailable, IVFIndex)
        try:
            with open(mpath) as f:
                man = json.load(f)
        except (OSError, ValueError):
            return "torn index manifest"
        drift = (int(man.get("appended_since_build", 0))
                 / max(store.num_vectors, 1))
        limit = self._cfg.updates.rebuild_drift
        if drift > limit:
            return f"drift {drift:.3f} > rebuild_drift {limit}"
        try:
            IVFIndex.open(store, verify=True, device=self._device)
        except IndexUnavailable as e:
            return f"index unavailable ({str(e)[:120]})"
        except Exception as e:  # noqa: BLE001 -- unreadable: rebuild
            return f"index unreadable ({type(e).__name__})"
        return None

    def _swap_index(self, store, reason: str,
                    refresh: bool = True) -> Dict:
        """Build the next index generation beside the live one, flip the
        store's index-dir pointer atomically and (with a service attached)
        hot-swap the serving view. The old directory stays for the
        janitor: a reader on the previous view may still map its files."""
        from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
        faults.active().check("bg_rebuild")
        old_name = store.index_dirname
        old_man: Dict = {}
        mpath = os.path.join(store.directory, old_name, "manifest.json")
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    old_man = json.load(f)
            except (OSError, ValueError):
                old_man = {}
        next_name = _next_index_dirname(old_name)
        serve = self._cfg.serve
        pq_cfg = old_man.get("pq") or {}
        t0 = time.perf_counter()
        idx = IVFIndex.build(
            store, nlist=serve.nlist, iters=serve.kmeans_iters,
            seed=self._cfg.data.seed, init=serve.kmeans_init,
            balance=old_man.get("balance", serve.kmeans_balance),
            pq_m=pq_cfg.get("m", 0), pq_iters=pq_cfg.get("iters", 8),
            opq_iters=pq_cfg.get("opq_iters", 3), device=self._device,
            dirname=next_name)
        build_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        store.set_index_dir(next_name)       # THE pointer flip
        rb = {"reason": reason[:200], "dirname": next_name,
              "nlist": idx.nlist, "build_seconds": round(build_s, 3)}
        if refresh and self._svc is not None:
            self._svc.refresh()
        if self._svc is not None:
            self._svc._m_rebuilds.inc()
            self._svc.registry.gauge("serve.index_rebuild_pending").set(0.0)
        rb["swap_ms"] = round((time.perf_counter() - t1) * 1000.0, 3)
        self.registry.counter("maintenance.bg_rebuilds").inc()
        self.registry.gauge("maintenance.bg_rebuild_swap_ms").set(
            rb["swap_ms"])
        self.registry.event("index_rebuild_bg", rb)
        faults.count("index_bg_rebuilds")
        return rb

    # -- pillar: rolling model migration -----------------------------------
    def request_migration(self, to_step: int, corpus, embedder) -> None:
        """Arm the migrator: re-embed the store to `to_step` with
        `embedder` (a BulkEmbedder over the NEW model) reading page text
        from `corpus`, one unit a pass. With a service attached its query
        path goes dual-stamp at once (``begin_migration``)."""
        with self._mlock:
            self._migrate_req = {"to_step": int(to_step), "corpus": corpus,
                                 "embedder": embedder}
        if self._svc is not None:
            self._svc.begin_migration(embedder.model, int(to_step))

    def _migrate_once(self) -> Optional[Dict]:   # holds-lock: _mlock
        req = self._migrate_req
        if req is None:
            return None
        store = VectorStore(self._store_dir)
        plan = MigrationPlan(store, req["corpus"], req["embedder"],
                             req["to_step"], registry=self.registry,
                             batch_rows=self._mig_batch_rows)
        begun = plan.begin()
        if begun.get("action") == "noop":
            self._migrate_req = None
            return begun
        units = plan.pending_units()
        if units:
            out: Dict = {**begun, "action": "migrating"}
            out["units"], out["rows"], stale = [], 0, []
            for unit in units[: self._mig_units]:
                st = plan.migrate_unit(unit)
                out["units"].append(int(unit))
                out["rows"] += int(st.get("rows", 0))
                out["unit_seconds"] = st.get("seconds")
                stale += st.get("stale_files", [])
            if self._svc is not None:
                # the serving view walks onto the re-embedded unit now
                info = self._svc.refresh()
                out["refresh_swap_ms"] = info.get("swap_ms")
                out["refresh_seconds"] = info.get("refresh_seconds")
                out["stage"] = info.get("stage")
            if self._mig_purge:
                # the superseded old-stamp bytes, only after the serving
                # view moved over (the compaction's rule)
                out["purged"] = purge_stale(store, {"stale_files": stale})
            return out
        fin = plan.complete()
        if fin is None:
            return None
        had_index = os.path.exists(os.path.join(
            store.directory, store.index_dirname, "manifest.json"))
        if had_index:
            # the index over the NEW stamp before the final refresh, so
            # the completion swap lands stamp and index together
            fin["index_rebuild"] = self._swap_index(
                store, reason=f"model migration to step {req['to_step']}",
                refresh=False)
        if self._svc is not None:
            # this refresh adopts the new query tower and drops the old
            info = self._svc.refresh()
            fin["refresh_swap_ms"] = info.get("swap_ms")
            fin["refresh_seconds"] = info.get("refresh_seconds")
        self._migrate_req = None
        return fin

    # -- pillar: autoscale -------------------------------------------------
    def _autoscale_once(self) -> Optional[Dict]:
        """One policy evaluation: the attached service's windowed pressure
        signals against the thresholds; inside the fleet-size bounds and
        outside the cooldown, act through the hooks. Both directions emit
        their event whether or not a hook is attached."""
        if not self._as_on:
            return None
        svc = self._svc
        if svc is None:
            return None
        sig = svc.autoscale_signals()
        reg = self.registry
        reg.gauge("maintenance.autoscale_queue_p99_ms").set(
            sig["queue_wait_p99_ms"])
        reg.gauge("maintenance.autoscale_shed_rate").set(sig["shed_rate"])
        if self._size_hook is not None:
            size = int(self._size_hook())
        elif getattr(svc, "_fanout", None) is not None:
            size = len(svc._fanout.live_workers())
        else:
            return None       # no fleet to size
        # the queue-p99 trigger needs a populated window (the admission's
        # floor of 4 samples); a shed rate is evidence by itself
        queue_hot = (sig["queue_wait_samples"] >= 4
                     and sig["queue_wait_p99_ms"] >= self._as_up_queue)
        shed_hot = sig["shed_rate"] >= self._as_up_shed
        calm = (sig["queue_wait_p99_ms"] <= self._as_down_queue
                and sig["shed_rate"] == 0.0)
        decision = None
        if (queue_hot or shed_hot) and size < self._as_max:
            decision = "up"
        elif calm and size > self._as_min:
            decision = "down"
        if decision is None:
            return None
        now = self._clock()
        if (self._last_scale_t is not None
                and now - self._last_scale_t < self._as_cooldown_s):
            return None       # the last resize must settle first
        attrs = {"workers": size,
                 "queue_wait_p99_ms": sig["queue_wait_p99_ms"],
                 "shed_rate": sig["shed_rate"]}
        if decision == "up":
            acted = self._spawn_hook is not None
            if acted:
                self._spawn_hook(size)        # the next tail index
            reg.event("autoscale_up", dict(
                attrs, to_workers=size + 1, acted=acted,
                trigger="queue_wait" if queue_hot else "shed_rate"))
        else:
            acted = self._drain_hook is not None
            if acted:
                self._drain_hook(size - 1)    # the highest index drains
            reg.event("autoscale_down", dict(
                attrs, to_workers=size - 1, acted=acted))
        reg.counter("maintenance.autoscale_decisions").inc()
        self._last_scale_t = now
        return {"decision": decision, "workers": size, "acted": acted,
                **{k: sig[k] for k in ("queue_wait_p99_ms", "shed_rate")}}

    # -- pillar: janitor ---------------------------------------------------
    def _janitor_once(self) -> Optional[Dict]:
        store = VectorStore(self._store_dir, verify=False)
        out = {"lease_expired": False, "index_dirs_removed": 0,
               "migrate_dirs_removed": 0, "purged_dirs": 0,
               "purged_files": 0}
        if expire_stale_lease(store, registry=self.registry):
            out["lease_expired"] = True
            self.registry.counter("maintenance.leases_expired").inc()
        live_idx = os.path.join(store.directory, store.index_dirname)
        for path in sorted(glob.glob(os.path.join(store.directory,
                                                  "ivf*"))):
            name = os.path.basename(path)
            if (path == live_idx or not os.path.isdir(path)
                    or not _INDEX_DIR_RE.match(name)):
                continue
            shutil.rmtree(path, ignore_errors=True)
            out["index_dirs_removed"] += 1
        # migration unit directories no manifest references: a crashed
        # attempt's, or one a later migration or compaction superseded
        ref_dirs = {os.path.dirname(e[k]) for e in store.shards()
                    for k in _DATA_FILES if k in e}
        for path in sorted(glob.glob(os.path.join(store.directory,
                                                  "migrate-*"))):
            if (os.path.isdir(path)
                    and os.path.basename(path) not in ref_dirs):
                shutil.rmtree(path, ignore_errors=True)
                out["migrate_dirs_removed"] += 1
        epoch = store.compacted_through
        if epoch:
            ref_files = {e[k] for e in store.shards()
                         for k in _DATA_FILES
                         if k in e and os.path.dirname(e[k]) == ""}
            stale = {"stale_dirs": [], "stale_files": []}
            for path in glob.glob(os.path.join(store.directory, "gen-*")):
                m = re.match(r"^gen-(\d+)$", os.path.basename(path))
                if m and int(m.group(1)) <= epoch and os.path.isdir(path):
                    stale["stale_dirs"].append(path)
            for path in glob.glob(os.path.join(store.directory,
                                               "compact-*")):
                if (os.path.isdir(path)
                        and os.path.basename(path) not in ref_dirs):
                    stale["stale_dirs"].append(path)
            for path in glob.glob(os.path.join(store.directory,
                                               "shard_*.npy")):
                if os.path.basename(path) not in ref_files:
                    stale["stale_files"].append(path)
            purged = purge_stale(store, stale)
            out["purged_dirs"] = purged["purged_dirs"]
            out["purged_files"] = purged["purged_files"]
        return out if any(out.values()) else None
