"""The SLO driver: the port's copy of the JAX package's loadgen/driver.py.

Runs timed load trials against a live `SearchService` and searches
offered load for the maximum sustained QPS at which the windowed p99
stays under a target: "qps at p99 < X ms".

Measurement discipline:

  * every trial number is read from the service's registry
    (`SearchService.metrics()`: `serve_window_qps`,
    `serve_window_p50_ms` / `serve_window_p99_ms`, error and cache-hit
    rates over the last `obs.window_s` seconds), so `serve-metrics` and a
    trial report the same instrument. That latency is the service's: it
    is timed inside `search()`, so it leaves out a front end's event
    loop, its executor hop, the framing and the client. Beside it a trial
    keeps the client's own view, `client_p50_ms` / `client_p95_ms` /
    `client_p99_ms`: from each request's scheduled arrival (open loop)
    or its issue (closed loop) to its answer, over the requests that
    arrived after the warmup, and `issue_lag_max_ms`, how late the
    generator issued an open-loop request at worst.
    `p99_key="client_p99_ms"` makes a rate search judge that one;
  * a trial runs `warmup_s + duration_s` of offered traffic and reads the
    registry once at the end: with `duration_s >= obs.window_s` the
    rolling window has turned over past the warmup, so cold caches age
    out of the measurement by construction;
  * lifecycle events (`window_adapt`, `deadline_shed`, `index_degraded`,
    ...) observed during the trial ride along in its record.

Open-loop trials replay the workload's seeded arrival schedule on a
thread pool (`workers` in-flight submissions; `workers=0` issues
synchronously, the deterministic mode of the fake-clock tests).
Closed-loop trials run `int(load)` workers. `clock`/`sleep` are
injectable, so the driver runs on a fake clock with no real sleeps.

`find_qps_at_p99` doubles offered load while the target holds, then
bisects the bracket; every trial, passing or failing, lands in the
report.
"""
from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from dnn_page_vectors_tpu_torch.infer.transport import DeadlineExceeded
from dnn_page_vectors_tpu_torch.loadgen.workload import Mutator, Workload


def snapshot_line(svc, extra: Optional[Dict] = None) -> str:
    """One single-line JSON tick of the live SLO view — the format
    `cli serve-metrics --watch` prints and the driver reuses for trial
    progress. Keys are the windowed registry block plus counters an
    operator eyeballs during a run."""
    m = svc.metrics()
    rec = {
        "ts": round(time.time(), 3),
        "window_qps": m.get("serve_window_qps"),
        "window_p50_ms": m.get("serve_window_p50_ms"),
        "window_p99_ms": m.get("serve_window_p99_ms"),
        "window_error_rate": m.get("serve_window_error_rate"),
        "window_cache_hit_rate": m.get("serve_window_cache_hit_rate"),
        "queue_wait_p99_ms": m.get("serve_window_queue_wait_p99_ms"),
        "batch_window_ms": m.get("serve_batch_window_ms"),
    }
    # over-the-wire block (the socket front end): only
    # when the service reports one — an in-process service's tick stays
    # byte-identical to the pre-transport format
    transport = m.get("transport") or {}
    rec["wire_bytes"] = transport.get("wire_bytes")
    rec["wire_compression_ratio"] = transport.get("wire_compression_ratio")
    rec["deadline_sheds"] = transport.get("deadline_sheds")
    rec["hedge_fires"] = transport.get("hedge_fires")
    rec["workers_live"] = transport.get("workers_live")
    if extra:
        rec.update(extra)
    return json.dumps({k: v for k, v in rec.items() if v is not None})


class BalancedClient:
    """Client-side router over N front ends.

    Wraps one search client per front end and spreads `search()` calls
    across them. Two seeded policies:

      * ``round_robin`` — deterministic rotation starting at
        ``seed % n``; with a fixed workload seed the (request -> front
        end) assignment replays exactly;
      * ``least_loaded`` — pick the front end with the fewest in-flight
        requests; ties break by the same seeded rotation so the policy
        stays deterministic under a synchronous (workers=0) trial.

    It only routes and counts what it sent and what failed a front end
    (``stats()``); every measured number still comes from each front
    end's own registry (``run_trial``'s ``front_ends=`` block).
    """

    POLICIES = ("round_robin", "least_loaded")

    def __init__(self, clients: Sequence, policy: str = "round_robin",
                 seed: int = 0):
        if not clients:
            raise ValueError("BalancedClient needs at least one client")
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown balance policy {policy!r} (want one of "
                f"{self.POLICIES})")
        self.clients = list(clients)
        self.policy = policy
        self._lock = threading.Lock()
        n = len(self.clients)
        self._next = int(seed) % n            # guarded-by: _lock
        self._inflight = [0] * n              # guarded-by: _lock
        self._sent = [0] * n                  # guarded-by: _lock
        self._errors = [0] * n                # guarded-by: _lock

    def _pick(self) -> int:
        with self._lock:
            n = len(self.clients)
            if self.policy == "least_loaded":
                # tie-break by seeded rotation distance so equal-load
                # picks stay deterministic
                nxt = self._next
                i = min(range(n),
                        key=lambda j: (self._inflight[j], (j - nxt) % n))
            else:
                i = self._next
            self._next = (i + 1) % n
            self._inflight[i] += 1
            self._sent[i] += 1
            return i

    def search(self, query, k: int = 10, nprobe: Optional[int] = None,
               filters=None):
        i = self._pick()
        try:
            if filters is not None:
                return self.clients[i].search(query, k=k, nprobe=nprobe,
                                              filters=filters)
            return self.clients[i].search(query, k=k, nprobe=nprobe)
        except Exception:
            with self._lock:
                self._errors[i] += 1
            raise
        finally:
            with self._lock:
                self._inflight[i] -= 1

    def stats(self) -> Dict:
        """The requests sent to and failed by each front end (the
        client's view; the latencies come from each front end's
        registry)."""
        with self._lock:
            return {"policy": self.policy, "sent": list(self._sent),
                    "errors": list(self._errors)}


def run_trial(svc, workload: Workload, offered: float, queries: Sequence[str],
              *, duration_s: float = 10.0, warmup_s: float = 0.0,
              workers: int = 16, mutator: Optional[Mutator] = None,
              clock: Callable[[], float] = time.monotonic,
              sleep: Callable[[float], None] = time.sleep,
              progress: Optional[Callable[[str], None]] = None,
              progress_every_s: float = 0.0, client=None,
              front_ends: Optional[Sequence] = None) -> Dict:
    """One timed trial at one offered load; returns the trial record.

    `offered` is a rate (qps) for open-loop workloads and a worker count
    for closed-loop ones. `queries` maps the workload's distinct query
    ids onto real query texts (`query_id % len(queries)`).

    `client` (a transport.SocketSearchClient, or anything with the same
    `search(query, k, nprobe)` shape) reroutes the ISSUE path over the
    wire; the registry's numbers are still the service's, and the
    client_* latencies cover the full network path: framing, admission,
    batcher, and the socket round trip back.

    `front_ends` (services, `svc` first) makes the trial a tier's:
    `client` is then a `BalancedClient` over them, and the headline
    numbers are the tier's: achieved qps the sum of the front ends' window
    qps, p50 and p99 the largest, the error rate qps-weighted, with a
    `front_ends` block of each front end's own numbers beside them."""
    ev0 = len(svc.registry.events()) if hasattr(svc, "registry") else 0
    mut0 = mutator.calls if mutator is not None else 0
    m0 = svc.metrics()
    transport0 = dict(m0.get("transport") or {})
    rcache0 = dict(m0.get("result_cache") or {})
    sent = 0
    errors = 0
    sheds = 0
    err_lock = threading.Lock()
    issue_to = client if client is not None else svc
    client_ms: List[float] = []      # answered after the warmup; err_lock
    issue_lag = 0.0                  # the generator's worst lateness, s
    # a filtered mix's client latency by scenario (the registry cannot
    # tell a window sample's predicate), seconds from issue to answer
    scen_lat: Dict[str, List[float]] = {}

    def _issue(req, t_sent=None):
        nonlocal errors, sheds, issue_lag
        now = clock()
        if t_sent is None:
            t_sent = now
        else:
            with err_lock:
                issue_lag = max(issue_lag, now - t_sent)
        kw = {"filters": req.filters} if req.filters else {}
        t_req = clock()
        try:
            issue_to.search(queries[req.query_id % len(queries)], k=req.k,
                            nprobe=req.nprobe, **kw)
        except DeadlineExceeded:
            # an admission shed is an availability decision the trial
            # reports separately, not a server error
            with err_lock:
                sheds += 1
        except Exception:  # noqa: BLE001 — errors are a trial METRIC
            with err_lock:
                errors += 1
        else:
            if t_sent >= t_measured:
                ms = (clock() - t_sent) * 1000.0
                with err_lock:
                    client_ms.append(ms)
            if req.scenario is not None:
                with err_lock:
                    scen_lat.setdefault(req.scenario, []).append(
                        clock() - t_req)

    total_s = float(warmup_s) + float(duration_s)
    t0 = clock()
    t_measured = t0 + float(warmup_s)
    next_tick = progress_every_s or float("inf")

    def _tick(now):
        nonlocal next_tick
        if progress is not None and now - t0 >= next_tick:
            next_tick += progress_every_s
            progress(snapshot_line(
                svc, {"offered": offered, "elapsed_s": round(now - t0, 2)}))

    if workload.kind == "closed":
        n_workers = max(1, int(offered))
        stop = t0 + total_s

        def _worker(wid: int):
            nonlocal sent
            stream = workload.worker_stream(wid)
            while clock() < stop:
                _issue(next(stream))
                with err_lock:
                    sent += 1
                if workload.think_s:
                    sleep(workload.think_s)
                _tick(clock())
                if mutator is not None:
                    mutator.maybe_fire(clock() - t0, base=mut0)

        if workers == 0:
            _worker(0)
        else:
            threads = [threading.Thread(target=_worker, args=(w,),
                                        daemon=True)
                       for w in range(n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        schedule_digest = None
    else:
        schedule = workload.schedule(total_s, float(offered))
        schedule_digest = Workload.digest(schedule)
        pool = ThreadPoolExecutor(max_workers=workers) if workers else None
        futures = []
        try:
            for t_arr, req in schedule:
                now = clock()
                if t0 + t_arr > now:
                    sleep(t0 + t_arr - now)
                    now = t0 + t_arr
                if mutator is not None:
                    mutator.maybe_fire(now - t0, base=mut0)
                _tick(now)
                # the client's clock starts at the scheduled arrival, so
                # a request the generator issues late still counts its wait
                if pool is None:
                    _issue(req, t0 + t_arr)   # synchronous deterministic mode
                else:
                    futures.append(pool.submit(_issue, req, t0 + t_arr))
                sent += 1
            rem = t0 + total_s - clock()
            if rem > 0:
                sleep(rem)
        finally:
            if pool is not None:
                for f in futures:
                    f.result()
                pool.shutdown(wait=True)

    m = svc.metrics()
    events = (svc.registry.events()[ev0:]
              if hasattr(svc, "registry") else [])
    rec = {
        "offered_qps": round(float(offered), 3),
        "achieved_qps": m.get("serve_window_qps", 0.0),
        "p50_ms": m.get("serve_window_p50_ms", 0.0),
        "p95_ms": m.get("serve_window_p95_ms", 0.0),
        "p99_ms": m.get("serve_window_p99_ms", 0.0),
        "error_rate": m.get("serve_window_error_rate", 0.0),
        "cache_hit_rate": m.get("serve_window_cache_hit_rate", 0.0),
        "queue_wait_p99_ms": m.get("serve_window_queue_wait_p99_ms"),
        "batch_window_ms": m.get("serve_batch_window_ms"),
        "ann_fallbacks": m.get("ann_fallbacks", 0),
        "requests_sent": sent,
        "errors": errors,
        **_client_percentiles(client_ms),
        "issue_lag_max_ms": round(issue_lag * 1000.0, 3),
        "shape": workload.shape,
        "duration_s": round(float(duration_s), 3),
        "warmup_s": round(float(warmup_s), 3),
        "events": [{"event": e["event"], "attrs": e["attrs"],
                    "trace_id": e.get("trace_id")} for e in events],
    }
    if front_ends is not None and len(front_ends) > 1:
        # a tier of front ends: each row reads that front end's registry
        fes = []
        for i, fe in enumerate(front_ends):
            fm = fe.metrics() if fe is not svc else m
            fes.append({
                "front_end": i,
                "qps": fm.get("serve_window_qps", 0.0),
                "p50_ms": fm.get("serve_window_p50_ms", 0.0),
                "p99_ms": fm.get("serve_window_p99_ms", 0.0),
                "error_rate": fm.get("serve_window_error_rate", 0.0),
            })
        tier_qps = sum(f["qps"] for f in fes)
        rec["front_ends"] = fes
        rec["achieved_qps"] = round(tier_qps, 3)
        rec["p99_ms"] = max(f["p99_ms"] for f in fes)
        rec["p50_ms"] = max(f["p50_ms"] for f in fes)
        rec["error_rate"] = (
            round(sum(f["error_rate"] * f["qps"] for f in fes)
                  / tier_qps, 4) if tier_qps else
            max(f["error_rate"] for f in fes))
        if isinstance(client, BalancedClient):
            rec["balance"] = client.stats()
    if "partitions" in m:
        # partitioned serving: the per-partition qps/p99/shed block and the
        # routing counters ride each trial record, so a p99 excursion
        # points at the partition that shed
        rec["partitions"] = m["partitions"]
        rec["replica_shed"] = m.get("replica_shed", 0)
        rec["partition_degraded"] = m.get("partition_degraded", 0)
    transport1 = m.get("transport")
    if transport1 or sheds:
        # over-the-wire block (the socket front end),
        # ONLY when the trial actually crossed a transport (or shed):
        # in-process trial records stay byte-identical to before.
        # Counter keys are PER-TRIAL deltas against the trial-start
        # snapshot; the fleet's topology keys report the end state.
        blk: Dict = {}
        for key in ("wire_bytes", "wire_raw_bytes", "deadline_sheds",
                    "hedge_fires", "rpcs", "rpc_fallbacks",
                    "breaker_trips"):
            new = (transport1 or {}).get(key)
            if new is not None:
                blk[key] = new - transport0.get(key, 0)
        if "wire_raw_bytes" in blk and blk.get("wire_bytes"):
            blk["wire_compression_ratio"] = round(
                blk["wire_raw_bytes"] / blk["wire_bytes"], 3)
        for key in ("workers_live", "workers_registered",
                    "workers_compressing", "breakers_open"):
            if transport1 and key in transport1:
                blk[key] = transport1[key]
        if sheds:
            blk["client_sheds"] = sheds
        rec["transport"] = blk
    rcache1 = m.get("result_cache")
    if rcache1:
        # result-cache block, ONLY when the feature is on: hit/miss
        # counters are per-trial deltas against the trial-start snapshot;
        # entries/bytes are end state
        rhits = rcache1.get("hits", 0) - rcache0.get("hits", 0)
        rmiss = rcache1.get("misses", 0) - rcache0.get("misses", 0)
        rec["result_cache"] = {
            "hits": rhits, "misses": rmiss,
            "hit_rate": round(rhits / (rhits + rmiss), 4)
            if (rhits + rmiss) else 0.0,
            "entries": rcache1.get("entries", 0),
            "bytes": rcache1.get("bytes", 0),
        }
    if scen_lat:
        # the filtered mix's block: one row a scenario, the client's
        # latency around the issue call (the window p99 stays the headline)
        rec["filter_scenarios"] = {
            name: {
                "requests": len(lat),
                "qps": round(len(lat) / max(total_s, 1e-9), 2),
                "p50_ms": round(float(np.percentile(lat, 50)) * 1000.0, 3),
                "p99_ms": round(float(np.percentile(lat, 99)) * 1000.0, 3),
            } for name, lat in sorted(scen_lat.items())}
    if schedule_digest is not None:
        rec["schedule_digest"] = schedule_digest
    if mutator is not None:
        rec["mutator_calls"] = mutator.calls - mut0
        if len(mutator.ops) > 1:
            rec["mutator_calls_by_op"] = dict(mutator.calls_by_op)
        if mutator.errors:
            rec["mutator_errors"] = mutator.errors
    return rec


def _client_percentiles(ms: List[float]) -> Dict:
    """client_p50_ms / client_p95_ms / client_p99_ms of the client's
    latencies (None with no sample)."""
    q = (np.percentile(ms, (50, 95, 99)) if ms else (None,) * 3)
    return {f"client_p{p}_ms": (None if v is None else round(float(v), 3))
            for p, v in zip((50, 95, 99), q)}


def _meets(trial: Dict, p99_target_ms: float, max_error_rate: float,
           sustain_frac: float, p99_key: str = "p99_ms") -> bool:
    """Did a trial hold the objective? p99 (the service's, or with
    p99_key="client_p99_ms" the client's) under target, errors under the
    budget, and — open loop only — the service actually KEPT UP with the
    offered rate (an overloaded open-loop service shows a sagging
    achieved rate as its queue grows; that is a miss even if the window's
    p99 lags behind the cliff)."""
    p99 = trial[p99_key]
    if p99 is None or p99 > p99_target_ms:
        return False
    if trial["error_rate"] > max_error_rate:
        return False
    if trial["shape"] != "closed" and trial["offered_qps"] > 0:
        if trial["achieved_qps"] < sustain_frac * trial["offered_qps"]:
            return False
    return True


def find_qps_at_p99(svc, workload: Workload, queries: Sequence[str],
                    p99_target_ms: float, *, start: float = 8.0,
                    max_load: float = 65_536.0, iters: int = 5,
                    duration_s: float = 10.0, warmup_s: float = 2.0,
                    workers: int = 16, max_error_rate: float = 0.0,
                    sustain_frac: float = 0.8,
                    mutator: Optional[Mutator] = None,
                    clock: Callable[[], float] = time.monotonic,
                    sleep: Callable[[float], None] = time.sleep,
                    progress: Optional[Callable[[str], None]] = None,
                    progress_every_s: float = 0.0, client=None,
                    p99_key: str = "p99_ms",
                    front_ends: Optional[Sequence] = None) -> Dict:
    """Binary-search offered load for the max sustained QPS meeting the
    p99 target. Doubling phase brackets the cliff, bisection sharpens it;
    `qps_at_p99` is the best ACHIEVED qps among passing trials (what the
    service demonstrably served, not what was merely offered). With
    `client` set the issue path crosses the socket (run_trial);
    `p99_key="client_p99_ms"` then judges each trial on the client's p99,
    which covers the full network path, instead of the service's.
    `front_ends` makes every trial a tier's (run_trial)."""
    trials: List[Dict] = []

    def _trial(load: float) -> Dict:
        tr = run_trial(svc, workload, load, queries, duration_s=duration_s,
                       warmup_s=warmup_s, workers=workers, mutator=mutator,
                       clock=clock, sleep=sleep, progress=progress,
                       progress_every_s=progress_every_s, client=client,
                       front_ends=front_ends)
        tr["met"] = _meets(tr, p99_target_ms, max_error_rate, sustain_frac,
                           p99_key)
        trials.append(tr)
        if progress is not None:
            progress(json.dumps({
                "trial": len(trials), "offered": tr["offered_qps"],
                "achieved": tr["achieved_qps"], "p99_ms": tr[p99_key],
                "met": tr["met"]}))
        return tr

    lo, hi = 0.0, float(start)
    tr = _trial(hi)
    if tr["met"]:
        # doubling phase: raise offered load until the target breaks
        while hi < max_load:
            lo, hi = hi, min(max_load, hi * 2.0)
            if not _trial(hi)["met"]:
                break
        else:
            lo = hi
    # bisection phase inside (lo, hi]
    for _ in range(max(0, int(iters))):
        if hi - lo <= max(1.0, 0.05 * lo):
            break
        mid = (lo + hi) / 2.0
        if workload.kind == "closed":
            mid = float(int(mid))
            if mid <= lo:
                break
        if _trial(mid)["met"]:
            lo = mid
        else:
            hi = mid
    passing = [t for t in trials if t["met"]]
    qps = max((t["achieved_qps"] for t in passing), default=0.0)
    return {
        "qps_at_p99": round(qps, 2),
        "p99_target_ms": float(p99_target_ms),
        "p99_key": p99_key,
        "shape": workload.shape,
        "seed": workload.seed,
        "load_sustained": lo,
        "trials": trials,
        "trial_duration_s": float(duration_s),
        "trial_warmup_s": float(warmup_s),
        "sustain_frac": sustain_frac,
        "events": [e for t in trials for e in t["events"]],
    }
