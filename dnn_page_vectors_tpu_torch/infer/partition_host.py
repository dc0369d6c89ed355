"""The serving fleet over the wire: the port's copy of the JAX package's
infer/partition_host.py. Partitions and replicas as processes of their own,
behind a socket, speaking the frames of infer/transport.py byte for byte as
the JAX package does, so a JAX peer and a port peer serve each other.

  * ``PartitionWorker``: one partition replica as its own process (``cli
    partition-worker``; in tests, a thread with a service of its own). It
    opens the store, builds ONE view over its spec's contiguous shard range
    with the same ``SearchService._build_view`` the in-process replicas use
    (so its results are the in-process ones by construction), staged on
    its device (the card unless ``device="cpu"``), registers with the
    front end's ``WorkerGateway``, heartbeats, and answers ``T_VQUERY``
    frames with ``_topk_view`` over its slice. It builds no model: workers
    launch no attention kernel.
  * ``WorkerGateway``: the front end's side. A plain-socket listener where
    workers register, one reader thread a worker that demultiplexes the
    answers by request id, and ``topk()``: the query matrix, encoded once
    a bucket and copied to the host once, fans out to one routed worker a
    partition. Routing goes through ``PartitionSet._route``, which sees the
    workers' liveness through ``set_liveness``: a lost worker's replica
    sheds with reason "liveness" as a restaging one does in process.

Tail latency:

  * deadlines travel as relative milliseconds, budgeted against the
    bucket's tightest deadline; the worker re-anchors them on its own
    clock;
  * hedged requests: when a partition's answer has not come within the
    ``serve.hedge_quantile`` point of its observed RPC latency (8 samples
    or more), the same request goes to a sibling replica's worker and the
    first answer wins (``serve.hedge_fired``, a ``hedge_fired`` event);
  * the local fallback: a worker that is dead, late or tears its answer
    costs latency, never bytes: the gateway computes that partition's slice
    on the front end's own view of the same shard range (staged on the
    card like every view), on the replica's CUDA stream after the encode's
    event, and counts it (``rpc_fallbacks``).

A worker is alive while its connection is open and its last heartbeat is
younger than 2 x ``serve.heartbeat_s`` plus 0.25 s. EOF or a torn frame
marks it lost at once (``worker_lost``) and fails its requests in flight
over to the fallback.

Self-healing: ``PartitionWorker.run`` re-dials with exponential backoff and
jitter (``serve.reconnect_base_s`` / ``reconnect_max_s``) and re-registers
with its current generation; the gateway re-admits it (``worker_rejoined``)
and sends a generation-lagging rejoiner a ``T_REFRESH``. Each replica slot
has a circuit breaker (``serve.breaker_*``): K consecutive wire failures
open it and routing skips the replica until a half-open probe succeeds.

Generations and splits: after ``SearchService.refresh()`` the gateway
broadcasts ``T_REFRESH``; until a worker acks, routing treats it as stale
and its slice serves from the front end's new view, so no result set mixes
generations. With ``serve.elastic`` the live worker set sets the partition
split: a worker joining at the next tail index widens it, a draining tail
worker narrows it, through the same handoff, gated on the split each
worker acked.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import socket
import threading
import time
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, Future
from concurrent.futures import wait as futures_wait
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.index.attrs import compile_filters
from dnn_page_vectors_tpu_torch.infer import transport
from dnn_page_vectors_tpu_torch.infer.transport import (
    DeadlineExceeded, FrameError, FLAG_FILTERS, FLAG_RESULT_CACHE,
    FLAG_WIRE_COMPRESS, FrameSender, InternTable, RemoteError, T_BYE,
    T_DRAIN, T_HEARTBEAT, T_HELLO, T_REFRESH, T_REGISTER, T_RESULT,
    T_RESULT_C, T_SHED, T_ERROR, T_VQUERY, T_VQUERY_PUT, T_VQUERY_REF)
from dnn_page_vectors_tpu_torch.ops.topk import merge_partition_topk
from dnn_page_vectors_tpu_torch.utils import faults
from dnn_page_vectors_tpu_torch.utils.device import resolve_device
from dnn_page_vectors_tpu_torch.utils.profiling import LatencyStats


class DeviceEmbedder:
    """The model-free embedder a partition worker serves with, in place of
    the JAX package's ``MeshEmbedder``: it holds the device the worker's
    view is staged on and scored on, and no model or tokenizer, since the
    vector RPC path never encodes."""

    vectors_only = True

    def __init__(self, device):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.query_tok = None
        self.page_tok = None


def _host_block(qv, n: int) -> np.ndarray:
    """The first n rows of host or device query vectors as one contiguous
    little-endian float32 host block: the single copy off the card a
    scatter makes."""
    if isinstance(qv, torch.Tensor):
        qv = qv[:n].float().cpu().numpy()
    return np.ascontiguousarray(qv[:n], dtype="<f4")


class _WorkerConn:
    """The front end's record of one registered partition worker."""

    def __init__(self, sock: socket.socket, addr, partition: int,
                 replica: int, pid: int, flags: int = 0,
                 generation: int = 0):
        self.sock = sock
        self.addr = addr
        self.partition = int(partition)
        self.replica = int(replica)
        self.pid = int(pid)
        self.flags = int(flags)            # the agreed capabilities, once
        self.wlock = threading.Lock()      # serializes frame writes
        self.sender = FrameSender(sock)    # guarded-by: wlock
        self.intern = InternTable()        # guarded-by: wlock
        self._lock = threading.Lock()
        self._last_beat = time.perf_counter()   # guarded-by: _lock
        self._dead = False                       # guarded-by: _lock
        self._generation = int(generation)       # guarded-by: _lock
        # the split width this worker's last T_REFRESH ack reported; None
        # until one lands. Elastic routing gates on it as on the generation
        self._split: Optional[int] = None        # guarded-by: _lock
        # a worker that announced T_DRAIN is routed no new work
        self._draining = False                   # guarded-by: _lock

    def beat(self) -> None:
        with self._lock:
            self._last_beat = time.perf_counter()

    def alive(self, max_age_s: float) -> bool:
        with self._lock:
            if self._dead:
                return False
            return (time.perf_counter() - self._last_beat) <= max_age_s

    def mark_dead(self, reason: str) -> bool:
        """-> True exactly once (its caller emits worker_lost)."""
        with self._lock:
            if self._dead:
                return False
            self._dead = True
            return True

    @property
    def dead(self) -> bool:
        with self._lock:
            return self._dead

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def set_generation(self, gen: int,
                       split: Optional[int] = None) -> None:
        with self._lock:
            self._generation = int(gen)
            if split is not None and split > 0:
                self._split = int(split)

    @property
    def split(self) -> Optional[int]:
        with self._lock:
            return self._split

    def set_draining(self) -> bool:
        """-> True exactly once (its caller emits worker_draining)."""
        with self._lock:
            if self._draining:
                return False
            self._draining = True
            return True

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining


class WorkerGateway:
    """The front end's worker registry and RPC fan-out, one a service.

    Workers connect to `port` and REGISTER; a reader thread a worker takes
    its heartbeats and answers, and ``topk()`` is the scatter the service
    routes through once attached (``svc.attach_gateway(gw)``)."""

    def __init__(self, svc, pset=None, host: str = "127.0.0.1",
                 port: int = 0, heartbeat_s: Optional[float] = None,
                 hedge_quantile: Optional[float] = None,
                 rpc_timeout_s: float = 10.0):
        self._svc = svc
        serve = svc.cfg.serve
        self.heartbeat_s = float(heartbeat_s if heartbeat_s is not None
                                 else serve.heartbeat_s)
        self.hedge_quantile = float(hedge_quantile if hedge_quantile
                                    is not None else serve.hedge_quantile)
        # what this end confirms when a worker advertises a capability
        self._compress = bool(serve.wire_compress)
        self._rcache = bool(serve.result_cache and serve.result_cache_fleet)
        self._filters = bool(serve.filters)
        self._breaker_failures = int(serve.breaker_failures)
        self._breaker_open_s = float(serve.breaker_open_s)
        self._breaker_max_s = float(serve.breaker_max_s)
        self._elastic = bool(serve.elastic)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self._own_pset = None
        if pset is None:
            pset = svc.partition_set
        if pset is None:
            # a single-view service fans out through a 1-partition set the
            # gateway owns (its routing and fallback views live there)
            from dnn_page_vectors_tpu_torch.infer.partition import (
                PartitionSet)
            self._own_pset = pset = PartitionSet(svc, svc.store,
                                                 partitions=1, replicas=1)
        self.partition_set = pset
        # lock-order: WorkerGateway._lock < _WorkerConn._lock
        self._lock = threading.Lock()
        self._workers: Dict[Tuple[int, int], _WorkerConn] = {}  # guarded-by: _lock
        # breakers outlive their connection: keyed by replica slot, so the
        # trip history spans re-registrations
        self._breakers: Dict[Tuple[int, int], faults.CircuitBreaker] = {}  # guarded-by: _lock
        self._pending: Dict[int, Tuple[Future, _WorkerConn]] = {}  # guarded-by: _lock
        self._lat: Dict[int, LatencyStats] = {}   # guarded-by: _lock
        self._registered = 0                      # guarded-by: _lock
        self._rpcs = 0                            # guarded-by: _lock
        self._rpcs_by_pid: Dict[int, int] = {}    # guarded-by: _lock
        self._rpc_fallbacks = 0                   # guarded-by: _lock
        self._resplits = 0                        # guarded-by: _lock
        self._wait_timeouts = 0                   # guarded-by: _lock
        self._closed = False                      # guarded-by: _lock
        self._threads: List[threading.Thread] = []   # guarded-by: _lock
        # one elastic re-split at a time; the resize itself runs under the
        # service's refresh lock, so a refresh and a re-split never
        # interleave their view swaps
        # lock-order: WorkerGateway._resplit_lock < SearchService._refresh_lock
        # lock-order: SearchService._refresh_lock < WorkerGateway._lock
        self._resplit_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]
        self._accept_t = threading.Thread(target=self._accept_loop,
                                          daemon=True,
                                          name="worker-gateway-accept")
        self._accept_t.start()

    # -- the registry -----------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return            # the listener closed
            spec = faults.active().wire("gateway_accept")
            if spec is not None:
                # an injected accept fault: the dial lands and dies (or
                # stalls); the worker's retry and reconnect are under test
                if spec.kind in ("delay", "frame_delay"):
                    time.sleep(faults.active().wire_delay_s())
                else:
                    conn.close()
                    continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._conn_loop, args=(conn, addr),
                                 daemon=True, name="worker-gateway-reader")
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._threads.append(t)
            t.start()

    def _send_control(self, worker: _WorkerConn, ftype: int,
                      payload: bytes = b"") -> None:
        svc = self._svc
        with worker.wlock:
            worker.sender.send(ftype, payload, counter=svc._m_wire_bytes,
                               raw_counter=svc._m_wire_raw)

    def _conn_loop(self, conn: socket.socket, addr) -> None:
        """One worker's reader: REGISTER first, then heartbeats, answers
        and control frames until EOF or a torn frame."""
        svc = self._svc
        worker: Optional[_WorkerConn] = None
        reason = "connection closed"
        try:
            frame = transport.read_frame(conn)
            if frame is None or frame[0] != T_REGISTER:
                conn.close()
                return
            self._account(transport.HEADER.size + len(frame[1]))
            pid_, rid, wpid, wflags, wgen = transport.decode_register(
                frame[1])
            agreed = wflags & ((FLAG_WIRE_COMPRESS if self._compress else 0)
                               | (FLAG_RESULT_CACHE if self._rcache else 0)
                               | (FLAG_FILTERS if self._filters else 0))
            worker = _WorkerConn(conn, addr, pid_, rid, wpid,
                                 flags=agreed, generation=wgen)
            with self._lock:
                old = self._workers.get((pid_, rid))
                self._workers[(pid_, rid)] = worker
                self._registered += 1
            rejoined = False
            if old is not None:
                if old.mark_dead("replaced"):
                    self._fail_inflight(old, "replaced by a new "
                                             "registration")
                else:
                    # the slot's last connection was already lost: this is
                    # a self-healing worker's re-dial landing
                    rejoined = True
            if wflags:
                # the agreed set rides the same ordered stream, ahead of
                # any VQUERY
                self._send_control(worker, T_HELLO,
                                   transport.encode_hello(agreed))
            svc.registry.event("worker_registered", {
                "partition": pid_, "replica": rid, "pid": wpid,
                "addr": f"{addr[0]}:{addr[1]}",
                "wire_compress": bool(agreed & FLAG_WIRE_COMPRESS),
                "result_cache": bool(agreed & FLAG_RESULT_CACHE),
                "filters": bool(agreed & FLAG_FILTERS),
                "generation": wgen})
            if rejoined:
                # the fresh connection wipes the breaker's failure streak
                self._breaker_result(pid_, rid, ok=True)
                svc.registry.event("worker_rejoined", {
                    "partition": pid_, "replica": rid, "pid": wpid,
                    "generation": wgen})
            # a worker whose view lags the routed generation serves nothing
            # until T_REFRESH catches it up: nudge it now. Elastic, the
            # nudge always goes and carries the routed split, since a
            # joiner is routable only once it acks one
            cur_gen = self._routed_generation(pid_)
            cur_split = (len(self.partition_set.table())
                         if self._elastic else 0)
            if cur_gen is not None and (wgen != cur_gen or self._elastic):
                try:
                    self._send_control(worker, T_REFRESH,
                                       transport.encode_refresh(cur_gen,
                                                                cur_split))
                except OSError:
                    pass          # a dying worker re-registers fresh
            self._maybe_resplit(trigger="join")
            while True:
                frame = transport.read_frame(conn)
                if frame is None:
                    break
                ftype, payload = frame
                actual = transport.HEADER.size + len(payload)
                if ftype == T_HEARTBEAT:
                    self._account(actual)
                    worker.beat()
                elif ftype in (T_RESULT, T_RESULT_C, T_SHED, T_ERROR):
                    worker.beat()     # any traffic proves liveness
                    self._resolve(ftype, payload, actual)
                elif ftype == T_REFRESH:
                    # the worker's rebuild ack: it now serves this
                    # generation (and split) and is routable again
                    self._account(actual)
                    gen, wsplit = transport.decode_refresh(payload)
                    worker.set_generation(gen, split=wsplit)
                    worker.beat()
                    svc.registry.event("worker_refreshed", {
                        "partition": worker.partition,
                        "replica": worker.replica, "generation": gen,
                        "partitions": wsplit})
                elif ftype == T_DRAIN:
                    # a graceful exit: no new work from now on (its slice
                    # serves locally), and the elastic split may narrow
                    self._account(actual)
                    worker.beat()
                    if worker.set_draining():
                        svc.registry.event("worker_draining", {
                            "partition": worker.partition,
                            "replica": worker.replica, "pid": worker.pid})
                        self._maybe_resplit(trigger="drain")
                elif ftype == T_BYE:
                    self._account(actual)
                    reason = "deregistered"
                    break
                else:
                    self._account(actual)
                    reason = f"unexpected frame type {ftype}"
                    break
        except FrameError as e:
            # a torn answer or garbage is treated as a crashed peer
            reason = f"torn frame: {e}"
        except OSError as e:
            reason = f"socket error: {e}"
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if worker is not None and worker.mark_dead(reason):
                self._fail_inflight(worker, reason)
                svc.registry.event("worker_lost", {
                    "partition": worker.partition,
                    "replica": worker.replica,
                    "reason": reason[:200]})

    def _account(self, actual: int, raw: Optional[int] = None) -> None:
        """The bytes moved, and their raw-frame equivalent (what the same
        traffic costs uncompressed): the compression ratio's parts."""
        self._svc._m_wire_bytes.inc(actual)
        self._svc._m_wire_raw.inc(actual if raw is None else raw)

    def _resolve(self, ftype: int, payload: bytes, actual: int) -> None:
        if ftype in (T_RESULT, T_RESULT_C):
            req_id, scores, ids, scan = transport.decode_result_any(
                ftype, payload)
            self._account(actual,
                          raw=transport.result_raw_bytes(*scores.shape)
                          if ftype == T_RESULT_C else actual)
            ok: Optional[Tuple] = (scores, ids, scan)
            exc: Optional[Exception] = None
        elif ftype == T_SHED:
            self._account(actual)
            req_id, code, why = transport.decode_shed(payload)
            ok, exc = None, DeadlineExceeded(why or f"shed code {code}")
        else:
            self._account(actual)
            req_id, msg = transport.decode_error(payload)
            ok, exc = None, RemoteError(msg)
        with self._lock:
            entry = self._pending.pop(req_id, None)
        if entry is None:
            return                # a hedged loser landing late
        fut, _ = entry
        if exc is None:
            fut.set_result(ok)
        else:
            fut.set_exception(exc)

    def _fail_inflight(self, worker: _WorkerConn, reason: str) -> None:
        with self._lock:
            doomed = [rid for rid, (_, w) in self._pending.items()
                      if w is worker]
            entries = [self._pending.pop(rid) for rid in doomed]
        for fut, _ in entries:
            fut.set_exception(RemoteError(f"worker lost: {reason}"))

    def _routed_generation(self, pid: int) -> Optional[int]:
        """The store generation the front end routes for partition `pid`:
        what a worker must serve to be eligible."""
        table = self.partition_set.table()
        if pid >= len(table) or not table[pid]:
            return None
        return table[pid][0].generation

    # -- the breakers -------------------------------------------------------
    def _breaker(self, pid: int, rid: int) -> faults.CircuitBreaker:
        """Replica (pid, rid)'s breaker, made on first use. Its callbacks
        run outside its own lock, so taking the registry lock in
        _breaker_event keeps the lock order."""
        with self._lock:
            br = self._breakers.get((pid, rid))
            if br is None:
                br = self._breakers[(pid, rid)] = faults.CircuitBreaker(
                    failures=self._breaker_failures,
                    open_s=self._breaker_open_s,
                    max_open_s=self._breaker_max_s,
                    on_open=lambda b, p=pid, r=rid: self._breaker_event(
                        "breaker_open", p, r, b),
                    on_close=lambda b, p=pid, r=rid: self._breaker_event(
                        "breaker_close", p, r, b))
            return br

    def _breaker_allow(self, pid: int, rid: int) -> bool:
        if self._breaker_failures <= 0:
            return True
        return self._breaker(pid, rid).allow()

    def _breaker_result(self, pid: int, rid: int, ok: bool) -> None:
        """A wire outcome for replica (pid, rid). Only wire failures count
        (a failed send, a lost worker, a remote error); a deadline shed is
        a healthy worker's backpressure and never opens a breaker."""
        if self._breaker_failures <= 0:
            return
        br = self._breaker(pid, rid)
        if ok:
            br.record_success()
        else:
            br.record_failure()

    def _breaker_event(self, name: str, pid: int, rid: int,
                       br: faults.CircuitBreaker) -> None:
        with self._lock:
            n_open = sum(1 for b in self._breakers.values()
                         if b.state == "open")
        reg = self._svc.registry
        reg.gauge("serve.breakers_open").set(n_open)
        reg.event(name, {"partition": pid, "replica": rid,
                         "trips": br.trips, "open": n_open})

    # -- liveness -----------------------------------------------------------
    def _alive_age_s(self) -> float:
        """The heartbeat age past which a connected worker counts as hung:
        two missed beats plus a floor for the host's scheduling jitter. A
        crash never waits for it: EOF marks the worker lost at once."""
        return 2.0 * self.heartbeat_s + 0.25

    def worker_alive(self, pid: int, rid: int) -> bool:
        with self._lock:
            w = self._workers.get((pid, rid))
        return w is not None and w.alive(self._alive_age_s())

    def active(self) -> bool:
        """Any live worker at all? False: the in-process scatter serves."""
        with self._lock:
            workers = list(self._workers.values())
        age = self._alive_age_s()
        return any(w.alive(age) for w in workers)

    def live_workers(self) -> List[Tuple[int, int]]:
        with self._lock:
            keys = list(self._workers)
        return [key for key in keys if self.worker_alive(*key)]

    def worker_pids(self) -> Dict[Tuple[int, int], int]:
        """(partition, replica) -> the process id of each live worker."""
        with self._lock:
            workers = list(self._workers.items())
        age = self._alive_age_s()
        return {key: w.pid for key, w in workers if w.alive(age)}

    def wait_for_workers(self, n: int, timeout_s: float = 30.0) -> bool:
        """Block until `n` workers are live; False on timeout, after
        recording what the wait wanted and the fleet it saw
        (`gateway_wait_timeout` event, stats()'s wait_timeouts)."""
        t0 = time.perf_counter()
        t_end = t0 + timeout_s
        while time.perf_counter() < t_end:
            if len(self.live_workers()) >= n:
                return True
            time.sleep(0.01)
        live = len(self.live_workers())
        if live >= n:
            return True
        with self._lock:
            registered = self._registered
        self._note_wait_timeout(
            "workers", time.perf_counter() - t0, timeout_s,
            wanted=int(n), live=live, registered=registered)
        return False

    def _note_wait_timeout(self, barrier: str, waited_s: float,
                           timeout_s: float, **state) -> None:
        with self._lock:
            self._wait_timeouts += 1
        self._svc.registry.event("gateway_wait_timeout", dict(
            {"barrier": barrier, "waited_s": round(waited_s, 3),
             "timeout_s": round(float(timeout_s), 3)}, **state))

    def _pick_worker(self, pid: int, prefer_rid: int,
                     exclude: Tuple[int, ...] = (),
                     generation: Optional[int] = None,
                     split: Optional[int] = None,
                     require_flags: int = 0
                     ) -> Optional[_WorkerConn]:
        """The live worker to answer partition `pid`: the routed replica's
        own when live, else the lowest-rid live sibling not in `exclude`.
        A worker serving another `generation`, or (elastic) another acked
        `split`, is not eligible, nor a draining one, nor one without the
        `require_flags` capabilities (a filtered scatter needs
        FLAG_FILTERS): its slice then serves locally. The breaker is asked
        last, since a half-open breaker's allow() takes its one probe."""
        with self._lock:
            cands = [(rid, w) for (p, rid), w in self._workers.items()
                     if p == pid and rid not in exclude]
        cands.sort(key=lambda t: (t[0] != prefer_rid, t[0]))
        age = self._alive_age_s()
        for _, w in cands:
            if w.alive(age) and not w.draining \
                    and (w.flags & require_flags) == require_flags \
                    and (generation is None
                         or w.generation == generation) \
                    and (split is None or w.split == split) \
                    and self._breaker_allow(pid, w.replica):
                return w
        return None

    # -- the RPC fan-out ------------------------------------------------------
    def _prepare(self, qv, n: int) -> Tuple[bytes, int, int]:
        """The scatter's one encode: the query block's bytes, built once a
        bucket (one copy off the card) and shared by every partition's send
        and every hedge or failover. -> (block bytes, n, dim)."""
        block = _host_block(qv, n)
        return block.tobytes(), n, block.shape[1]

    def _send(self, worker: _WorkerConn, prep: Tuple[bytes, int, int],
              k: int, nprobe: Optional[int],
              deadline: Optional[float],
              ftext: Optional[str] = None) -> Future:
        svc = self._svc
        block, n, dim = prep
        req_id = transport.next_request_id()
        rem_ms = 0.0
        if deadline is not None:
            rem_ms = max((deadline - svc._clock()) * 1000.0, 0.001)
        head = transport._VQUERY_HEAD.pack(req_id, rem_ms, int(k),
                                           int(nprobe or 0), n, dim)
        # the predicate rides each request after the block, never interned
        tail = transport._filters_field(ftext)
        fut: Future = Future()
        with self._lock:
            self._pending[req_id] = (fut, worker)
            self._rpcs += 1
            pid = worker.partition
            self._rpcs_by_pid[pid] = self._rpcs_by_pid.get(pid, 0) + 1
        try:
            with worker.wlock:
                if worker.flags & FLAG_WIRE_COMPRESS:
                    # the block ships once a connection slot; a repeat
                    # costs a 2-byte reference
                    slot, fresh = worker.intern.slot_for(block)
                    slot_b = transport._SLOT.pack(slot)
                    raw = (transport.HEADER.size + len(head) + len(block)
                           + len(tail))
                    if fresh:
                        worker.sender.send(T_VQUERY_PUT, head, slot_b,
                                           block, tail,
                                           counter=svc._m_wire_bytes,
                                           raw_counter=svc._m_wire_raw,
                                           raw_len=raw)
                    else:
                        worker.sender.send(T_VQUERY_REF, head, slot_b,
                                           tail,
                                           counter=svc._m_wire_bytes,
                                           raw_counter=svc._m_wire_raw,
                                           raw_len=raw)
                else:
                    worker.sender.send(T_VQUERY, head, block, tail,
                                       counter=svc._m_wire_bytes,
                                       raw_counter=svc._m_wire_raw)
        except OSError as e:
            # popping the entry claims the right to complete the future
            # (the reader's _fail_inflight races us for it)
            with self._lock:
                claimed = self._pending.pop(req_id, None) is not None
            if worker.mark_dead(f"send failed: {e}"):
                self._fail_inflight(worker, f"send failed: {e}")
                svc.registry.event("worker_lost", {
                    "partition": worker.partition,
                    "replica": worker.replica,
                    "reason": f"send failed: {e}"[:200]})
            if claimed:
                fut.set_exception(RemoteError(f"send failed: {e}"))
        return fut

    def _hedge_delay_s(self, pid: int) -> Optional[float]:
        """The wait before hedging partition `pid`: the hedge quantile of
        its observed RPC latency, or None while fewer than 8 samples."""
        q = self.hedge_quantile
        if not 0.0 < q < 1.0:
            return None
        with self._lock:
            lat = self._lat.get(pid)
            if lat is None or len(lat) < 8:
                return None
            return max(lat.percentile_ms(q * 100.0) / 1000.0, 1e-4)

    def _record_latency(self, pid: int, seconds: float) -> None:
        with self._lock:
            lat = self._lat.get(pid)
            if lat is None:
                lat = self._lat[pid] = LatencyStats()
            lat.add(seconds)

    def _await_partition(self, pid: int, prefer_rid: int, first: Future,
                         first_rid: int, prep: Tuple[bytes, int, int],
                         k: int, nprobe: Optional[int],
                         deadline: Optional[float],
                         generation: Optional[int] = None,
                         split: Optional[int] = None,
                         ftext: Optional[str] = None
                         ) -> Optional[Tuple]:
        """Partition `pid`'s answer: hedged to a sibling at the quantile
        point, failed over when its worker is lost; None when every wire
        route failed (the caller serves the slice locally)."""
        svc = self._svc
        t0 = time.perf_counter()
        budget = self.rpc_timeout_s
        if deadline is not None:
            budget = min(budget, max(deadline - svc._clock(), 0.0))
        in_flight: Dict[Future, int] = {first: first_rid}
        tried = {first_rid}
        hedged = False
        need = FLAG_FILTERS if ftext else 0
        while True:
            elapsed = time.perf_counter() - t0
            remaining = budget - elapsed
            hedge_s = None if hedged else self._hedge_delay_s(pid)
            if hedge_s is not None and elapsed < hedge_s:
                timeout = min(hedge_s - elapsed, max(remaining, 0.0))
            else:
                timeout = max(remaining, 0.0)
            done, _ = futures_wait(set(in_flight), timeout=timeout,
                                   return_when=FIRST_COMPLETED)
            for fut in done:
                rid = in_flight.pop(fut)
                exc = fut.exception()
                if isinstance(exc, RemoteError):
                    # a wire failure feeds the breaker; a shed does not
                    self._breaker_result(pid, rid, ok=False)
                if exc is None:
                    self._breaker_result(pid, rid, ok=True)
                    if not hedged:
                        # only unhedged calls feed the history: a hedged
                        # one is slow by definition and would drag the
                        # quantile up until hedging turned itself off
                        self._record_latency(pid,
                                             time.perf_counter() - t0)
                    return fut.result()
                tried.add(rid)
            elapsed = time.perf_counter() - t0
            if elapsed >= budget and not in_flight:
                return None
            if not in_flight:
                # every request sent failed: fail over to an untried live
                # sibling (not a hedge: the first copy is gone)
                w = self._pick_worker(pid, prefer_rid, exclude=tuple(tried),
                                      generation=generation, split=split,
                                      require_flags=need)
                if w is None:
                    return None
                in_flight[self._send(w, prep, k, nprobe, deadline,
                                     ftext)] = w.replica
                tried.add(w.replica)
                continue
            if elapsed >= budget:
                return None
            if (not hedged and hedge_s is not None
                    and elapsed >= hedge_s):
                hedged = True
                w = self._pick_worker(pid, prefer_rid, exclude=tuple(tried),
                                      generation=generation, split=split,
                                      require_flags=need)
                if w is not None:
                    svc._m_hedge_fired.inc()
                    cur = svc.tracer.current()
                    svc.registry.event("hedge_fired", {
                        "partition": pid, "from_replica": first_rid,
                        "to_replica": w.replica,
                        "after_ms": round(elapsed * 1000.0, 3),
                    }, trace_id=getattr(cur, "trace_id", None))
                    in_flight[self._send(w, prep, k, nprobe, deadline,
                                         ftext)] = w.replica
                    tried.add(w.replica)

    def topk(self, qv, n: int, k: int, nprobe: Optional[int] = None,
             deadline: Optional[float] = None,
             predicate=None) -> Tuple[np.ndarray, np.ndarray]:
        """The scatter-gather over the wire: one routed worker RPC a
        partition (hedged, within the deadline), the partition's slice
        served locally on any wire failure, the winners folded through the
        in-process scatter's merge tree, so the results are
        ``PartitionSet.topk``'s by construction. With `predicate` its
        canonical text rides each RPC, routing keeps to FLAG_FILTERS
        workers, and a local slice runs the same filtered search."""
        svc = self._svc
        pset = self.partition_set
        ftext = predicate.text if predicate is not None else None
        need = FLAG_FILTERS if ftext else 0
        # ONE table snapshot for the whole scatter: its width is the split
        # every decision below is gated on, so a re-split published
        # meanwhile cannot mix cuts in one result set
        table = pset.table()
        P = len(table)
        split = P if self._elastic else None
        ready = pset._ready()
        prep = self._prepare(qv, n)
        calls: List[Tuple[int, object, Optional[Future], int]] = []
        with svc._stage("scatter", partitions=P, transport="socket"):
            for pid in range(P):
                rep = pset._route(pid)
                gen = table[pid][rep.rid].generation
                w = self._pick_worker(pid, rep.rid, generation=gen,
                                      split=split, require_flags=need)
                if w is None:
                    calls.append((pid, rep, None, -1))
                else:
                    calls.append((pid, rep,
                                  self._send(w, prep, k, nprobe, deadline,
                                             ftext),
                                  w.replica))
            parts: List[Optional[Tuple]] = [None] * P
            for pid, rep, fut, rid in calls:
                res = None
                if fut is not None:
                    with svc._stage("rpc", partition=pid, replica=rid):
                        res = self._await_partition(
                            pid, rep.rid, fut, rid, prep, k, nprobe,
                            deadline,
                            generation=table[pid][rep.rid].generation,
                            split=split, ftext=ftext)
                if res is None:
                    # the in-process path for this slice, on the front
                    # end's own view and the replica's stream
                    if fut is not None:
                        with self._lock:
                            self._rpc_fallbacks += 1
                    view = table[pid][rep.rid]
                    res, _ = rep.run_inline(
                        lambda v=view: svc._topk_view(
                            v, qv, n, k, nprobe, predicate=predicate),
                        ready)
                parts[pid] = res
        with svc._stage("merge"):
            return merge_partition_topk([(s, i) for s, i, _ in parts])

    # -- store generations ----------------------------------------------------
    def broadcast_refresh(self, generation: int, wait_s: float = 0.0,
                          split: Optional[int] = None,
                          refresh_own: bool = True) -> Dict:
        """Tell every live worker to re-open the store and rebuild its view
        (T_REFRESH with the target generation and, elastic, the split
        width): the wire fleet's half of ``SearchService.refresh()``, no
        worker restart. Until a worker acks, routing treats it as stale
        and its slice serves from the front end's view. `wait_s` > 0
        blocks that long for every ack. `split` defaults to the routed
        table's width when elastic, 0 (keep the cut) otherwise;
        `refresh_own=False` skips the private set's rebuild when the
        caller already did it."""
        svc = self._svc
        if self._own_pset is not None and refresh_own:
            # the gateway's private 1-partition set follows the store too,
            # or its fallback views would serve the old generation
            self._own_pset.refresh(svc.store)
        if split is None:
            split = len(self.partition_set.table()) if self._elastic else 0
        with self._lock:
            workers = list(self._workers.values())
        age = self._alive_age_s()
        told = 0
        for w in workers:
            if not w.alive(age) or (w.generation == generation
                                    and (split <= 0 or w.split == split)):
                continue
            try:
                self._send_control(w, T_REFRESH,
                                   transport.encode_refresh(generation,
                                                            split))
                told += 1
            except OSError:
                pass              # a dying worker re-registers fresh
        if wait_s > 0:
            self.wait_for_generation(generation, timeout_s=wait_s,
                                     split=split)
        return {"workers_told": told,
                "workers_stale": self.stale_workers(generation,
                                                    split=split)}

    def stale_workers(self, generation: int, split: int = 0) -> int:
        """Live workers whose view serves another generation (or, with
        `split` > 0, another split width)."""
        with self._lock:
            workers = list(self._workers.values())
        age = self._alive_age_s()
        return sum(1 for w in workers
                   if w.alive(age) and (w.generation != generation
                                        or (split > 0
                                            and w.split != split)))

    def wait_for_generation(self, generation: int,
                            timeout_s: float = 30.0,
                            split: int = 0) -> bool:
        """Block until no live worker lags `generation` (and `split` when
        > 0); False on timeout, after recording the wait and the stale
        count (`gateway_wait_timeout`, stats()'s wait_timeouts)."""
        t0 = time.perf_counter()
        t_end = t0 + timeout_s
        while time.perf_counter() < t_end:
            if self.stale_workers(generation, split=split) == 0:
                return True
            time.sleep(0.01)
        stale = self.stale_workers(generation, split=split)
        if stale == 0:
            return True
        self._note_wait_timeout(
            "generation", time.perf_counter() - t0, timeout_s,
            generation=int(generation), split=int(split), stale=stale,
            live=len(self.live_workers()))
        return False

    # -- elastic membership ---------------------------------------------------
    def _fleet_width(self) -> Optional[int]:
        """The split width the live fleet implies: one slice a distinct
        live, non-draining partition index, when those are exactly
        {0..W-1}. Membership changes at the tail; a gap (a crash mid-fleet)
        gives None and the split stays (recovery is rejoin and the local
        fallback, never a re-cut under a hole)."""
        with self._lock:
            workers = list(self._workers.values())
        age = self._alive_age_s()
        pids = {w.partition for w in workers
                if w.alive(age) and not w.draining}
        if not pids:
            return None
        width = max(pids) + 1
        if pids != set(range(width)):
            return None
        return width

    def _maybe_resplit(self, trigger: str) -> Optional[Dict]:
        """Re-cut the split if the live fleet's width moved (elastic only)."""
        if not self._elastic:
            return None
        width = self._fleet_width()
        if width is None:
            return None
        with self._resplit_lock:
            if width != len(self.partition_set.table()):
                return self._resplit(width, trigger)
        return None

    # holds-lock: _resplit_lock
    def _resplit(self, width: int, trigger: str) -> Dict:
        """The elastic re-cut: the front end's table rebuilt over `width`
        partitions (deterministic, so every front end of the fleet cuts
        alike) under the service's refresh lock and published with one
        assignment, then the generation and split broadcast. Split gating
        keeps each worker unroutable until it acks the new width."""
        svc = self._svc
        pset = self.partition_set
        old = len(pset.table())
        with svc._refresh_lock:
            pset.resize(svc.store, width)
        generation = self._routed_generation(0)
        info = self.broadcast_refresh(generation, split=width,
                                      refresh_own=False)
        with self._lock:
            self._resplits += 1
        svc.registry.event("fleet_resplit", {
            "trigger": trigger, "from_partitions": old,
            "to_partitions": width, "generation": generation,
            "workers_told": info["workers_told"]})
        return dict(info, partitions=width)

    # -- telemetry and lifecycle ----------------------------------------------
    def stats(self) -> Dict:
        """The metrics() and loadtest transport block."""
        with self._lock:
            registered = self._registered
            rpcs = self._rpcs
            by_pid = dict(self._rpcs_by_pid)
            fallbacks = self._rpc_fallbacks
            resplits = self._resplits
            wait_timeouts = self._wait_timeouts
            workers = list(self._workers.values())
            breakers = list(self._breakers.values())
        live = [w for w in workers if not w.dead]
        return {
            "workers_live": len(self.live_workers()),
            "workers_registered": registered,
            "workers_compressing": sum(1 for w in live
                                       if w.flags & FLAG_WIRE_COMPRESS),
            "workers_filtering": sum(1 for w in live
                                     if w.flags & FLAG_FILTERS),
            "workers_draining": sum(1 for w in live if w.draining),
            "rpcs": rpcs,
            # the RPCs sent to each partition's workers (hedges included)
            "rpcs_by_partition": [by_pid.get(p, 0)
                                  for p in range(max(by_pid, default=-1)
                                                 + 1)],
            "rpc_fallbacks": fallbacks,
            "resplits": resplits,
            "wait_timeouts": wait_timeouts,
            "breakers_open": sum(1 for b in breakers if b.state == "open"),
            "breaker_trips": sum(b.trips for b in breakers),
        }

    def close(self) -> None:
        """Stop accepting, send every live worker a clean BYE (a worker
        that had one does not re-dial), close the connections and join the
        reader threads."""
        with self._lock:
            self._closed = True
            workers = list(self._workers.values())
            threads = list(self._threads)
        # shutdown wakes the accept() blocked on the listener (a bare close
        # from another thread does not)
        transport._close_quietly(self._sock)
        for w in workers:
            if not w.dead:
                try:
                    with w.wlock:
                        w.sender.send(T_BYE)
                except OSError:
                    pass
            w.mark_dead("gateway closed")
            try:
                w.sock.close()
            except OSError:
                pass
        self._accept_t.join(timeout=5.0)
        for t in threads:
            t.join(timeout=5.0)
        if self._own_pset is not None:
            self._own_pset.close()


# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------

class _GatewayLink:
    """One worker -> gateway connection's session state. A worker serving
    N front ends runs one link an endpoint, each with its own socket,
    sender, agreed flags, intern slots, block cache, heartbeat thread and
    re-dial loop, all serving the worker's one view."""

    def __init__(self, connect: Tuple[str, int], index: int):
        self.connect = (connect[0], int(connect[1]))
        self.index = int(index)
        self.sock: Optional[socket.socket] = None
        self.send_lock = threading.Lock()  # serializes frame writes
        self.sender: Optional[FrameSender] = None  # guarded-by: send_lock
        # agreed per connection; read and written on this link's loop only
        self.flags = 0
        # the block cache: (block bytes, k, nprobe, filters) -> (view,
        # scores, ids, scan). A hit replays only when its view IS the
        # request's view object, so a refresh or re-split makes every old
        # entry unreachable without clearing across threads
        self.block_cache: OrderedDict = OrderedDict()
        self.sessions = 0   # completed dial + REGISTER rounds


class PartitionWorker:
    """One partition replica serving its slice over a socket: as a process
    (``cli partition-worker``) or, in tests, a thread with a service of its
    own. Its view is built by the ``_build_view`` the in-process replicas
    use, on `device` (None: the card, or raise without one).

    `connect` may list several gateways: the worker registers with each and
    answers each over its own link, all from one view. T_REFRESH from any
    gateway re-cuts or re-opens that view (a second front end's broadcast
    for the state already served just acks), so N front ends converge on
    one split without talking to each other."""

    def __init__(self, cfg, store_dir: str, connect,
                 partition: int, partitions: int, replica: int = 0,
                 device=None, preload_hbm_gb: float = 4.0,
                 heartbeat_s: Optional[float] = None,
                 slow_ms: float = 0.0):
        from dnn_page_vectors_tpu_torch.infer.serve import SearchService
        from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
        self.partition = int(partition)
        self.partitions = int(partitions)
        self.replica = int(replica)
        if connect and isinstance(connect[0], (list, tuple)):
            endpoints = [(h, int(p)) for h, p in connect]
        else:
            endpoints = [(connect[0], int(connect[1]))]
        self.connect = endpoints[0]
        self._links = [_GatewayLink(ep, i)
                       for i, ep in enumerate(endpoints)]
        serve = cfg.serve
        self.heartbeat_s = float(heartbeat_s if heartbeat_s is not None
                                 else serve.heartbeat_s)
        # capabilities are advertised at REGISTER and used only once the
        # gateway confirms them
        self.wire_compress = bool(serve.wire_compress)
        self.result_cache = bool(serve.result_cache
                                 and serve.result_cache_fleet)
        self.filters = bool(serve.filters)
        self._block_cache_cap = 64
        # a deliberately slow replica (per-request added latency, ms):
        # the hedging drills' hook
        self.slow_ms = float(slow_ms)
        # the worker's service answers exactly one slice: single-partition,
        # so no nested scatter
        cfg1 = dataclasses.replace(cfg, serve=dataclasses.replace(
            serve, partitions=1, replicas=1))
        embedder = DeviceEmbedder(device)    # the card, or raise first
        store = VectorStore(store_dir)
        self.svc = SearchService(cfg1, embedder, None, store,
                                 preload_hbm_gb=0.0)
        self.svc._preload_gb = preload_hbm_gb
        if self.partition >= self.partitions:
            raise ValueError(
                f"partition {self.partition} does not exist: this worker "
                f"was asked for a {self.partitions}-way split")
        self.spec = self._spec(store, self.partitions)
        self.view = self.svc._build_view(store,
                                         entries=list(self.spec.entries),
                                         hot_gb=self.spec.hot_gb)
        self._answered = 0                 # guarded-by: _count_lock
        self._count_lock = threading.Lock()
        self._stop = threading.Event()
        # orders view rebuilds (T_REFRESH can arrive on N links at once);
        # the swap itself is one reference assignment a field
        # lock-order: PartitionWorker._swap_lock < _GatewayLink.send_lock
        self._swap_lock = threading.Lock()
        self.reconnect = bool(serve.reconnect)
        self.reconnect_base_s = float(serve.reconnect_base_s)
        self.reconnect_max_s = float(serve.reconnect_max_s)
        # seeded per replica: deterministic under test, decorrelated across
        # a fleet restarting together
        self._rng = random.Random(1 + (self.partition << 8) | self.replica)

    def _spec(self, store, width: int):
        from dnn_page_vectors_tpu_torch.infer.partition import (
            PartitionSpec, make_partition_specs)
        specs = make_partition_specs(
            store.shards(), width, hot_gb=self.svc.cfg.serve.hot_postings_gb)
        if self.partition < len(specs):
            return specs[self.partition]
        # the balanced split clamps below the width (more workers than
        # shards): an empty slice serves nothing until a re-split
        return PartitionSpec(pid=self.partition, entries=(),
                             shard_indices=(), rows=0, hot_gb=0.0)

    @property
    def sessions(self) -> int:
        """Completed dial + REGISTER rounds over every gateway link."""
        return sum(ln.sessions for ln in self._links)

    @property
    def answered(self) -> int:
        """Vector RPCs answered (results, sheds and errors)."""
        with self._count_lock:
            return self._answered

    # -- lifecycle ----------------------------------------------------------
    def _heartbeat_loop(self, link: _GatewayLink) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                with link.send_lock:
                    if link.sender is None:
                        return    # between sessions
                    link.sender.send(T_HEARTBEAT)
            except OSError:
                return

    def run(self) -> None:
        """Dial, REGISTER and serve on every link; a link that loses its
        gateway (EOF, a torn frame, a socket error) re-dials with
        exponential backoff and jitter and re-registers with the current
        generation. A link ends on its gateway's clean T_BYE, on stop(),
        or with serve.reconnect off at its first loss; run() returns when
        every link has ended. Blocking: the process entry point."""
        extra = [threading.Thread(target=self._run_link, args=(ln,),
                                  daemon=True,
                                  name=f"worker-p{self.partition}"
                                       f"r{self.replica}-g{ln.index}")
                 for ln in self._links[1:]]
        for t in extra:
            t.start()
        self._run_link(self._links[0])
        for t in extra:
            t.join()

    def _run_link(self, link: _GatewayLink) -> None:
        failures = 0
        while not self._stop.is_set():
            try:
                if self._serve_session(link):
                    break         # a clean T_BYE: deregistered on purpose
                failures = 0      # a registered session resets the ramp
            except (FrameError, OSError):
                failures += 1     # the gateway is unreachable or torn
            if not self.reconnect or self._stop.is_set():
                break
            delay = min(self.reconnect_base_s * (2.0 ** max(failures - 1,
                                                            0)),
                        self.reconnect_max_s)
            delay += self._rng.uniform(0.0, delay / 2.0)
            faults.count("worker_reconnect")
            if self._stop.wait(delay):
                break

    def _flags(self) -> int:
        return ((FLAG_WIRE_COMPRESS if self.wire_compress else 0)
                | (FLAG_RESULT_CACHE if self.result_cache else 0)
                | (FLAG_FILTERS if self.filters else 0))

    def _dial(self, link: _GatewayLink) -> socket.socket:
        """Dial and REGISTER under the wire retry profile (idempotent: a
        re-REGISTER replaces the previous registration), with the current
        view's generation."""
        def _connect() -> socket.socket:
            faults.active().check("worker_dial")
            sock = socket.create_connection(link.connect)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                transport.write_frame(
                    sock, T_REGISTER, transport.encode_register(
                        self.partition, self.replica, os.getpid(),
                        flags=self._flags(),
                        generation=self.view.generation))
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
                raise
            return sock
        return faults.retry_wire(_connect, op="worker_dial",
                                 backoff=self.reconnect_base_s,
                                 max_backoff=self.reconnect_max_s)

    def _serve_session(self, link: _GatewayLink) -> bool:
        """One dial + REGISTER + serve round on `link`: True on a clean
        T_BYE, False on EOF at a frame boundary (the loop re-dials); torn
        frames and socket errors go to the loop's backoff."""
        sock = self._dial(link)
        hb: Optional[threading.Thread] = None
        slots: Dict[int, bytes] = {}   # the connection's intern slots
        bye = False
        try:
            link.sock = sock
            link.sessions += 1
            link.flags = 0             # agreed again on each connection
            with link.send_lock:
                link.sender = FrameSender(sock)
            hb = threading.Thread(target=self._heartbeat_loop,
                                  args=(link,), daemon=True,
                                  name=f"worker-p{self.partition}"
                                       f"r{self.replica}-g{link.index}-hb")
            hb.start()
            while not self._stop.is_set():
                frame = transport.read_frame(sock)
                if frame is None:
                    break
                ftype, payload = frame
                if ftype in (T_VQUERY, T_VQUERY_PUT, T_VQUERY_REF):
                    self._answer(link, ftype, payload, slots)
                elif ftype == T_HELLO:
                    link.flags = transport.decode_hello(payload)
                elif ftype == T_REFRESH:
                    gen, parts = transport.decode_refresh(payload)
                    self._refresh(link, gen, parts)
                elif ftype == T_BYE:
                    bye = True
                    break
                # any other control frame from the gateway is ignored
        finally:
            # close first: the heartbeat's next send fails fast
            try:
                sock.close()
            except OSError:
                pass
            with link.send_lock:
                link.sender = None
            if hb is not None:
                hb.join(timeout=self.heartbeat_s + 2.0)
        return bye

    def _refresh(self, link: _GatewayLink, generation: int,
                 partitions: int = 0) -> None:
        """T_REFRESH: re-open the store, rebuild this replica's view over
        the split (re-cut over `partitions` when the frame carries a
        width), swap it in with one assignment and ack the (generation,
        width) now served. A refresh for the state already served just
        acks. A rebuild that fails keeps the old view serving (the gateway
        routes around its generation)."""
        from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
        with self._swap_lock:
            width = int(partitions) if partitions > 0 else self.partitions
            try:
                if (width != self.partitions
                        or self.view.generation != int(generation)):
                    new_store = VectorStore(self.svc.store.directory)
                    spec = self._spec(new_store, width)
                    view = self.svc._build_view(new_store, reuse=self.view,
                                                entries=list(spec.entries),
                                                hot_gb=spec.hot_gb)
                    if (view.pages is not None
                            and view.pages.device.type == "cuda"):
                        # the copies land before the view serves
                        torch.cuda.synchronize(view.pages.device)
                    self.spec = spec
                    self.view = view   # THE swap: one assignment
                    self.partitions = width
                    self.svc.store = new_store
                    link.block_cache.clear()
            except Exception as e:  # noqa: BLE001 -- the old view serves
                # on, and its generation keeps the gateway routing around it
                faults.warn(f"partition worker p{self.partition}"
                            f"r{self.replica}: the refresh to generation "
                            f"{generation} (width {width}) failed: "
                            f"{type(e).__name__}: {e}")
            try:
                with link.send_lock:
                    link.sender.send(T_REFRESH, transport.encode_refresh(
                        self.view.generation, self.partitions))
            except (OSError, AttributeError):
                pass              # the session ended meanwhile

    def _answer(self, link: _GatewayLink, ftype: int, payload: bytes,
                slots: Dict[int, bytes]) -> None:
        req = transport.decode_vquery_any(ftype, payload, slots)
        t0 = time.perf_counter()
        parts: Tuple
        try:
            if self.slow_ms > 0:
                time.sleep(self.slow_ms / 1000.0)
            k = req.k or self.svc.cfg.eval.recall_k
            pred = compile_filters(req.filters)
            # one view answers the request: the compute, the cache check
            # and its fill all read this snapshot
            view = self.view
            ckey = None
            hit = None
            if link.flags & FLAG_RESULT_CACHE:
                ckey = (req.qv.tobytes(), k, int(req.nprobe or 0),
                        req.filters or "")
                hit = link.block_cache.get(ckey)
                if hit is not None and hit[0] is view:
                    link.block_cache.move_to_end(ckey)
                else:
                    hit = None
            if hit is not None:
                _, scores, ids, scan = hit
            else:
                scores, ids, scan = self.svc._topk_view(
                    view, req.qv, req.qv.shape[0], k,
                    req.nprobe or None, predicate=pred)
                if ckey is not None:
                    link.block_cache[ckey] = (view, scores, ids, scan)
                    while len(link.block_cache) > self._block_cache_cap:
                        link.block_cache.popitem(last=False)
            if req.deadline_ms > 0 and \
                    (time.perf_counter() - t0) * 1000.0 > req.deadline_ms:
                # the budget ran out during the compute: the gateway has
                # already served the slice itself
                rtype = T_SHED
                parts = (transport.encode_shed(
                    req.req_id, transport.SHED_DEADLINE,
                    "deadline expired during partition compute"),)
            elif link.flags & FLAG_WIRE_COMPRESS:
                rtype = T_RESULT_C
                parts = (transport.encode_result_c(req.req_id, scores,
                                                   ids, scan_bytes=scan),)
            else:
                rtype = T_RESULT
                scores = np.ascontiguousarray(scores, dtype="<f4")
                ids = np.ascontiguousarray(ids, dtype="<i8")
                parts = (transport._RESULT_HEAD.pack(
                    req.req_id, int(scan), *scores.shape), scores, ids)
        except Exception as e:  # noqa: BLE001 -- the request fails, the
            # worker serves on
            rtype = T_ERROR
            parts = (transport.encode_error(req.req_id,
                                            f"{type(e).__name__}: {e}"),)
        with self._count_lock:
            self._answered += 1
        with link.send_lock:
            link.sender.send(rtype, *parts)

    @staticmethod
    def _tear(sock: Optional[socket.socket]) -> None:
        """shutdown + close: a bare close() does not wake the serve loop's
        blocked recv; shutdown() tears the stream now, as a dying process
        would."""
        if sock is None:
            return
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def stop(self) -> None:
        """Abrupt local shutdown (the tests' kill -9): tear every link's
        socket out from under its serve loop."""
        self._stop.set()
        for ln in self._links:
            self._tear(ln.sock)

    def kill_connection(self) -> None:
        """Tear every live connection without stopping the worker: the
        links re-dial and re-register (the reconnect drills' hook)."""
        for ln in self._links:
            self._tear(ln.sock)

    def drain(self, wait_s: Optional[float] = None) -> None:
        """Graceful exit: T_DRAIN on every link (each gateway stops routing
        this worker new work, and an elastic front end narrows the split
        around a drained tail index), a wait of `wait_s` (default one
        heartbeat) for the answers in flight, then BYE and stop. No request
        is ever in flight to a worker that has gone."""
        for ln in self._links:
            try:
                with ln.send_lock:
                    if ln.sender is not None:
                        ln.sender.send(T_DRAIN)
            except OSError:
                pass              # that gateway already lost us
        time.sleep(self.heartbeat_s if wait_s is None else float(wait_s))
        for ln in self._links:
            try:
                with ln.send_lock:
                    if ln.sender is not None:
                        ln.sender.send(T_BYE)
            except OSError:
                pass
        self.stop()


def run_partition_worker(cfg, store_dir: str, connect: str, partition: int,
                         partitions: int, replica: int = 0, device=None,
                         preload_hbm_gb: float = 4.0) -> Dict:
    """The ``cli partition-worker`` entry: build the worker (the store, its
    view on `device`, no model or checkpoint), print one ready line, serve
    until every gateway says BYE (SIGTERM drains: T_DRAIN, the answers in
    flight, then BYE), then print one exit line with the flash-attention
    launch counters, which a worker never moves. `connect` is one
    ``host:port`` or a comma-separated list for a worker shared by N front
    ends. The environment's DPV_WORKER_SLOW_MS adds that much latency to
    every answer (the hedging drills). Returns the exit line."""
    import signal

    from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
    endpoints = []
    for one in connect.split(","):
        host, _, port = one.strip().rpartition(":")
        endpoints.append((host or "127.0.0.1", int(port)))
    slow = float(os.environ.get("DPV_WORKER_SLOW_MS", "0") or 0.0)
    worker = PartitionWorker(cfg, store_dir, endpoints,
                             partition=partition, partitions=partitions,
                             replica=replica, device=device,
                             preload_hbm_gb=preload_hbm_gb, slow_ms=slow)
    view = worker.view
    print(json.dumps({
        "partition_worker": worker.partition,
        "partitions": worker.partitions,
        "replica": worker.replica,
        "gateways": len(endpoints),
        "shards": list(worker.spec.shard_indices),
        "rows": worker.spec.rows,
        "pid": os.getpid(),
        "device": str(worker.svc.embedder.device),
        "staged_bytes": (int(view.pages.numel() * view.pages.element_size())
                         if view.pages is not None else 0),
        "staged_device": (str(view.pages.device)
                          if view.pages is not None else None),
    }, sort_keys=True), flush=True)
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=worker.drain, daemon=True).start())
    worker.run()
    out = {"partition_worker_exit": worker.partition,
           "replica": worker.replica, "pid": os.getpid(),
           "answered": worker.answered, "sessions": worker.sessions,
           "kernel_launches": {name: getattr(fa, name)
                               for name in fa.COUNTERS}}
    print(json.dumps(out, sort_keys=True), flush=True)
    return out
