"""Deterministic fault injection and transient-I/O retry, the port's copy
of the JAX package's utils/faults.py (same plan syntax, op names, counter
names and retry policy, so one plan string and seed fire the same schedule
in both packages).

  * ``FaultPlan``: a SEEDED schedule of injected faults (``IOError``, file
    truncation, bit flips, delays) keyed on named operations. Code calls
    ``active().check(op)`` before an I/O operation and
    ``active().corrupt(op, path)`` after a file lands on disk; with no
    plan installed both are near-free no-ops.
  * ``retry(fn, ...)``: exponential backoff with jitter for transient I/O.
    A transient fault costs a retry; a persistent one re-raises the
    original exception at the original call site.
  * module-level COUNTERS: every injected fault, retry, quarantine and
    maintenance error bumps a named counter (``counters()``), mirrored
    into the default metrics registry as ``fault.<event>``.

The port's injection points:
  shard_write        a shard's data-file write (check; inside retry)
  shard_file         the shard .vec.npy after fsync (corrupt)
  shard_read         a shard load (check)
  manifest_dump      the main manifest's atomic dump (check; inside retry)
  manifest_file      its tmp file before the rename (corrupt)
  gen_manifest_dump / gen_manifest_file   a generation manifest's dump
  compact_write      a compacted shard's write (check)
  compact_swap_dump / compact_swap_file   the compaction's manifest flip
  index_swap_dump / index_swap_file       the background rebuild's
                     index-dir pointer flip
  bg_rebuild         the start of a background index rebuild (check)
  migrate_write      a re-embedded shard's write during a rolling model
                     migration (check)
  migrate_swap_dump / migrate_swap_file   a migration unit's flip

The wire ops and their kinds are scheduled here as in the JAX package
(``wire``); the fleet's transport acts on them:
  wire_send          a framed send (infer/transport.py: ``write_frame``,
                     ``FrameSender.send``)
  wire_recv          a framed read (``read_frame``, ``read_frame_async``)
  worker_dial        a partition worker's dial + REGISTER (check; inside
                     ``retry_wire``)
  gateway_accept     the worker gateway's accept of a dial
  cache_peer_send    a front end's result-cache probe or share to a peer
A worker's re-dial counts in ``worker_reconnect``; a cache peer's breaker
that opens, in ``cache_peer_breaker_open``.

Plan syntax: "op:kind:at[:count]" joined by commas; `at` is the 0-based
index of the matching call that first faults, `count` how many
consecutive calls fault (default 1 = transient; `*` = persistent).
Filesystem kinds: io_error, truncate, bit_flip, delay. Wire kinds:
conn_drop, frame_delay, frame_trunc, frame_dup. Example, the second shard
write fails once: "shard_write:io_error:1".
"""
from __future__ import annotations

import dataclasses
import os
import random
import sys
import threading
import time
from typing import Dict, List, Optional

WIRE_KINDS = ("conn_drop", "frame_delay", "frame_trunc", "frame_dup")
KINDS = ("io_error", "truncate", "bit_flip", "delay") + WIRE_KINDS
PERSISTENT = 1_000_000          # `count` spelling of "every call from `at`"


class InjectedFault(IOError):
    """An injected I/O failure. Subclasses IOError/OSError so production
    retry/except paths treat it exactly like a real transient I/O error —
    the injection layer must never need special-casing in recovery code."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    op: str
    kind: str
    at: int = 0          # 0-based index of the first faulted call
    count: int = 1       # consecutive calls faulted from `at`

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; have {KINDS}")
        if self.at < 0 or self.count < 1:
            raise ValueError(f"bad fault schedule at={self.at} "
                             f"count={self.count}")


class FaultPlan:
    """A seeded, scheduled set of faults. Thread-safe: the bulk-embed
    writer thread and tokenizer workers share one plan with the main
    thread. Deterministic: per-op call counters + one seeded RNG decide
    exactly which call faults and which byte/bit a corruption touches."""

    def __init__(self, specs: List[FaultSpec] = (), seed: int = 0):
        self._specs = list(specs)
        self._rng = random.Random(seed)
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        specs = []
        for part in (text or "").split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) not in (2, 3, 4):
                raise ValueError(
                    f"bad fault spec {part!r} (want op:kind[:at[:count]])")
            op, kind = bits[0], bits[1]
            at = int(bits[2]) if len(bits) > 2 else 0
            count = (PERSISTENT if len(bits) > 3 and bits[3] in ("*", "inf")
                     else int(bits[3]) if len(bits) > 3 else 1)
            specs.append(FaultSpec(op=op, kind=kind, at=at, count=count))
        return cls(specs, seed=seed)

    def _fire(self, op: str, kinds: tuple) -> Optional[FaultSpec]:
        """Advance op's call counter; return the spec scheduled to fault
        THIS call (restricted to `kinds`), if any."""
        with self._lock:
            i = self._calls.get(op, 0)
            self._calls[op] = i + 1
            for s in self._specs:
                if (s.op == op and s.kind in kinds
                        and s.at <= i < s.at + s.count):
                    return s
        return None

    def pending(self, op: str) -> bool:
        """True while any spec for `op` has calls left to fault."""
        with self._lock:
            i = self._calls.get(op, 0)
            return any(s.op == op and i < s.at + s.count
                       for s in self._specs)

    # -- injection points --------------------------------------------------
    def check(self, op: str) -> None:
        """Call before an I/O / staging operation: raises InjectedFault or
        sleeps when a fault is scheduled for this call of `op`."""
        if not self._specs:
            return
        spec = self._fire(op, ("io_error", "delay"))
        if spec is None:
            return
        count(f"injected_{op}_{spec.kind}")
        if spec.kind == "delay":
            with self._lock:
                t = 0.01 + 0.04 * self._rng.random()
            time.sleep(t)
            return
        raise InjectedFault(f"injected fault: {op} "
                            f"(call {self._calls[op] - 1}, spec {spec})")

    def wire(self, op: str) -> Optional[FaultSpec]:
        """Call once per framed wire operation (`wire_send`, `wire_recv`,
        `gateway_accept`, ...): advances op's call counter and returns the
        spec scheduled to fault THIS call, if any. Unlike check(), the
        ACTION is the caller's job — only the transport call site holds the
        socket and the frame bytes needed to drop/truncate/duplicate, so
        this method just decides and accounts. io_error and delay specs on
        a wire op fire here too (an io_error behaves like conn_drop at call
        sites without a live socket, e.g. worker_dial)."""
        if not self._specs:
            return None
        spec = self._fire(op, ("io_error", "delay") + WIRE_KINDS)
        if spec is None:
            return None
        count(f"injected_{op}_{spec.kind}")
        return spec

    def wire_delay_s(self) -> float:
        """Seeded stall length for a frame_delay / delay wire spec."""
        with self._lock:
            return 0.01 + 0.04 * self._rng.random()

    def corrupt(self, op: str, path: str) -> bool:
        """Call after a file is durably on disk: applies a scheduled
        truncation / bit flip to it. Returns True when the file was
        damaged."""
        if not self._specs:
            return False
        spec = self._fire(op, ("truncate", "bit_flip"))
        if spec is None:
            return False
        self._damage(spec.kind, path)
        count(f"injected_{op}_{spec.kind}")
        return True

    def corrupt_dir(self, op: str, directory: str) -> bool:
        """Like corrupt(), applied to EVERY non-empty file under
        `directory` (recursively). Checkpoint formats keep redundant copies
        of array data (e.g. orbax OCDBT), so damaging one file can be
        silently absorbed; a corrupt-checkpoint injection must reliably
        break the restore or the rollback path under test never runs."""
        if not self._specs:
            return False
        spec = self._fire(op, ("truncate", "bit_flip"))
        if spec is None:
            return False
        hit = False
        for root, _, names in os.walk(directory):
            for n in sorted(names):
                p = os.path.join(root, n)
                try:
                    if os.path.getsize(p) > 0:
                        self._damage(spec.kind, p)
                        hit = True
                except OSError:
                    continue
        if hit:
            count(f"injected_{op}_{spec.kind}")
        return hit

    def _damage(self, kind: str, path: str) -> None:
        size = os.path.getsize(path)
        if kind == "truncate":
            with open(path, "r+b") as f:
                f.truncate(size // 2)
        else:                                       # bit_flip
            with self._lock:
                off = self._rng.randrange(max(size, 1))
                bit = self._rng.randrange(8)
            with open(path, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([(b[0] if b else 0) ^ (1 << bit)]))


_NULL_PLAN = FaultPlan()
_ACTIVE: FaultPlan = _NULL_PLAN


def install(plan: FaultPlan) -> FaultPlan:
    """Make `plan` the process-wide active plan (injection points are
    ambient: the store/checkpoint/serve layers must not need a plan handle
    threaded through every signature)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def install_from_config(cfg) -> Optional[FaultPlan]:
    """CLI entry: install cfg.faults.plan (when non-empty) and adopt the
    config's retry policy as the module default."""
    f = cfg.faults
    configure_retry(f.retry_attempts, f.retry_backoff_s, f.retry_jitter_s)
    if not f.plan:
        return None
    return install(FaultPlan.parse(f.plan, seed=f.seed))


def active() -> FaultPlan:
    return _ACTIVE


def reset() -> None:
    """Drop the active plan, counters, and retry overrides (test hygiene)."""
    global _ACTIVE, _RETRY
    _ACTIVE = _NULL_PLAN
    _RETRY = dict(_RETRY_DEFAULTS)
    with _COUNTER_LOCK:
        _COUNTERS.clear()


# -- fault counters ---------------------------------------------------------

_COUNTERS: Dict[str, int] = {}
_COUNTER_LOCK = threading.Lock()


def count(event: str, n: int = 1) -> None:
    with _COUNTER_LOCK:
        _COUNTERS[event] = _COUNTERS.get(event, 0) + n
    # mirrored into the process-wide metrics registry, so fault and
    # recovery activity shows in the same exposition as every other
    # instrument; `counters()` stays the dict the metrics lines read
    from dnn_page_vectors_tpu_torch.utils import telemetry
    telemetry.default_registry().counter(f"fault.{event}").inc(n)


def counters() -> Dict[str, int]:
    """Snapshot of every fault/recovery event this process has seen —
    injected_*, retry_*, quarantined_shards, ckpt_rollback, serve_*."""
    with _COUNTER_LOCK:
        return dict(sorted(_COUNTERS.items()))


def warn(msg: str) -> None:
    print(f"WARNING: {msg}", file=sys.stderr)


# -- transient-I/O retry ----------------------------------------------------

_RETRY_DEFAULTS = {"attempts": 3, "backoff": 0.05, "jitter": 0.02}
_RETRY = dict(_RETRY_DEFAULTS)


def configure_retry(attempts: int, backoff: float, jitter: float) -> None:
    _RETRY.update(attempts=max(1, int(attempts)), backoff=float(backoff),
                  jitter=float(jitter))


def retry(fn, op: str = "io", max_attempts: Optional[int] = None,
          backoff: Optional[float] = None, jitter: Optional[float] = None,
          retry_on: tuple = (OSError,), profiler=None,
          max_backoff: Optional[float] = None):
    """Run fn(); on a transient `retry_on` failure, back off (exponential +
    uniform jitter, capped at `max_backoff` when given) and re-run, up to
    `max_attempts` total attempts. The final failure re-raises the ORIGINAL
    exception — callers' except clauses and the resume bookkeeping see the
    same surface as without retry. Backoff sleep lands in `profiler` as
    stage `io_retry` when one is passed."""
    attempts = _RETRY["attempts"] if max_attempts is None else max_attempts
    base = _RETRY["backoff"] if backoff is None else backoff
    jit = _RETRY["jitter"] if jitter is None else jitter
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt + 1 >= attempts:
                raise
            count(f"retry_{op}")
            delay = base * (2 ** attempt) + random.uniform(0.0, jit)
            if max_backoff is not None:
                delay = min(delay, max_backoff)
            warn(f"transient {op} failure ({type(e).__name__}: {e}); "
                 f"retry {attempt + 1}/{attempts - 1} in {delay:.3f}s")
            t0 = time.perf_counter()
            time.sleep(delay)
            if profiler is not None:
                profiler.add("io_retry", time.perf_counter() - t0)


def retry_wire(fn, op: str = "wire", attempts: Optional[int] = None,
               backoff: Optional[float] = None,
               max_backoff: Optional[float] = None):
    """The WIRE retry profile .

    `retry()`'s defaults are filesystem-tuned (short backoff, no cap —
    disks come back fast or not at all); a dialing worker instead wants a
    bounded exponential ramp so a restarting gateway is not hammered.
    Call-site discipline: only wrap IDEMPOTENT operations — dial, REGISTER
    (re-registration replaces the previous connection), CACHE_LOOKUP.
    Never wrap a CACHE_PUT: a duplicate put after an ambiguous failure can
    resurrect an entry a concurrent refresh just invalidated, so puts stay
    fire-and-forget (SocketSearchClient.cache_put drops on OSError).

    attempts/backoff default from the module retry policy; `max_backoff`
    should carry the caller's `serve.reconnect_max_s` cap."""
    return retry(fn, op=op, max_attempts=attempts, backoff=backoff,
                 retry_on=(OSError,), max_backoff=max_backoff)


# -- circuit breaker --------------------------------------------------------


class CircuitBreaker:
    """Per-target wire circuit breaker. CLOSED: traffic flows, consecutive failures are
    counted. After `failures` consecutive failures the breaker OPENS:
    `allow()` answers False so the caller routes straight to its fallback
    without paying a dial/timeout per request. After `open_s` it admits
    exactly ONE half-open probe; a success closes the breaker, a failure
    re-opens it with the backoff doubled (capped at `max_open_s`).

    `clock` is injectable for fake-clock tests. The optional `on_open` /
    `on_close` callbacks fire on state transitions OUTSIDE the lock (they
    typically emit registry events; holding `_lock` across them would
    pin a lock order against the caller's own locks)."""

    def __init__(self, failures: int = 3, open_s: float = 0.25,
                 max_open_s: float = 30.0, clock=time.monotonic,
                 on_open=None, on_close=None):
        self._threshold = max(1, int(failures))
        self._base_open_s = float(open_s)
        self._max_open_s = float(max_open_s)
        self._clock = clock
        self._on_open = on_open
        self._on_close = on_close
        self._lock = threading.Lock()
        self._state = "closed"            # guarded-by: _lock
        self._failures = 0                # guarded-by: _lock (consecutive)
        self._open_s = float(open_s)      # guarded-by: _lock (current ramp)
        self._opened_at = 0.0             # guarded-by: _lock
        self._trips = 0                   # guarded-by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def trips(self) -> int:
        with self._lock:
            return self._trips

    def allow(self) -> bool:
        """May traffic be sent to this target right now? Open → False
        until the backoff elapses, then flips to half-open and admits the
        caller as THE single probe (further calls answer False until the
        probe reports back). Call it last in a routing decision — a True
        answer from a half-open breaker consumes the probe slot."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at < self._open_s:
                    return False
                self._state = "half_open"
                return True
            return False                  # half_open: probe already out

    def record_success(self) -> None:
        """A request to the target completed: close + reset the ramp."""
        cb = None
        with self._lock:
            if self._state != "closed":
                cb = self._on_close
            self._state = "closed"
            self._failures = 0
            self._open_s = self._base_open_s
        if cb is not None:
            cb(self)

    def record_failure(self) -> None:
        """A request to the target failed at the wire. The K-th
        consecutive failure opens the breaker; a failed half-open probe
        re-opens it with the backoff doubled."""
        cb = None
        with self._lock:
            self._failures += 1
            if self._state == "half_open":
                self._state = "open"
                self._opened_at = self._clock()
                self._open_s = min(self._open_s * 2.0, self._max_open_s)
                self._trips += 1
                cb = self._on_open
            elif self._state == "closed" and self._failures >= self._threshold:
                self._state = "open"
                self._opened_at = self._clock()
                self._trips += 1
                cb = self._on_open
        if cb is not None:
            cb(self)

    def reset(self) -> None:
        """Forget history (a worker re-registered: liveness is restored,
        the fresh connection deserves a clean slate)."""
        self.record_success()
