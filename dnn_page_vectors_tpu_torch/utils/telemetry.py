"""The serving metrics registry: the port's copy of the JAX package's
utils/telemetry.py, with the same instruments, windows and exposition.

  * typed instruments -- ``Counter`` (monotonic, optionally with a rolling
    window so ``rate()`` answers "per second, over the last N seconds"),
    ``Gauge`` (last-set value), ``Histogram`` (a bounded ``Reservoir`` for
    since-boot percentiles and a time-windowed deque for live p50/p99) --
    created or fetched by name through ``MetricsRegistry``;
  * an event channel -- a bounded ring of lifecycle transitions (a window
    adapt, a deadline shed, an index degraded to exact), each optionally
    stamped with the trace id of the request that observed it
    (utils/tracing.py);
  * exposition -- ``snapshot()`` (JSON-serializable; the metrics jsonl,
    ``cli serve-metrics --json`` and the ``:metrics`` control line) and
    ``prometheus_text()`` (``cli serve-metrics``).

Memory is bounded by construction: reservoirs cap their samples
(Algorithm R keeps a uniform sample of an unbounded stream), windows prune
by age and cap by count, the event ring has a maxlen. Every instrument
takes an injectable clock, so tests step windows deterministically.

``default_registry()`` is the process-wide instance for code with no owner
to hand it one; ``SearchService`` builds its own registry per service so
services never mix counters.
"""
from __future__ import annotations

import json
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

DEFAULT_WINDOW_S = 10.0
# sub-second bucket granularity for windowed counters: bounds the bucket
# ring at window_s / _BUCKET_S entries no matter the event rate
_BUCKET_S = 0.1


class Reservoir:
    """Bounded uniform sample of an unbounded stream (Algorithm R) with
    EXACT running count/sum — percentiles are estimated from the sample,
    count and mean never are. Below `cap` samples the buffer holds every
    observation, so small-n percentiles are exact nearest-rank (the
    property LatencyStats relies on). Thread-safe; seeded, so a replayed
    run samples identically."""

    def __init__(self, cap: int = 4096, seed: int = 0):
        import random
        self._cap = max(1, int(cap))
        self._n = 0                      # guarded-by: _lock
        self._sum = 0.0                  # guarded-by: _lock
        self._buf: List[float] = []      # guarded-by: _lock
        self._rng = random.Random(seed)  # guarded-by: _lock
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._n += 1
            self._sum += v
            if len(self._buf) < self._cap:
                self._buf.append(v)
            else:
                j = self._rng.randrange(self._n)
                if j < self._cap:
                    self._buf[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._n if self._n else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]); 0.0 with no samples.
        Same semantics as the pre-registry LatencyStats: the returned value
        is a sample the stream actually delivered, not an interpolation."""
        with self._lock:
            if not self._buf:
                return 0.0
            s = sorted(self._buf)
        return s[nearest_rank(q, len(s))]


def nearest_rank(q: float, n: int) -> int:
    """0-based index of the nearest-rank q-th percentile in a sorted list
    of n samples: ceil(q*n/100) - 1, clamped to [0, n-1]. q=0 -> the min,
    q=100 -> the max, and the p50 of an even count is the LOWER middle."""
    return max(0, min(n - 1, int(-(-q * n // 100)) - 1))


class Counter:
    """Monotonic counter. With `window_s`, also keeps a ring of sub-second
    buckets so `rate()` reports events/sec over the last window — the live
    view (qps, error rate) the since-boot total can't give."""

    kind = "counter"

    def __init__(self, name: str, window_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.window_s = float(window_s) if window_s else None
        self._clock = clock
        self._v = 0                          # guarded-by: _lock
        # (bucket_start_ts, count) ring — guarded-by: _lock
        self._buckets: deque = deque()       # guarded-by: _lock
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n
            if self.window_s is not None:
                t = self._clock()
                b = t - (t % _BUCKET_S)
                if self._buckets and self._buckets[-1][0] == b:
                    self._buckets[-1][1] += n
                else:
                    self._buckets.append([b, n])
                self._prune(t)

    def _prune(self, now: float) -> None:  # holds-lock: _lock
        horizon = now - self.window_s
        while self._buckets and self._buckets[0][0] < horizon:
            self._buckets.popleft()

    @property
    def value(self) -> int:
        with self._lock:
            return self._v

    def window_count(self) -> int:
        """Events inside the rolling window (0 when un-windowed)."""
        if self.window_s is None:
            return 0
        with self._lock:
            self._prune(self._clock())
            return sum(n for _, n in self._buckets)

    def rate(self) -> float:
        """Events/sec over the rolling window; 0.0 when un-windowed."""
        if self.window_s is None:
            return 0.0
        return self.window_count() / self.window_s


class Gauge:
    """Last-set value (float)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0                        # guarded-by: _lock
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Streaming distribution: a bounded `Reservoir` answers since-boot
    count/mean/percentiles; a time-windowed deque (pruned by age, capped
    by count) answers the live window's p50/p99 and rate. Both are bounded
    regardless of how long the process lives."""

    kind = "histogram"

    def __init__(self, name: str, window_s: Optional[float] = DEFAULT_WINDOW_S,
                 cap: int = 4096, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.window_s = float(window_s) if window_s else None
        self._clock = clock
        self._res = Reservoir(cap=cap, seed=seed)
        # (ts, value) pairs; guarded-by: _lock
        self._win: deque = deque(maxlen=max(1, int(cap)))
        self._lock = threading.Lock()

    def observe(self, value: float, n: int = 1) -> None:
        v = float(value)
        for _ in range(max(1, int(n))):
            self._res.add(v)
        if self.window_s is not None:
            with self._lock:
                t = self._clock()
                for _ in range(max(1, int(n))):
                    self._win.append((t, v))
                self._prune(t)

    def _prune(self, now: float) -> None:  # holds-lock: _lock
        horizon = now - self.window_s
        while self._win and self._win[0][0] < horizon:
            self._win.popleft()

    @property
    def count(self) -> int:
        return self._res.count

    @property
    def mean(self) -> float:
        return self._res.mean

    @property
    def sum(self) -> float:
        return self._res.sum

    def percentile(self, q: float) -> float:
        return self._res.percentile(q)

    def _window_values(self) -> List[float]:
        if self.window_s is None:
            return []
        with self._lock:
            self._prune(self._clock())
            return [v for _, v in self._win]

    def window_count(self) -> int:
        return len(self._window_values())

    def window_rate(self) -> float:
        if self.window_s is None:
            return 0.0
        return self.window_count() / self.window_s

    def window_percentile(self, q: float) -> float:
        vals = self._window_values()
        if not vals:
            return 0.0
        vals.sort()
        return vals[nearest_rank(q, len(vals))]


class MetricsRegistry:
    """Named instruments + the lifecycle event channel. Instruments are
    get-or-create by name (`counter`/`gauge`/`histogram`), so callers never
    coordinate construction; a name is one kind forever (a second call with
    a different kind raises — silent kind drift is how dashboards lie)."""

    def __init__(self, events: int = 256,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._instruments: Dict[str, Any] = {}   # guarded-by: _lock
        # guarded-by: _lock
        self._events: deque = deque(maxlen=max(1, int(events)))
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
            elif inst.kind != kind:
                raise TypeError(
                    f"instrument {name!r} is a {inst.kind}, not a {kind}")
            return inst

    def counter(self, name: str, window_s: Optional[float] = None) -> Counter:
        return self._get(name, "counter",
                         lambda: Counter(name, window_s=window_s,
                                         clock=self._clock))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge", lambda: Gauge(name))

    def histogram(self, name: str,
                  window_s: Optional[float] = DEFAULT_WINDOW_S,
                  cap: int = 4096) -> Histogram:
        return self._get(name, "histogram",
                         lambda: Histogram(name, window_s=window_s, cap=cap,
                                           clock=self._clock))

    # -- event channel -----------------------------------------------------
    def event(self, name: str, attrs: Optional[Dict[str, Any]] = None,
              trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Record a lifecycle transition (view hot-swap, shard quarantine,
        drift rebuild, degraded/restored, checkpoint rollback). `trace_id`
        correlates the event with the request trace that observed it."""
        rec = {"ts": round(time.time(), 3), "event": str(name),
               "attrs": dict(attrs or {}), "trace_id": trace_id}
        with self._lock:
            self._events.append(rec)
        return rec

    def events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        return evs if name is None else [e for e in evs
                                         if e["event"] == name]

    # -- exposition --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable view of every instrument + the event ring —
        the one structure tests, the metrics jsonl, `cli serve-metrics
        --json`, and the `:metrics` control line all read."""
        with self._lock:
            insts = dict(self._instruments)
        counters: Dict[str, Any] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Any] = {}
        for name, inst in sorted(insts.items()):
            if inst.kind == "counter":
                rec: Dict[str, Any] = {"value": inst.value}
                if inst.window_s is not None:
                    rec["rate_per_s"] = round(inst.rate(), 4)
                    rec["window_s"] = inst.window_s
                counters[name] = rec
            elif inst.kind == "gauge":
                gauges[name] = round(inst.value, 6)
            else:
                rec = {"count": inst.count,
                       "mean": round(inst.mean, 4),
                       "p50": round(inst.percentile(50), 4),
                       "p99": round(inst.percentile(99), 4)}
                if inst.window_s is not None:
                    rec["window"] = {
                        "window_s": inst.window_s,
                        "count": inst.window_count(),
                        "rate_per_s": round(inst.window_rate(), 4),
                        "p50": round(inst.window_percentile(50), 4),
                        "p99": round(inst.window_percentile(99), 4)}
                hists[name] = rec
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "events": self.events()}

    def prometheus_text(self) -> str:
        """Prometheus text exposition. Counters/gauges as plain samples,
        histograms in summary style (quantile labels + _count/_sum)."""
        with self._lock:
            insts = dict(self._instruments)
        lines: List[str] = []
        for name, inst in sorted(insts.items()):
            pname = _prom_name(name)
            if inst.kind == "counter":
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {inst.value}")
                if inst.window_s is not None:
                    lines.append(f"# TYPE {pname}_rate_per_s gauge")
                    lines.append(f"{pname}_rate_per_s {inst.rate():.6g}")
            elif inst.kind == "gauge":
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {inst.value:.6g}")
            else:
                lines.append(f"# TYPE {pname} summary")
                for q in (50, 90, 99):
                    lines.append(f'{pname}{{quantile="{q / 100}"}} '
                                 f"{inst.percentile(q):.6g}")
                lines.append(f"{pname}_count {inst.count}")
                lines.append(f"{pname}_sum {inst.sum:.6g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


def _prom_name(name: str) -> str:
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return name if not name[:1].isdigit() else "_" + name


# -- the process-wide default registry --------------------------------------
# For code with no natural owner to hand it a registry (the CLI's metrics
# logger); SearchService builds its OWN registry so per-service counters
# never mix.

_DEFAULT = MetricsRegistry()
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def reset_default() -> MetricsRegistry:
    """Swap in a fresh default registry (test hygiene)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = MetricsRegistry()
        return _DEFAULT
