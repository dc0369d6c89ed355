"""Request-scoped tracing: the port's copy of the JAX package's
utils/tracing.py.

`PipelineProfiler` answers "which stage binds in aggregate"; this module
answers "why did THIS query take 80 ms": every `search`/`search_many` call
gets a trace id and a span tree following the request through the
micro-batcher (queue_wait), tokenize/encode (with cache-hit annotation),
the top-k (on an IVF service: lists scanned, bytes gathered, rows
reranked as span attributes), merge, and format.

Mechanics:

  * `Span` — a named timed node with attributes and children. Spans nest
    through a `contextvars.ContextVar`, so `tracer.span("tokenize")`
    attaches to whatever request is active on the CURRENT thread without
    threading a handle through every signature.
  * the **thread hop** — the micro-batcher coalesces requests from many
    caller threads onto one dispatcher thread, where the contextvar chain
    breaks. The hand-off is explicit: `submit()` captures the caller's
    span (`tracer.current()`); the dispatcher stamps the measured
    `queue_wait` onto it (`Span.child`), runs the coalesced dispatch under
    a detached span, and grafts the finished dispatch subtree into every
    request's tree (`Span.adopt`) before resolving its future. For the
    per-request retry path, `tracer.use(span)` re-activates a caller's
    span on the dispatcher thread directly.
  * the **slow-query log** — a bounded ring of finished traces whose
    duration crossed `obs.slow_ms` (0 captures everything, <0 disables),
    each stored as a JSON-ready dict. The answer to "why was that one
    request slow" survives the request.
  * **export** — `chrome_trace()` renders the recent-trace ring (or any
    trace subset) as Chrome/Perfetto `trace_event` JSON ("ph": "X"
    complete events, microsecond timestamps, span attributes in "args"),
    written by `cli trace`.

Disabled tracing (`obs.enabled=false`) costs one `None`-check per span:
every context manager yields the shared `NULL_SPAN`, whose mutators are
no-ops, so instrumented code never branches on whether tracing is on.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# perf_counter -> epoch alignment for export: spans time themselves on the
# monotonic clock, the trace viewer wants wall-clock microseconds
_EPOCH0 = time.time() - time.perf_counter()

_IDS = itertools.count(1)


def _new_id(prefix: str) -> str:
    return f"{prefix}-{os.getpid():x}-{next(_IDS):x}"


class Span:
    """One timed node of a request trace. Not thread-safe per se — a span
    is mutated by the thread it is active on; the batcher hand-off
    serializes mutation through the queue/future protocol."""

    __slots__ = ("name", "trace_id", "span_id", "t0", "dur_s", "attrs",
                 "children", "tid")

    def __init__(self, name: str, trace_id: str,
                 attrs: Optional[Dict[str, Any]] = None,
                 t0: Optional[float] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id("s")
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self.dur_s: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.children: List["Span"] = []
        self.tid = threading.get_ident()

    def set_attrs(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def child(self, name: str, dur_s: float, t0: Optional[float] = None,
              **attrs: Any) -> "Span":
        """Append an already-FINISHED child (e.g. the batcher's measured
        queue_wait, whose start predates the dispatcher seeing it)."""
        sp = Span(name, self.trace_id, attrs=attrs,
                  t0=self.t0 if t0 is None else t0)
        sp.dur_s = float(dur_s)
        self.children.append(sp)
        return sp

    def adopt(self, span: "Span") -> None:
        """Graft a finished span subtree (the batcher's shared dispatch)
        into this tree. The subtree may be shared by every request of a
        coalesced batch — spans are records, not owners."""
        self.children.append(span)

    def end(self) -> "Span":
        if self.dur_s is None:
            self.dur_s = time.perf_counter() - self.t0
        return self

    @property
    def dur_ms(self) -> float:
        return (self.dur_s or 0.0) * 1000.0

    def names(self) -> List[str]:
        """Every span name in this subtree (test/debug helper)."""
        out = [self.name]
        for c in self.children:
            out.extend(c.names())
        return out

    def find(self, name: str) -> Optional["Span"]:
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "start_ms": round((_EPOCH0 + self.t0) * 1000.0, 3),
            "dur_ms": round(self.dur_ms, 4),
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }


class _NullSpan:
    """Shared no-op span: instrumented code calls set_attrs/child/adopt
    unconditionally whether tracing is on or not."""

    __slots__ = ()
    name = ""
    trace_id = None
    dur_ms = 0.0

    def set_attrs(self, **attrs: Any) -> "_NullSpan":
        return self

    def child(self, *a: Any, **kw: Any) -> "_NullSpan":
        return self

    def adopt(self, span: Any) -> None:
        pass

    def end(self) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Tracer:
    """Per-service trace context + the bounded trace/slow-query buffers."""

    def __init__(self, enabled: bool = True, slow_ms: Optional[float] = None,
                 slow_log_size: int = 64, buffer: int = 64):
        self.enabled = bool(enabled)
        # slow_ms: None or negative disables the slow log; 0 captures every
        # request (the "log everything" debugging mode)
        self.slow_ms = (None if slow_ms is None or slow_ms < 0
                        else float(slow_ms))
        self._var: contextvars.ContextVar[Optional[Span]] = \
            contextvars.ContextVar("dnn_pv_span", default=None)
        self._traces: deque = deque(maxlen=max(1, int(buffer)))
        self._slow: deque = deque(maxlen=max(1, int(slow_log_size)))
        self._lock = threading.Lock()

    # -- context -----------------------------------------------------------
    def current(self) -> Optional[Span]:
        """The span active on THIS thread (None outside any trace)."""
        return self._var.get()

    @contextlib.contextmanager
    def trace(self, name: str, record: bool = True, **attrs: Any):
        """Open a new ROOT span (fresh trace id) and activate it. On exit
        the finished trace lands in the recent-trace ring and — when its
        duration crosses `slow_ms` — the slow-query log. `record=False`
        keeps detached internal roots (the batcher's shared dispatch,
        grafted into request trees) out of both buffers."""
        if not self.enabled:
            yield NULL_SPAN
            return
        span = Span(name, trace_id=_new_id("t"), attrs=attrs)
        token = self._var.set(span)
        try:
            yield span
        finally:
            span.end()
            self._var.reset(token)
            if record:
                self._record(span)

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        """Open a child of the current span. Outside any trace (or with
        tracing disabled) this is a no-op yielding NULL_SPAN — stage
        instrumentation costs nothing on untraced paths."""
        parent = self._var.get() if self.enabled else None
        if parent is None:
            yield NULL_SPAN
            return
        sp = Span(name, parent.trace_id, attrs=attrs)
        token = self._var.set(sp)
        try:
            yield sp
        finally:
            sp.end()
            self._var.reset(token)
            parent.adopt(sp)

    @contextlib.contextmanager
    def use(self, span: Optional[Span]):
        """Explicit cross-thread hand-off: re-activate a caller's span on
        THIS thread (the micro-batcher's per-request retry path)."""
        if not self.enabled or span is None or span is NULL_SPAN:
            yield
            return
        token = self._var.set(span)
        try:
            yield
        finally:
            self._var.reset(token)

    @contextlib.contextmanager
    def root_or_span(self, name: str, **attrs: Any):
        """A root trace when no span is active, a child span otherwise —
        public entry points (`search_many`) are roots for direct callers
        and sub-spans when a batcher dispatch is already tracing."""
        cm = (self.span(name, **attrs) if self.current() is not None
              else self.trace(name, **attrs))
        with cm as sp:
            yield sp

    def _record(self, root: Span) -> None:
        with self._lock:
            self._traces.append(root)
            if self.slow_ms is not None and root.dur_ms >= self.slow_ms:
                self._slow.append(root.to_dict())

    # -- buffers -----------------------------------------------------------
    def traces(self) -> List[Dict[str, Any]]:
        """Recent finished traces, oldest first (JSON-ready dicts)."""
        with self._lock:
            roots = list(self._traces)
        return [r.to_dict() for r in roots]

    def last_trace(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._traces[-1].to_dict() if self._traces else None

    def slow_queries(self) -> List[Dict[str, Any]]:
        """Finished traces that crossed `slow_ms`, oldest first."""
        with self._lock:
            return list(self._slow)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._slow.clear()

    # -- export ------------------------------------------------------------
    def chrome_trace(self, traces: Optional[List[Dict[str, Any]]] = None
                     ) -> Dict[str, Any]:
        """Render traces (default: the recent ring) as Chrome/Perfetto
        `trace_event` JSON — load in chrome://tracing or ui.perfetto.dev.
        Spans shared across coalesced requests are emitted once."""
        events: List[Dict[str, Any]] = []
        seen: set = set()
        pid = os.getpid()

        def _emit(d: Dict[str, Any], tid_fallback: int) -> None:
            if d["span_id"] in seen:
                return
            seen.add(d["span_id"])
            events.append({
                "ph": "X",
                "name": d["name"],
                "cat": "request",
                "pid": pid,
                "tid": tid_fallback,
                "ts": round(d["start_ms"] * 1000.0, 1),    # microseconds
                "dur": round(max(d["dur_ms"], 0.0) * 1000.0, 1),
                "args": {**d["attrs"], "trace_id": d["trace_id"],
                         "span_id": d["span_id"]},
            })
            for c in d["children"]:
                _emit(c, tid_fallback)

        for i, t in enumerate(self.traces() if traces is None else traces):
            _emit(t, i)
        return {"traceEvents": events, "displayTimeUnit": "ms"}
