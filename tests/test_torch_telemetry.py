"""The port's telemetry (utils/telemetry.py, utils/tracing.py,
utils/logging.py, utils/profiling.LatencyStats) against the JAX package's,
on the CPU with an injected clock: the same sequence of increments,
observations and clock steps gives the same windowed counts and rates, the
same reservoir and windowed percentiles, the same event ring, snapshot and
Prometheus text; the tracer nests spans, hands a span across threads,
honours the slow-log threshold and exports valid Chrome trace events; the
serve and obs config knobs carry the JAX package's names and defaults."""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.utils import telemetry as jax_telemetry
from dnn_page_vectors_tpu.utils.logging import MetricsLogger as JaxLogger
from dnn_page_vectors_tpu.utils.profiling import LatencyStats as JaxLatency
from dnn_page_vectors_tpu.utils.tracing import Tracer as JaxTracer
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.utils import telemetry
from dnn_page_vectors_tpu_torch.utils.logging import MetricsLogger
from dnn_page_vectors_tpu_torch.utils.profiling import LatencyStats
from dnn_page_vectors_tpu_torch.utils.tracing import NULL_SPAN, Tracer


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _drive(mod, seed=0):
    """One scripted sequence on a fresh registry of `mod`: increments and
    observations at stepped fake times, read back as it goes."""
    clock = _Clock()
    reg = mod.MetricsRegistry(events=8, clock=clock)
    req = reg.counter("serve.requests", window_s=2.0)
    err = reg.counter("serve.errors", window_s=2.0)
    lat = reg.histogram("serve.latency_ms", window_s=2.0, cap=64)
    qw = reg.histogram("serve.queue_wait_ms", window_s=1.5, cap=16)
    reg.gauge("serve.batch_window_ms").set(2.0)
    plain = reg.counter("serve.encodes")
    rng = np.random.default_rng(seed)
    reads = []
    for step in range(120):
        clock.t += float(rng.choice([0.01, 0.05, 0.1, 0.3, 0.7]))
        req.inc(int(rng.integers(1, 4)))
        if step % 7 == 0:
            err.inc()
        for v in rng.gamma(2.0, 5.0, size=int(rng.integers(0, 4))):
            lat.observe(float(v))
        qw.observe(float(rng.uniform(0, 30)), n=int(rng.integers(1, 3)))
        plain.inc(2)
        if step % 11 == 0:
            reg.event("window_adapt", {"step": step}, trace_id=f"t-{step}")
        if step % 5 == 0:
            reads.append((req.value, req.window_count(), req.rate(),
                          err.window_count(), lat.count,
                          lat.window_count(), lat.window_rate(),
                          lat.percentile(50), lat.percentile(99),
                          lat.window_percentile(50),
                          lat.window_percentile(99), qw.window_count(),
                          qw.window_percentile(99), qw.mean,
                          plain.value, plain.window_count(), plain.rate()))
    return reg, reads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windows_reservoir_and_percentiles_equal_jax(seed):
    mine, reads = _drive(telemetry, seed)
    want, jreads = _drive(jax_telemetry, seed)
    assert reads == jreads
    # the reservoir past its cap (64 slots) samples as JAX's does
    assert mine.histogram("serve.latency_ms").count > 64


def test_snapshot_events_and_prometheus_equal_jax():
    mine, _ = _drive(telemetry, 3)
    want, _ = _drive(jax_telemetry, 3)
    assert mine.prometheus_text() == want.prometheus_text()
    a, b = mine.snapshot(), want.snapshot()
    for snap in (a, b):
        for ev in snap["events"]:
            ev.pop("ts")                  # the wall clock at the event
    assert a == b
    assert len(a["events"]) == 8          # the ring kept the last 8
    assert [e["attrs"]["step"] for e in a["events"]][-1] == 110
    assert json.loads(mine.to_json())["gauges"]["serve.batch_window_ms"] \
        == 2.0
    with pytest.raises(TypeError, match="is a counter"):
        mine.gauge("serve.requests")
    assert mine.events("nothing") == []
    reg = telemetry.reset_default()
    assert telemetry.default_registry() is reg


def test_reservoir_and_latency_stats_equal_jax():
    rng = np.random.default_rng(4)
    xs = rng.exponential(0.01, size=5000)
    mine, want = LatencyStats(cap=256, seed=3), JaxLatency(cap=256, seed=3)
    small, jsmall = LatencyStats(), JaxLatency()
    for x in xs:
        mine.add(float(x))
        want.add(float(x))
    for x in xs[:50]:
        small.add(float(x))
        jsmall.add(float(x))
    assert len(mine) == len(want) == 5000
    for q in (0, 1, 50, 90, 99, 100):
        assert mine.percentile_ms(q) == want.percentile_ms(q)
        assert small.percentile_ms(q) == jsmall.percentile_ms(q)
    assert mine.summary() == want.summary()
    # below the cap, nearest-rank over every sample
    s = sorted(xs[:50])
    assert small.percentile_ms(50) == s[24] * 1000.0
    with small.timed():
        pass
    assert len(small) == 51


# -- tracing ------------------------------------------------------------------

def test_span_tree_nesting_and_attrs():
    for tr in (Tracer(), JaxTracer()):
        with tr.trace("root", k=10) as root:
            with tr.span("a"):
                with tr.span("b") as b:
                    b.set_attrs(x=1)
            with tr.span("c"):
                pass
            with tr.root_or_span("search_many", n_queries=2) as sm:
                assert sm.trace_id == root.trace_id    # a child, not a root
        d = tr.last_trace()
        assert d["name"] == "root" and d["attrs"]["k"] == 10
        assert [c["name"] for c in d["children"]] == ["a", "c",
                                                       "search_many"]
        assert d["children"][0]["children"][0]["attrs"]["x"] == 1
        assert root.names() == ["root", "a", "b", "c", "search_many"]
        assert root.find("b").attrs == {"x": 1}
        # outside any trace root_or_span opens a root of its own
        with tr.root_or_span("search_many") as r2:
            pass
        assert tr.last_trace()["trace_id"] == r2.trace_id
        assert len(tr.traces()) == 2


def test_disabled_tracer_is_a_null_no_op():
    tr = Tracer(enabled=False)
    with tr.trace("root") as root:
        assert root is NULL_SPAN
        with tr.span("a") as sp:
            assert sp is NULL_SPAN
        root.set_attrs(x=1).child("q", 0.1)
        root.adopt(None)
    with tr.use(None):
        pass
    assert tr.traces() == [] and tr.current() is None


def test_span_survives_thread_hop_and_adopt():
    """The micro-batcher's pattern: capture current() on the caller thread,
    stamp a finished child and adopt a shared subtree on the dispatcher's,
    re-activate with use() for a retry."""
    tr = Tracer()
    done = threading.Event()

    def worker(ctx):
        with tr.trace("dispatch", record=False, batch_size=2) as dsp:
            with tr.span("encode"):
                pass
        ctx.child("queue_wait", 0.002)
        ctx.adopt(dsp)
        with tr.use(ctx):
            assert tr.current() is ctx
            with tr.span("retry"):
                pass
        done.set()

    with tr.trace("request") as root:
        t = threading.Thread(target=worker, args=(tr.current(),))
        t.start()
        assert done.wait(5)
        t.join(5)
    d = tr.last_trace()
    assert [c["name"] for c in d["children"]] == ["queue_wait", "dispatch",
                                                  "retry"]
    assert d["children"][1]["children"][0]["name"] == "encode"
    assert len(tr.traces()) == 1          # the detached root is not kept
    assert root.find("queue_wait").dur_ms == pytest.approx(2.0)


def test_slow_query_log_threshold_semantics():
    for cls in (Tracer, JaxTracer):
        never = cls(slow_ms=-1)
        with never.trace("r"):
            pass
        assert never.slow_queries() == []
        every = cls(slow_ms=0, slow_log_size=2)
        for _ in range(3):
            with every.trace("r"):
                pass
        assert len(every.slow_queries()) == 2     # bounded, oldest out
        high = cls(slow_ms=60_000)
        with high.trace("r"):
            pass
        assert high.slow_queries() == [] and len(high.traces()) == 1
        every.clear()
        assert every.slow_queries() == [] and every.traces() == []


def test_chrome_trace_export_is_valid_trace_event_json():
    tr = Tracer(buffer=4)
    for _ in range(6):
        with tr.trace("root"):
            with tr.span("tokenize"):
                pass
            with tr.span("topk") as sp:
                sp.set_attrs(rows=5)
    assert len(tr.traces()) == 4          # the ring keeps the last 4
    out = json.loads(json.dumps(tr.chrome_trace()))
    evs = out["traceEvents"]
    assert len(evs) == 12 and out["displayTimeUnit"] == "ms"
    assert {e["name"] for e in evs} == {"root", "tokenize", "topk"}
    for e in evs:
        assert e["ph"] == "X" and e["dur"] >= 0
        assert isinstance(e["ts"], (int, float))
        assert "trace_id" in e["args"] and "span_id" in e["args"]
    roots = [e for e in evs if e["name"] == "root"]
    for root in roots:
        kids = [e for e in evs if e["tid"] == root["tid"]]
        for e in kids:
            assert e["ts"] >= root["ts"] - 1e-3
            assert e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1e-3
    assert next(e for e in evs if e["name"] == "topk")["args"]["rows"] == 5


# -- MetricsLogger ------------------------------------------------------------

def test_metrics_logger_lines_equal_jax_and_mirror_gauges(tmp_path):
    rec = {"pages_per_sec": 123.5, "note": "text", "degraded": False,
           "n": np.int64(3)}
    lines = []
    for cls, mod, d in ((MetricsLogger, telemetry, "port"),
                        (JaxLogger, jax_telemetry, "jax")):
        reg = mod.MetricsRegistry()
        with cls(str(tmp_path / d), echo=False, registry=reg) as log:
            log.write(rec)
        assert log.closed
        log.write({"late": 1})            # tolerated after close
        log.close()
        with open(tmp_path / d / "metrics.jsonl") as f:
            got = [json.loads(ln) for ln in f]
        assert len(got) == 1
        got[0].pop("ts")
        lines.append(got[0])
        assert reg.gauge("pages_per_sec").value == 123.5
        assert "note" not in reg.snapshot()["gauges"]
        assert "degraded" not in reg.snapshot()["gauges"]
    assert lines[0] == lines[1]
    assert not os.path.exists(tmp_path / "none")
    MetricsLogger(None, echo=False).write({"a": 1})   # no workdir: no file


# -- config -------------------------------------------------------------------

def test_serve_and_obs_knobs_equal_jax():
    mine, want = get_config("bert_mini_v5p16"), jax_get_config(
        "bert_mini_v5p16")
    for section in ("serve", "obs"):
        a, b = getattr(mine, section), getattr(want, section)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), \
                f"{section}.{f.name}"
    for name in ("batch_window_ms", "batch_window_adaptive",
                 "batch_window_max_ms", "max_batch", "max_queue",
                 "query_cache_size", "deadline_ms", "result_cache",
                 "result_cache_size"):
        assert hasattr(mine.serve, name)
    ov = {"obs.slow_ms": "5.5", "obs.enabled": "false", "obs.window_s": "3",
          "serve.batch_window_adaptive": "true", "serve.max_batch": "16",
          "serve.query_cache_size": "0", "serve.result_cache": "1"}
    a, b = get_config("cdssm_toy", ov), jax_get_config("cdssm_toy", ov)
    assert a.obs == type(a.obs)(**dataclasses.asdict(b.obs))
    for name in ("batch_window_adaptive", "max_batch", "query_cache_size",
                 "result_cache"):
        assert getattr(a.serve, name) == getattr(b.serve, name)
    # filtered retrieval and the hot posting set are knobs (slice 11),
    # with the JAX package's names and defaults
    for name in ("hot_postings_gb", "filters", "filter_escalate"):
        assert getattr(a.serve, name) == getattr(b.serve, name)
    # partitioned serving's knobs (slice 12), the JAX package's names and
    # defaults
    for name in ("partitions", "replicas", "replica_shed_queue"):
        assert getattr(a.serve, name) == getattr(b.serve, name)
    # the fleet over the wire's knobs (slice 13), the JAX package's names,
    # defaults and override parsing; every serve knob is ported now
    fleet = {"hedge_quantile": "0.5", "heartbeat_s": "0.2",
             "result_cache_fleet": "true", "reconnect": "false",
             "reconnect_base_s": "0.1", "reconnect_max_s": "1.5",
             "breaker_failures": "2", "breaker_open_s": "0.5",
             "breaker_max_s": "9", "elastic": "1"}
    a = get_config("cdssm_toy", {f"serve.{k}": v for k, v in fleet.items()})
    b = jax_get_config("cdssm_toy", {f"serve.{k}": v
                                     for k, v in fleet.items()})
    for name in fleet:
        assert getattr(a.serve, name) == getattr(b.serve, name), name
    assert {f.name for f in dataclasses.fields(a.serve)} == \
        {f.name for f in dataclasses.fields(b.serve)}
    with pytest.raises(KeyError, match="not ported"):
        get_config("cdssm_toy", {"serve.no_such_knob": "2"})
