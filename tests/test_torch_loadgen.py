"""The port's load generator (``dnn_page_vectors_tpu_torch.loadgen``)
against the JAX package's, with no model and no sleeps: given the same
seed, the schedules of the Poisson and burst shapes, the closed loop's
worker streams and the QueryMix draws are the JAX package's exactly;
AdaptiveWindow follows the JAX controller's trajectory on the same queue
waits on an injected clock; find_qps_at_p99 on a stub service with a
known latency/load curve converges to the JAX driver's rate with the same
trials; snapshot_line is one line of JSON; a Mutator fires on its period; a
seeded filtered mix draws the JAX package's scenarios on top of the plain
stream, and a trial over it reports each scenario."""
import json
from collections import deque

import numpy as np
import pytest

from dnn_page_vectors_tpu import loadgen as jax_loadgen
from dnn_page_vectors_tpu.infer.serve import AdaptiveWindow as JaxWindow
from dnn_page_vectors_tpu.utils.telemetry import (
    MetricsRegistry as JaxRegistry)
from dnn_page_vectors_tpu_torch import loadgen
from dnn_page_vectors_tpu_torch.infer.serve import AdaptiveWindow
from dnn_page_vectors_tpu_torch.utils.telemetry import MetricsRegistry


def _same_requests(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.query_id, x.k, x.nprobe) == (y.query_id, y.k, y.nprobe)


@pytest.mark.parametrize("shape,kw", [
    ("poisson", {}),
    ("burst", {"on_s": 0.5, "off_s": 0.5}),
    ("burst", {"on_s": 0.2, "off_s": 0.7}),
])
@pytest.mark.parametrize("seed", [0, 11])
def test_open_loop_schedules_equal_jax(shape, kw, seed):
    prof = ((10, None, 0.75), (50, 4, 0.25))
    mine = loadgen.make_workload(shape, seed=seed, distinct=500, alpha=1.1,
                                 profile=prof, **kw)
    want = jax_loadgen.make_workload(shape, seed=seed, distinct=500,
                                     alpha=1.1, profile=prof, **kw)
    for duration, rate in ((3.0, 250.0), (2.5, 37.5)):
        a, b = mine.schedule(duration, rate), want.schedule(duration, rate)
        assert [t for t, _ in a] == [t for t, _ in b]
        _same_requests([r for _, r in a], [r for _, r in b])
        assert loadgen.Workload.digest(a) == \
            jax_loadgen.Workload.digest(b)
    # a re-derived generator per call: the same workload replays itself
    assert mine.schedule(3.0, 250.0) == mine.schedule(3.0, 250.0)
    assert mine.shape == want.shape and mine.kind == want.kind == "open"


def test_closed_loop_streams_and_query_mix_equal_jax():
    mine = loadgen.make_workload("closed", seed=3, distinct=10_000,
                                 think_s=0.01)
    want = jax_loadgen.make_workload("closed", seed=3, distinct=10_000,
                                     think_s=0.01)
    assert mine.think_s == want.think_s == 0.01 and mine.kind == "closed"
    for wid in (0, 1, 15):
        a = [r for r, _ in zip(mine.worker_stream(wid), range(50))]
        b = [r for r, _ in zip(want.worker_stream(wid), range(50))]
        _same_requests(a, b)
    # the Zipfian mix itself, drawn from one generator state
    prof = ((10, None, 1.0), (100, 16, 3.0))
    a = loadgen.QueryMix(10_000, alpha=1.1, profile=prof).sample(
        np.random.default_rng(7), 5000)
    b = jax_loadgen.QueryMix(10_000, alpha=1.1, profile=prof).sample(
        np.random.default_rng(7), 5000)
    _same_requests(a, b)
    counts = np.bincount([r.query_id for r in a], minlength=10_000)
    assert counts[0] == counts.max()          # rank 0 is the head query
    with pytest.raises(ValueError, match="unknown workload shape"):
        loadgen.make_workload("spiky")


@pytest.mark.parametrize("shape", ["poisson", "burst"])
def test_filtered_mix_equals_jax(shape):
    """The seeded filtered mix (the JAX test_filtered.py protocol): the
    port's schedule is the JAX package's request for request, scenario and
    canonical predicate included, its digest too; the arrivals and query
    ids are those of the plain stream, whose digest the mix leaves as it
    was."""
    from dnn_page_vectors_tpu.index import attrs as jattrs
    from dnn_page_vectors_tpu_torch.loadgen.workload import (
        DEFAULT_FILTER_SCENARIOS)
    from dnn_page_vectors_tpu.loadgen.workload import (
        DEFAULT_FILTER_SCENARIOS as JAX_SCENARIOS)
    assert DEFAULT_FILTER_SCENARIOS == JAX_SCENARIOS
    scen = DEFAULT_FILTER_SCENARIOS + (
        ("both", " site in {3, 1} & lang == 2", 0.2),)
    kw = dict(seed=5, distinct=16, profile=((10, None, 1.0),))
    mine = loadgen.make_workload(shape, filter_scenarios=scen, **kw)
    want = jax_loadgen.make_workload(shape, filter_scenarios=scen, **kw)
    plain = loadgen.make_workload(shape, **kw)
    a, b = mine.schedule(3.0, 50.0), want.schedule(3.0, 50.0)
    assert [t for t, _ in a] == [t for t, _ in b]
    assert [(r.query_id, r.k, r.nprobe, r.filters, r.scenario)
            for _, r in a] == [(r.query_id, r.k, r.nprobe, r.filters,
                                r.scenario) for _, r in b]
    assert mine.digest(a) == want.digest(b)
    assert mine.schedule(3.0, 50.0) == a
    base = plain.schedule(3.0, 50.0)
    assert [t for t, _ in a] == [t for t, _ in base]
    assert [r.query_id for _, r in a] == [r.query_id for _, r in base]
    assert mine.digest(base) == plain.digest(base) != mine.digest(a)
    seen = {r.scenario for _, r in a}
    assert "unfiltered" in seen and len(seen) > 2
    for _, r in a:
        if r.filters is not None:
            assert r.filters == jattrs.Predicate.parse(r.filters).text
    assert mine.mix.scenarios[-1][1] == "lang==2&site in {1,3}"
    with pytest.raises(ValueError, match="cannot parse"):
        loadgen.QueryMix(16, filter_scenarios=(("x", "lang=1", 1.0),))


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += max(0.0, dt)


def test_adaptive_window_follows_jax_trajectory():
    """The same queue waits at the same fake times: every control step
    gives the JAX controller's window, gauge and change record."""
    runs = []
    for window_cls, registry_cls in ((AdaptiveWindow, MetricsRegistry),
                                     (JaxWindow, JaxRegistry)):
        clock = _FakeClock()
        reg = registry_cls(clock=clock)
        qw = reg.histogram("serve.queue_wait_ms", window_s=10.0)
        gauge = reg.gauge("serve.batch_window_ms")
        changes = []
        ctl = window_cls(2.0, 25.0, qw, gauge=gauge,
                         on_change=lambda *a: changes.append(a))
        steps = []
        r = np.random.default_rng(5)
        for step in range(60):
            clock.t = step * 0.75
            # phases: pressure, a lone caller, silence, pressure again
            if step < 15 or step >= 50:
                waits = r.uniform(20.0, 80.0, size=6)
            elif step < 25:
                waits = [ctl.current_ms]
            else:
                waits = []
            for w in waits:
                qw.observe(float(w))
            steps.append((ctl.update(), gauge.value))
        runs.append((steps, changes))
    (mine, mine_ch), (want, want_ch) = runs
    assert mine == want
    assert mine_ch == want_ch
    assert {c[3] for c in mine_ch} == {"pressure", "idle"}
    assert max(w for w, _ in mine) == 25.0          # capped at the max
    assert min(w for w, _ in mine[25:50]) == 2.0    # decayed to the base


class _StubService:
    """p99 = base_ms up to knee_qps, then a cubic blow-up (the JAX test's
    curve): 'qps at p99 < 40 ms' is 200 qps in closed form."""

    def __init__(self, clock, registry_cls, knee_qps=100.0, base_ms=5.0,
                 window_s=10.0):
        self.clock = clock
        self.knee = knee_qps
        self.base = base_ms
        self.window = window_s
        self.registry = registry_cls(clock=clock)
        self.times = deque()
        self.calls = 0

    def search(self, query, k=None, nprobe=None):
        self.calls += 1
        self.times.append(self.clock())
        return []

    def metrics(self):
        now = self.clock()
        while self.times and self.times[0] < now - self.window:
            self.times.popleft()
        rate = len(self.times) / self.window
        p99 = (self.base if rate <= self.knee
               else self.base * (rate / self.knee) ** 3)
        return {"serve_window_qps": round(rate, 3),
                "serve_window_p50_ms": p99 / 2.0,
                "serve_window_p99_ms": p99,
                "serve_window_error_rate": 0.0,
                "serve_window_cache_hit_rate": 0.0,
                "serve_batch_window_ms": 2.0}


@pytest.mark.parametrize("shape,start", [("poisson", 25.0), ("burst", 25.0)])
def test_find_qps_at_p99_converges_to_the_jax_rate(shape, start):
    reps = []
    for pkg, reg in ((loadgen, MetricsRegistry),
                     (jax_loadgen, JaxRegistry)):
        clock = _FakeClock()
        svc = _StubService(clock, reg)
        wl = pkg.make_workload(shape, seed=0, distinct=16)
        reps.append(pkg.find_qps_at_p99(
            svc, wl, [f"q{i}" for i in range(16)], p99_target_ms=40.0,
            start=start, iters=6, duration_s=10.0, warmup_s=0.0, workers=0,
            clock=clock, sleep=clock.sleep))
    mine, want = reps
    assert mine["qps_at_p99"] == want["qps_at_p99"]
    assert 160.0 <= mine["qps_at_p99"] <= 220.0
    assert mine["load_sustained"] == want["load_sustained"]
    keys = ("offered_qps", "achieved_qps", "p99_ms", "met", "requests_sent",
            "schedule_digest")
    assert [{k: t[k] for k in keys} for t in mine["trials"]] == \
        [{k: t[k] for k in keys} for t in want["trials"]]
    met = [t for t in mine["trials"] if t["met"]]
    unmet = [t for t in mine["trials"] if not t["met"]]
    assert met and unmet                      # the search bracketed the cliff


class _SlowStub(_StubService):
    """The stub answering each request in `service_ms` of fake time, one
    at a time: its registry sees the service time, the client also sees
    the wait behind the requests before it."""

    def __init__(self, clock, registry_cls, service_ms):
        super().__init__(clock, registry_cls)
        self.service_s = service_ms / 1e3

    def search(self, query, k=None, nprobe=None):
        out = super().search(query, k, nprobe)
        self.clock.t += self.service_s
        return out


def test_client_latency_counts_the_wait_the_service_does_not_see():
    queries = [f"q{i}" for i in range(16)]
    wl = loadgen.make_workload("poisson", seed=0, distinct=16)
    clock = _FakeClock()
    tr = loadgen.run_trial(_SlowStub(clock, MetricsRegistry, 10.0), wl,
                           50.0, queries, duration_s=10.0, warmup_s=1.0,
                           workers=0, clock=clock, sleep=clock.sleep)
    assert 10.0 <= tr["client_p50_ms"] <= tr["client_p95_ms"] \
        <= tr["client_p99_ms"]
    assert tr["p99_ms"] == 5.0              # the registry's view: no wait
    # one at a time, the generator falls behind its schedule
    assert tr["issue_lag_max_ms"] > 0.0
    reps = {}
    for key in ("p99_ms", "client_p99_ms"):
        clock = _FakeClock()
        reps[key] = loadgen.find_qps_at_p99(
            _SlowStub(clock, MetricsRegistry, 10.0), wl, queries,
            p99_target_ms=40.0, start=25.0, iters=6, duration_s=10.0,
            warmup_s=1.0, workers=0, clock=clock, sleep=clock.sleep,
            p99_key=key)
        assert reps[key]["p99_key"] == key
        assert all(t[key] <= 40.0 for t in reps[key]["trials"] if t["met"])
    # one request at a time at 10 ms: the queue the client waits in ends
    # the search below the rate the service's own p99 allows
    assert 0 < reps["client_p99_ms"]["qps_at_p99"] \
        < reps["p99_ms"]["qps_at_p99"]
    none = {"p99_ms": 1.0, "client_p99_ms": None, "error_rate": 0.0,
            "shape": "poisson", "offered_qps": 0.0, "achieved_qps": 0.0}
    assert not loadgen.driver._meets(none, 40.0, 0.0, 0.8, "client_p99_ms")
    assert loadgen.driver._meets(none, 40.0, 0.0, 0.8)


def test_closed_loop_search_steps_whole_workers():
    clock = _FakeClock()
    svc = _StubService(clock, MetricsRegistry)
    wl = loadgen.make_workload("closed", seed=0, distinct=8, think_s=0.05)
    rep = loadgen.find_qps_at_p99(svc, wl, ["a"] * 8, p99_target_ms=40.0,
                                  start=1.0, iters=3, duration_s=2.0,
                                  warmup_s=0.0, workers=0, clock=clock,
                                  sleep=clock.sleep)
    assert all(float(t["offered_qps"]).is_integer() for t in rep["trials"])
    assert rep["shape"] == "closed" and svc.calls > 0


def test_snapshot_line_is_single_line_json():
    svc = _StubService(_FakeClock(), MetricsRegistry)
    line = loadgen.snapshot_line(svc, {"offered": 10.0})
    assert "\n" not in line
    rec = json.loads(line)
    assert rec["offered"] == 10.0 and "window_qps" in rec
    want = json.loads(jax_loadgen.snapshot_line(
        _StubService(_FakeClock(), JaxRegistry), {"offered": 10.0}))
    rec.pop("ts"), want.pop("ts")
    assert rec == want


def test_mutator_fires_on_its_period_and_keeps_errors():
    clock = _FakeClock()
    svc = _StubService(clock, MetricsRegistry)
    fired = []

    def _mutate():
        fired.append(clock())
        svc.registry.event("mutation", {"n": len(fired)})
        if len(fired) == 2:
            raise RuntimeError("boom")

    svc.registry.event("stale", {"before": True})   # pre-trial: excluded
    mut = loadgen.Mutator(_mutate, period_s=2.5)
    tr = loadgen.run_trial(svc, loadgen.make_workload("poisson", seed=1,
                                                      distinct=4),
                           50.0, ["a", "b", "c", "d"], duration_s=10.0,
                           warmup_s=0.0, workers=0, clock=clock,
                           sleep=clock.sleep, mutator=mut)
    assert tr["mutator_calls"] == len(fired) == 3   # at 2.5, 5.0, 7.5 s
    assert all(t >= 2.5 * (i + 1) for i, t in enumerate(fired))
    assert tr["mutator_errors"] == ["mutate: RuntimeError: boom"]
    names = [e["event"] for e in tr["events"]]
    assert names.count("mutation") == 3 and "stale" not in names
    assert tr["requests_sent"] == svc.calls
    with pytest.raises(ValueError, match="exactly one"):
        loadgen.Mutator()
    ops = loadgen.Mutator(ops=[("a", lambda: None), ("b", lambda: None)],
                          period_s=1.0)
    for t in (1.0, 2.0, 3.0):
        assert ops.maybe_fire(t)
    assert not ops.maybe_fire(3.5)
    assert ops.calls_by_op == {"a": 2, "b": 1}


def test_balanced_client_round_robin_is_seeded():
    class _C:
        def __init__(self):
            self.n = 0

        def search(self, q, k=10, nprobe=None):
            self.n += 1
            return [q]

    clients = [_C(), _C(), _C()]
    bal = loadgen.BalancedClient(clients, seed=4)
    for _ in range(7):
        bal.search("x")
    assert [c.n for c in clients] == [2, 3, 2]       # starts at 4 % 3 = 1
    least = loadgen.BalancedClient(clients, policy="least_loaded", seed=2)
    for _ in range(3):
        least.search("x")                       # nothing in flight: rotates
    assert [c.n for c in clients] == [3, 4, 3]
    with pytest.raises(ValueError):
        loadgen.BalancedClient(clients, policy="random")


class _FilteredStub(_SlowStub):
    """_SlowStub that also takes a predicate, and records each one."""

    def __init__(self, clock, registry_cls, service_ms):
        super().__init__(clock, registry_cls, service_ms)
        self.filters = []

    def search(self, query, k=None, nprobe=None, filters=None):
        self.filters.append(filters)
        return super().search(query, k, nprobe)


def test_filtered_trial_reports_each_scenario_as_jax_does():
    """A trial over the seeded filtered mix on a fake clock: the port's
    driver hands each request its predicate (none to an unfiltered one)
    and reports the scenarios' requests, rate, p50 and p99 as the JAX
    driver does on the same stub."""
    from dnn_page_vectors_tpu_torch.loadgen.workload import (
        DEFAULT_FILTER_SCENARIOS)
    queries = [f"q{i}" for i in range(16)]
    recs, sent = [], []
    for pkg, reg in ((loadgen, MetricsRegistry),
                     (jax_loadgen, JaxRegistry)):
        clock = _FakeClock()
        svc = _FilteredStub(clock, reg, 4.0)
        wl = pkg.make_workload("poisson", seed=2, distinct=16,
                               filter_scenarios=DEFAULT_FILTER_SCENARIOS)
        recs.append(pkg.run_trial(svc, wl, 40.0, queries, duration_s=5.0,
                                  warmup_s=0.0, workers=0, clock=clock,
                                  sleep=clock.sleep))
        sent.append(svc.filters)
    mine, want = recs
    assert sent[0] == sent[1] and None in sent[0]
    assert {f for f in sent[0] if f} == {"lang==0", "site in {0}",
                                         "recency>=0"}
    assert mine["filter_scenarios"] == want["filter_scenarios"]
    assert sum(b["requests"] for b in mine["filter_scenarios"].values()) \
        == mine["requests_sent"] == len(sent[0])
