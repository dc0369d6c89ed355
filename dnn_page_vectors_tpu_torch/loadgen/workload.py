"""Seeded workload models for the SLO harness: the port's copy of the JAX
package's loadgen/workload.py. Given the same seed, the schedules and the
request streams are the JAX package's, number for number.

A latency objective means nothing without the traffic it holds under.
"N threads hammer as fast as they can" is CLOSED-loop traffic: when the
service slows down, the offered load slows with it, which hides latency
cliffs (coordinated omission). The shapes:

  * **open-loop Poisson** (`PoissonWorkload`) — exponential inter-arrival
    times at an offered rate regardless of how the service is doing; a
    service slower than the rate builds a queue and the p99 shows it. The
    default for "qps at p99 < X ms".
  * **open-loop burst** (`BurstWorkload`) — an on/off modulated Poisson
    process (the on-phase rate scaled by the duty cycle, so the mean rate
    holds) that alternates silence and bursts at the micro-batcher.
  * **closed-loop** (`ClosedLoopWorkload`) — N workers issue, wait,
    think, repeat; its concurrency maps onto "how many callers fit under
    the target".

Every workload draws queries from one `QueryMix`: a Zipfian repeat
distribution over `distinct` query ids (head-skewed traffic exercises the
query-embedding cache; `alpha=0` is uniform) crossed with a (k, nprobe)
profile.

Determinism: everything derives from ONE integer seed. `schedule()` and
`worker_stream()` re-derive their generator from (seed, call parameters)
on every call, so two runs with the same seed offer identical loads.

`Mutator` wraps a callable with a period, so the driver can fire a
mutation of the store under load (a refresh, an append, or a
maintenance pass). `QueryMix(filter_scenarios=...)` draws a filtered
scenario a request on top of the plain stream (index/attrs.py
predicates in canonical form): arrival times and query ids stay those of
the unfiltered mix.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# one (k, nprobe, weight) entry: nprobe None = the service's serve.nprobe
Profile = Sequence[Tuple[int, Optional[int], float]]
DEFAULT_PROFILE: Profile = ((10, None, 1.0),)

# one (scenario name, predicate text or None, weight) entry: the
# filtered-query mix of `cli loadtest --filters`. The default predicates
# all match the all-zero word, so the mix runs the filtered paths even on
# a store whose shards predate init_attrs().
FilterScenarios = Sequence[Tuple[str, Optional[str], float]]
DEFAULT_FILTER_SCENARIOS: FilterScenarios = (
    ("unfiltered", None, 0.5),
    ("lang", "lang==0", 0.25),
    ("site", "site in {0}", 0.15),
    ("recent", "recency>=0", 0.10),
)

SHAPES = ("poisson", "burst", "closed")


def _rng(seed: int, *parts) -> np.random.Generator:
    """Deterministic per-call generator: the seed folded with the call
    parameters, so the same (seed, params) always replays the same stream
    and different trials never share one."""
    h = hashlib.sha256(repr((int(seed),) + tuple(parts)).encode())
    return np.random.default_rng(
        int.from_bytes(h.digest()[:8], "little"))


@dataclasses.dataclass(frozen=True)
class Request:
    """One offered request: which distinct query, its (k, nprobe) drawn
    from the workload's profile, and — under a filtered mix — the
    scenario name plus the canonical predicate text it carries."""
    query_id: int
    k: int
    nprobe: Optional[int] = None
    filters: Optional[str] = None
    scenario: Optional[str] = None


class QueryMix:
    """Zipfian query-repeat distribution + a mixed (k, nprobe) profile.

    Rank-i query probability ~ 1/(i+1)^alpha over `distinct` ids: rank 0
    is the head query the LRU cache should pin, the tail keeps missing.
    """

    def __init__(self, distinct: int, alpha: float = 1.1,
                 profile: Profile = DEFAULT_PROFILE,
                 filter_scenarios: Optional[FilterScenarios] = None):
        self.distinct = max(1, int(distinct))
        self.alpha = float(alpha)
        self.profile = tuple(
            (int(k), None if np_ is None else int(np_), float(w))
            for k, np_, w in profile)
        p = np.arange(1, self.distinct + 1, dtype=np.float64) ** -self.alpha
        self._p = p / p.sum()
        w = np.asarray([w for _, _, w in self.profile], np.float64)
        self._pw = w / w.sum()
        # filtered-query scenarios, their predicates canonical at
        # construction, so every request of a scenario carries one text
        # (the result cache's key); None draws the plain streams, with no
        # extra draw
        self.scenarios: Optional[Tuple[Tuple[str, Optional[str], float],
                                       ...]] = None
        self._ps = None
        if filter_scenarios is not None:
            from dnn_page_vectors_tpu_torch.index import attrs as attrs_mod
            self.scenarios = tuple(
                (str(name),
                 None if pred is None
                 else attrs_mod.Predicate.parse(pred).text,
                 float(w))
                for name, pred, w in filter_scenarios)
            ws = np.asarray([w for _, _, w in self.scenarios], np.float64)
            self._ps = ws / ws.sum()

    def sample(self, rng: np.random.Generator, n: int) -> List[Request]:
        qids = rng.choice(self.distinct, size=n, p=self._p)
        prof = rng.choice(len(self.profile), size=n, p=self._pw)
        if self.scenarios is None:
            return [Request(int(q), self.profile[j][0], self.profile[j][1])
                    for q, j in zip(qids, prof)]
        scen = rng.choice(len(self.scenarios), size=n, p=self._ps)
        return [Request(int(q), self.profile[j][0], self.profile[j][1],
                        filters=self.scenarios[s][1],
                        scenario=self.scenarios[s][0])
                for q, j, s in zip(qids, prof, scen)]


class Workload:
    """Base: a seed + a QueryMix. Subclasses are either `kind="open"`
    (implement `schedule()`) or `kind="closed"` (implement
    `worker_stream()`)."""

    shape = "base"
    kind = "open"

    def __init__(self, mix: QueryMix, seed: int = 0):
        self.mix = mix
        self.seed = int(seed)

    def schedule(self, duration_s: float,
                 rate_qps: float) -> List[Tuple[float, Request]]:
        raise NotImplementedError

    def worker_stream(self, worker_id: int) -> Iterator[Request]:
        raise NotImplementedError

    @staticmethod
    def digest(schedule: Sequence[Tuple[float, Request]]) -> str:
        """Stable fingerprint of an offered-load schedule (arrival times
        at microsecond grain + the request stream) — two runs with the
        same seed must report the same digest."""
        h = hashlib.sha256()
        for t, req in schedule:
            # the scenario tag folds in only for FILTERED requests, so an
            # unfiltered schedule's digest is byte-identical to the
            # pre-filters format
            scen = f":{req.scenario}" if req.filters else ""
            h.update(f"{t:.6f}:{req.query_id}:{req.k}:{req.nprobe}{scen};"
                     .encode())
        return h.hexdigest()[:16]


class PoissonWorkload(Workload):
    """Open-loop Poisson arrivals at a given offered rate."""

    shape = "poisson"
    kind = "open"

    def schedule(self, duration_s: float,
                 rate_qps: float) -> List[Tuple[float, Request]]:
        rate = max(1e-9, float(rate_qps))
        rng = _rng(self.seed, "poisson", round(float(duration_s), 6),
                   round(rate, 6))
        times: List[float] = []
        t = 0.0
        while True:
            t += rng.exponential(1.0 / rate)
            if t >= duration_s:
                break
            times.append(t)
        reqs = self.mix.sample(rng, len(times))
        return list(zip(times, reqs))


class BurstWorkload(Workload):
    """Open-loop on/off bursts: Poisson arrivals during `on_s` windows,
    silence during `off_s` windows, with the ON rate scaled by the duty
    cycle so the MEAN offered rate equals `rate_qps` — trials at the same
    nominal load are comparable across shapes."""

    shape = "burst"
    kind = "open"

    def __init__(self, mix: QueryMix, seed: int = 0, on_s: float = 0.5,
                 off_s: float = 0.5):
        super().__init__(mix, seed)
        self.on_s = max(1e-3, float(on_s))
        self.off_s = max(0.0, float(off_s))

    def schedule(self, duration_s: float,
                 rate_qps: float) -> List[Tuple[float, Request]]:
        duty = self.on_s / (self.on_s + self.off_s)
        burst_rate = max(1e-9, float(rate_qps)) / duty
        rng = _rng(self.seed, "burst", round(float(duration_s), 6),
                   round(float(rate_qps), 6), round(self.on_s, 6),
                   round(self.off_s, 6))
        times: List[float] = []
        period = self.on_s + self.off_s
        start = 0.0
        while start < duration_s:
            t = start
            end = min(start + self.on_s, duration_s)
            while True:
                t += rng.exponential(1.0 / burst_rate)
                if t >= end:
                    break
                times.append(t)
            start += period
        reqs = self.mix.sample(rng, len(times))
        return list(zip(times, reqs))


class ClosedLoopWorkload(Workload):
    """Closed loop: the driver runs `int(load)` workers, each drawing its
    own seeded request stream and optionally thinking `think_s` between
    requests. Offered load is the worker count, not a rate."""

    shape = "closed"
    kind = "closed"

    def __init__(self, mix: QueryMix, seed: int = 0, think_s: float = 0.0):
        super().__init__(mix, seed)
        self.think_s = max(0.0, float(think_s))

    def worker_stream(self, worker_id: int) -> Iterator[Request]:
        rng = _rng(self.seed, "closed", int(worker_id))
        while True:
            yield self.mix.sample(rng, 1)[0]


class Mutator:
    """A concurrent mutation riding along with the load: every `period_s`
    of trial time the driver invokes the next op, so a trial measures
    serving under the mutation, not beside it. `calls` counts
    invocations; exceptions are stored, never raised into the trial.

    `ops` generalizes the single `fn` to a NAMED round-robin of
    mutations; `calls_by_op` records how often each fired."""

    def __init__(self, fn: Optional[Callable[[], None]] = None,
                 period_s: float = 1.0,
                 ops: Optional[Sequence[Tuple[str, Callable[[], None]]]]
                 = None):
        if (fn is None) == (ops is None):
            raise ValueError("Mutator wants exactly one of fn= or ops=")
        self.ops: List[Tuple[str, Callable[[], None]]] = (
            list(ops) if ops is not None else [("mutate", fn)])
        self.period_s = max(1e-3, float(period_s))
        self.calls = 0
        self.calls_by_op = {name: 0 for name, _ in self.ops}
        self.errors: List[str] = []

    def maybe_fire(self, elapsed_s: float, base: int = 0) -> bool:
        """Fire when `elapsed_s` of trial time covers the next period.
        `base` is the call count at trial start, so one Mutator shared
        across a whole qps@p99 search fires on EVERY trial's schedule
        instead of slowing down as calls accumulate."""
        if elapsed_s < (self.calls - base + 1) * self.period_s:
            return False
        name, op = self.ops[self.calls % len(self.ops)]
        self.calls += 1
        self.calls_by_op[name] += 1
        try:
            op()
        except Exception as e:  # noqa: BLE001 — the trial must survive
            self.errors.append(f"{name}: {type(e).__name__}: {e}"[:200])
        return True


def make_workload(shape: str, *, seed: int = 0, distinct: int = 64,
                  alpha: float = 1.1, profile: Profile = DEFAULT_PROFILE,
                  on_s: float = 0.5, off_s: float = 0.5,
                  think_s: float = 0.0,
                  filter_scenarios: Optional[FilterScenarios] = None
                  ) -> Workload:
    """One factory for the CLI/bench/driver: shape name -> Workload."""
    mix = QueryMix(distinct, alpha=alpha, profile=profile,
                   filter_scenarios=filter_scenarios)
    if shape == "poisson":
        return PoissonWorkload(mix, seed=seed)
    if shape == "burst":
        return BurstWorkload(mix, seed=seed, on_s=on_s, off_s=off_s)
    if shape == "closed":
        return ClosedLoopWorkload(mix, seed=seed, think_s=think_s)
    raise ValueError(f"unknown workload shape {shape!r}; have {SHAPES}")
