"""The SLO harness: the port's copy of the JAX package's loadgen/.

  * `workload` — seeded open-loop (Poisson, burst) and closed-loop
    traffic over a Zipfian query mix with (k, nprobe) profiles, and the
    periodic `Mutator`;
  * `driver` — timed trials against a live `SearchService` (in process or
    over the socket), every number read from its telemetry registry, and
    the search for "qps at p99 < X ms".

Entry points: `cli loadtest` (a one-line JSON report) and chip_smoke.py's
serving-under-load phase.
"""
from dnn_page_vectors_tpu_torch.loadgen.driver import (
    BalancedClient, find_qps_at_p99, run_trial, snapshot_line)
from dnn_page_vectors_tpu_torch.loadgen.workload import (
    DEFAULT_PROFILE, SHAPES, BurstWorkload, ClosedLoopWorkload, Mutator,
    PoissonWorkload, QueryMix, Request, Workload, make_workload)

__all__ = [
    "BalancedClient", "BurstWorkload", "ClosedLoopWorkload",
    "DEFAULT_PROFILE", "Mutator",
    "PoissonWorkload", "QueryMix", "Request", "SHAPES", "Workload",
    "find_qps_at_p99", "make_workload", "run_trial", "snapshot_line",
]
