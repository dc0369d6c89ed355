"""The port's command line: the offline workflows and the serving
commands of the JAX package's CLI.

  python -m dnn_page_vectors_tpu_torch.cli configs
  python -m dnn_page_vectors_tpu_torch.cli train --config cdssm_toy --workdir W
  python -m dnn_page_vectors_tpu_torch.cli embed --config cdssm_toy --workdir W
  python -m dnn_page_vectors_tpu_torch.cli eval  --config cdssm_toy --workdir W
  python -m dnn_page_vectors_tpu_torch.cli mine  --config hardneg_v5p64 --workdir W
  python -m dnn_page_vectors_tpu_torch.cli pipeline --config hardneg_v5p64 \\
      --workdir W --rounds 2
  python -m dnn_page_vectors_tpu_torch.cli search --config cdssm_toy \\
      --workdir W --query "some text" | --queries FILE | --interactive
  python -m dnn_page_vectors_tpu_torch.cli loadtest --config cdssm_toy \\
      --workdir W --transport socket --shape poisson --p99-ms 50
  python -m dnn_page_vectors_tpu_torch.cli search --config cdssm_toy \\
      --workdir W --query "some text" --partitions 4 --replicas 2
  python -m dnn_page_vectors_tpu_torch.cli loadtest --config cdssm_toy \\
      --workdir W --transport socket --partitions 4 --replicas 2 \\
      --front-ends 2 [--chaos PLAN]
  python -m dnn_page_vectors_tpu_torch.cli partition-worker \\
      --config cdssm_toy --workdir W --connect HOST:PORT[,HOST:PORT] \\
      --partition I --partitions P [--replica R]
  python -m dnn_page_vectors_tpu_torch.cli serve-metrics --workdir W [--json]
  python -m dnn_page_vectors_tpu_torch.cli trace --workdir W --query TEXT
  python -m dnn_page_vectors_tpu_torch.cli init-store --config cdssm_toy \
      --workdir W                 # then embed --start A --stop B per slice
  python -m dnn_page_vectors_tpu_torch.cli merge-store --workdir W
  python -m dnn_page_vectors_tpu_torch.cli append --config cdssm_toy \
      --workdir W --set data.num_pages=N [--tombstone 3,4] [--update-ids 9]
  python -m dnn_page_vectors_tpu_torch.cli refresh --workdir W
  python -m dnn_page_vectors_tpu_torch.cli reset-store --workdir W
  python -m dnn_page_vectors_tpu_torch.cli migrate --config cdssm_toy \
      --workdir W                 # re-embed the store at the checkpoint's step
  python -m dnn_page_vectors_tpu_torch.cli index --workdir W [--pq]
  python -m dnn_page_vectors_tpu_torch.cli maintain --workdir W [--once]

Any config field is overridable with ``--set section.field=value``, e.g.
``--set data.corpus=jsonl:/data/pages.jsonl`` for a corpus of
{"query": ..., "page": ...} lines. Every command but ``configs`` works in
``--workdir``: the trained vocab, ``metrics.jsonl``, the checkpoints
(``ckpt/``), the store (``store/``) and the mined table
(``hard_negatives.npy``). Commands run on ``--device`` (default ``cuda``;
``cpu`` runs on the CPU). Each prints one JSON line with the JAX CLI's
keys: ``{"final": ...}``, ``{"embedded": N, ...}``, ``{"recall@k": ...}``,
``{"mined": [N, H], ...}``, ``{"rounds": R, "recalls": [...]}``; ``search``
one ``{"query": ..., "results": [...]}`` line per query (``--interactive``
first a ``{"ready": true, ...}`` line; ``:metrics`` prints the registry
snapshot), ``loadtest`` one report line (``find_qps_at_p99``'s, with the
service's numbers), ``serve-metrics`` the Prometheus text (``--json``: the
snapshot; ``--watch N``: a JSON tick every N seconds), ``trace`` the Chrome
trace file's path and counts.

The store commands (the JAX CLI's keys): ``init-store`` stamps the store
once before a manual fleet of ``embed --start/--stop`` slices, each
writing its own writer manifest, and ``merge-store`` folds them in;
``append`` embeds the pages past the append cursor (grow the corpus with
``--set data.num_pages=``), ``--tombstone`` and ``--update-ids`` into a
new generation and brings an existing IVF index up to date; ``refresh``
brings the IVF index up to date with the store (incremental, or a full
rebuild past ``updates.rebuild_drift``), with no model; ``reset-store``
drops every shard. ``loadtest --mutate-every S`` hot-swaps the service
(``refresh()``) every S seconds under the load, and exits non-zero if a
refresh failed; ``search --interactive`` takes ``:refresh``.

Migrations and maintenance (the JAX CLI's keys): ``migrate`` re-embeds
the store to the newest checkpoint's step unit by unit (a rolling
migration, resumable; ``migrate.purge`` removes the superseded files);
``index`` builds the IVF index over the store (``--pq``: with OPQ+PQ codes,
``serve.pq_m`` or an automatic dim/8); ``maintain --once`` runs one pass
of the MaintenanceService's pillars and prints it, and without ``--once``
runs the pillar workers until interrupted, a JSON line a pass that did
work. ``loadtest --mutate-every S --mutate-mode maintain`` alternates a
tombstone burst with its refresh and a maintenance pass under the load.

Filtered retrieval (the JAX CLI's keys): ``append --attrs K=V ...``
stamps every appended row with one attribute word (``--init-attrs``
creates the store's attribute table first), ``search --filter EXPR``
keeps the results whose word matches, and ``loadtest --filters`` mixes
seeded filtered queries into the load.

Partitioned serving (the JAX CLI's flags): ``search`` and ``loadtest``
take ``--partitions P`` and ``--replicas R`` (``serve.partitions`` /
``serve.replicas``), served in process by a PartitionSet: P contiguous
shard ranges, R replicas of each, one scatter-gather; ``loadtest`` then
reports the partition block (``serve_partitions``, ``serve_replicas``,
``replica_shed``, ``partition_degraded``, ``partitions``).

The fleet over the wire (the JAX CLI's flags and keys):
``partition-worker`` serves one partition replica of the store's
``--partitions``-way split as a process of its own (no model: the store
and its view on ``--device``), registered with the gateway or gateways at
``--connect``; it prints a ready line (partition_worker, partitions,
replica, gateways, shards, rows, pid, device) and, once every gateway
said BYE, an exit line; SIGTERM drains it. ``loadtest --transport socket``
with P x R above 1 spawns one ``partition-worker`` subprocess a replica
behind a ``WorkerGateway`` a front end and exits non-zero, naming the
(partition, replica) slots, when they have not all registered within
``--worker-wait-s``; ``--front-ends N`` runs N front ends over one worker
set, spread by a seeded ``--balance`` policy (the report gains
``front_ends`` and ``balance_policy``, each trial a ``front_ends``
block); ``--faults PLAN`` installs a fault plan (``faults.plan``) and
``--chaos PLAN`` one armed after the fleet is up, over the wire ops (the
report gains a ``chaos`` block: offered, sheds, errors, availability,
injected). The workers and gateways are torn down in order: BYE, then a
wait for each process, then a kill.

``lint`` (ROADMAP.md queue 1, item 8) exits non-zero naming its item and
runs nothing in its place.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from dnn_page_vectors_tpu_torch.config import CONFIGS, get_config

PORTED = ("configs", "train", "embed", "eval", "mine", "pipeline", "search",
          "loadtest", "serve-metrics", "trace", "init-store", "merge-store",
          "reset-store", "append", "refresh", "migrate", "index", "maintain",
          "partition-worker")
# command -> (ROADMAP.md queue 1 item, what it needs)
NOT_PORTED = {
    "lint": (8, "graftcheck over the port"),
}


def _parse_overrides(pairs: Optional[List[str]]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for pair in pairs or []:
        key, _, value = pair.partition("=")
        out[key] = value
    return out


def _not_ported(what: str, item, need: str) -> SystemExit:
    return SystemExit(
        f"{what} is not ported to the PyTorch package yet: it needs {need} "
        f"(ROADMAP.md queue 1, item {item})")


def _trainer(cfg, workdir: str, device: str):
    from dnn_page_vectors_tpu_torch.train.loop import Trainer
    lookup = None
    if cfg.train.hard_negatives > 0:
        negs_path = os.path.join(workdir, "hard_negatives.npy")
        if os.path.exists(negs_path):
            from dnn_page_vectors_tpu_torch.mine.ann import HardNegatives
            lookup = HardNegatives.load(negs_path)
        else:
            print(f"WARNING: train.hard_negatives={cfg.train.hard_negatives} "
                  f"but {negs_path} does not exist: training with in-batch "
                  "negatives only; run 'mine' first (or check --workdir)",
                  file=sys.stderr)
    return Trainer(cfg, hard_negative_lookup=lookup, workdir=workdir,
                   device=device)


def _restore(trainer, workdir: str):
    """The checkpoint manager of `workdir`, with `trainer` restored from
    its newest checkpoint when there is one."""
    from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
    mgr = CheckpointManager(os.path.join(workdir, "ckpt"))
    if mgr.latest_step() is not None:
        trainer.restore(mgr)
    return mgr


def _open_index(cfg, store, device):
    """The IVF index for eval and mine when serve.index="ivf", else None
    (exact). An unavailable index is reported and exact retrieval runs,
    as in the JAX CLI."""
    if cfg.serve.index != "ivf":
        return None
    from dnn_page_vectors_tpu_torch.index.ivf import IndexUnavailable, IVFIndex
    try:
        return IVFIndex.open(store, device=device)
    except IndexUnavailable as e:
        print(f"WARNING: IVF index unavailable ({e}); using exact retrieval",
              file=sys.stderr)
        return None


SERVING = ("search", "loadtest", "serve-metrics", "trace")


def _serve_command(args, cfg, trainer, embedder, store, workdir: str) -> None:
    """search, loadtest, serve-metrics and trace over the store of
    `workdir`, with the JAX CLI's output lines."""
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    k = args.topk or cfg.eval.recall_k
    if store.model_step != trainer.step:
        print(f"WARNING: store embedded at model step {store.model_step} "
              f"but the restored checkpoint is at step {trainer.step}: "
              "query and page vectors come from different weights; re-run "
              "'embed' for meaningful rankings", file=sys.stderr)
    if args.command == "search":
        from dnn_page_vectors_tpu_torch.utils import telemetry
        from dnn_page_vectors_tpu_torch.utils.logging import MetricsLogger
        # a one-shot query streams the store shard by shard (staging the
        # whole store for one answer is waste); --queries and
        # --interactive stage it
        preload = 4.0 if (args.interactive or args.queries) else 0.0
        svc = SearchService(
            cfg, embedder, trainer.corpus, store, preload_hbm_gb=preload,
            log=MetricsLogger(workdir, echo=False,
                              registry=telemetry.default_registry()))
        if args.queries:
            with open(args.queries) as f:
                queries = [ln.strip() for ln in f if ln.strip()]
            for query, res in zip(queries, svc.search_many(
                    queries, k=k, filters=args.filter_expr)):
                print(json.dumps({"query": query, "results": res}),
                      flush=True)
        elif args.interactive:
            svc.warmup(k=k)
            print(json.dumps({"ready": True, "vectors": store.num_vectors,
                              "hbm_resident": svc.preloaded,
                              "latency_ms": round(svc.warm_latency_ms, 3)}),
                  flush=True)
            for line in sys.stdin:
                query = line.strip()
                if not query:
                    continue
                if query == ":refresh":
                    # hot swap to the store's current generation (after an
                    # `append` in another process); in-flight queries finish
                    # on the old view
                    print(json.dumps({"refreshed": svc.refresh()},
                                     sort_keys=True), flush=True)
                    continue
                if query == ":metrics":
                    print(json.dumps(svc.metrics_snapshot(),
                                     sort_keys=True), flush=True)
                    continue
                print(json.dumps({"query": query,
                                  "results": svc.search(
                                      query, k=k,
                                      filters=args.filter_expr)}),
                      flush=True)
        else:
            print(json.dumps({"query": args.query,
                              "hbm_resident": svc.preloaded,
                              "results": svc.search(
                                  args.query, k=k,
                                  filters=args.filter_expr)}))
        svc.close()      # the final metrics go to the metrics log
        return
    if args.command == "loadtest":
        _loadtest(args, cfg, trainer, embedder, store, k, workdir)
        return
    # trace / serve-metrics: streaming, as one-shot queries are
    svc = SearchService(cfg, embedder, trainer.corpus, store,
                        preload_hbm_gb=0.0)
    if args.command == "serve-metrics":
        # one probe query, so the rate and latency instruments are live
        svc.search_many([trainer.corpus.query_text(0)], k=k)
        if args.watch:
            from dnn_page_vectors_tpu_torch.loadgen import snapshot_line
            try:
                while True:
                    print(snapshot_line(svc), flush=True)
                    time.sleep(args.watch)
            except KeyboardInterrupt:
                pass
            return
        if args.json:
            print(json.dumps(svc.metrics_snapshot(), sort_keys=True))
        else:
            print(svc.prometheus_text(), end="")
        return
    if args.queries:
        with open(args.queries) as f:
            queries = [ln.strip() for ln in f if ln.strip()]
    else:
        queries = [args.query]
    for query in queries:              # one trace (one span tree) each
        svc.search_many([query], k=k)
    out_path = os.path.join(workdir, "trace_events.json")
    trace = svc.tracer.chrome_trace()
    with open(out_path, "w") as f:
        json.dump(trace, f)
    print(json.dumps({
        "trace_file": out_path, "traces": len(svc.tracer.traces()),
        "spans": len(trace["traceEvents"]),
        "slow_queries": len(svc.tracer.slow_queries()),
        "slow_ms": cfg.obs.slow_ms}, sort_keys=True))


def _spawn_workers(args, cfg, workdir: str, gateways, P: int, R: int):
    """One `partition-worker` subprocess a (partition, replica) slot,
    registered with every gateway, with this command's config overrides
    (the workers' views must be the front ends'). Their stdout (the ready
    and exit lines) is dropped; their stderr is this process's."""
    import subprocess
    connect = ",".join(f"{gw.host}:{gw.port}" for gw in gateways)
    cmd = [sys.executable, "-m", "dnn_page_vectors_tpu_torch.cli",
           "partition-worker", "--config", args.config, "--workdir", workdir,
           "--connect", connect, "--partitions", str(P),
           "--device", args.device]
    for pair in args.set_pairs:
        cmd += ["--set", pair]
    return {(p, r): subprocess.Popen(cmd + ["--partition", str(p),
                                            "--replica", str(r)],
                                     stdout=subprocess.DEVNULL)
            for p in range(P) for r in range(R)}


def _stop_workers(procs, timeout_s: float = 10.0) -> None:
    """Wait for each worker (its gateways' BYE ends it), then kill what
    is left; every spawned process is reaped."""
    import subprocess
    t_end = time.monotonic() + timeout_s
    for proc in procs:
        try:
            proc.wait(timeout=max(0.0, t_end - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _chaos_block(report: Dict, plan: str) -> Dict:
    """The availability drill's record: the share of offered queries
    answered (sheds left out of both sides: a shed is backpressure, not
    lost availability) and the faults injected."""
    from dnn_page_vectors_tpu_torch.utils import faults
    trials = report.get("trials", [])
    sent = sum(t.get("requests_sent", 0) for t in trials)
    errs = sum(t.get("errors", 0) for t in trials)
    sheds = sum(t.get("transport", {}).get("client_sheds", 0)
                for t in trials)
    return {
        "plan": plan, "offered": sent, "sheds": sheds, "errors": errs,
        "availability": round(max(sent - sheds - errs, 0)
                              / max(sent - sheds, 1), 6),
        "injected": {key: v for key, v in faults.counters().items()
                     if key.startswith("injected_")
                     or key == "worker_reconnect"}}


def _loadtest(args, cfg, trainer, embedder, store, k: int,
              workdir: str) -> None:
    """find_qps_at_p99 against a micro-batched service over the corpus's
    first --distinct queries, in process or through the socket front end
    (with P x R above 1 over partition-worker subprocesses behind a
    gateway, and with --front-ends N over N front ends); trial progress
    goes to stderr, the report is one JSON line."""
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.loadgen import (
        BalancedClient, Mutator, find_qps_at_p99, make_workload)
    from dnn_page_vectors_tpu_torch.utils import faults
    n_fe = max(1, int(args.front_ends))
    if n_fe > 1 and args.transport != "socket":
        raise SystemExit("--front-ends N > 1 requires --transport socket "
                         "(the balancer spreads the load over N listeners; "
                         "an in-process service has none)")
    svc = SearchService(cfg, embedder, trainer.corpus, store,
                        preload_hbm_gb=4.0)
    if args.mutate_every and args.mutate_mode == "maintain":
        # maintenance under the load: a tombstone burst and its refresh,
        # then a maintenance pass (compaction, rebuilds, the janitor), in
        # turns; lower maintenance.compact_tombstone_density with --set to
        # make a compaction fire within a short run
        from dnn_page_vectors_tpu_torch.updates import append_corpus
        maint = svc.start_maintenance(threads=False)
        n_base = max(store.num_vectors, 1)
        tomb = {"next": 0}
        chunk = max(16, n_base // 64)

        def _tombstone_refresh():
            ids = sorted({(tomb["next"] + i) % n_base for i in range(chunk)})
            tomb["next"] = (tomb["next"] + chunk) % n_base
            append_corpus(embedder, trainer.corpus, svc.store, tombstone=ids)
            svc.refresh()

        mut = Mutator(ops=[("tombstone_refresh", _tombstone_refresh),
                           ("maintain", maint.run_once)],
                      period_s=args.mutate_every)
    elif args.mutate_every:
        # the hot swap under the load: a refresh every --mutate-every
        # seconds (append from another process to give it something)
        mut = Mutator(svc.refresh, period_s=args.mutate_every)
    else:
        mut = None
    scen = None
    if args.lt_filters:
        # the seeded filtered mix: its default predicates all match the
        # all-zero word, so it runs the filtered paths on any store
        from dnn_page_vectors_tpu_torch.loadgen.workload import (
            DEFAULT_FILTER_SCENARIOS)
        scen = DEFAULT_FILTER_SCENARIOS
    svc.warmup(k=k)
    svc.start_batcher()
    fe_svcs = [svc]
    servers, gateways, clients, procs = [], [], [], {}
    client = None
    try:
        if args.transport == "socket":
            from dnn_page_vectors_tpu_torch.infer.partition_host import (
                WorkerGateway)
            from dnn_page_vectors_tpu_torch.infer.server import (
                serve_in_background)
            from dnn_page_vectors_tpu_torch.infer.transport import (
                SocketSearchClient)
            for _ in range(1, n_fe):
                # each further front end: a service of its own over the
                # same store, with its own gateway and listener
                fe = SearchService(cfg, embedder, trainer.corpus, store,
                                   preload_hbm_gb=4.0)
                fe.warmup(k=k)
                fe.start_batcher()
                fe_svcs.append(fe)
            pset = svc.partition_set
            if pset is not None:
                for fe in fe_svcs:
                    gw = WorkerGateway(fe)
                    fe.attach_gateway(gw)
                    gateways.append(gw)
                P, R = pset.partitions, pset.replicas
                procs = _spawn_workers(args, cfg, workdir, gateways, P, R)
                for fe_i, gw in enumerate(gateways):
                    t0 = time.perf_counter()
                    if not gw.wait_for_workers(P * R,
                                               timeout_s=args.worker_wait_s):
                        live = set(gw.live_workers())
                        missing = sorted(set(procs) - live)
                        for proc in procs.values():
                            proc.kill()
                        raise SystemExit(
                            f"{len(missing)} of {P * R} partition workers "
                            f"did not register with front end {fe_i} "
                            f"within {time.perf_counter() - t0:.2f} s "
                            f"(--worker-wait-s {args.worker_wait_s}): "
                            f"(partition, replica) slots {missing}")
            fleet_cache = bool(cfg.serve.result_cache
                               and cfg.serve.result_cache_fleet)
            for fe_i, fe in enumerate(fe_svcs):
                servers.append(serve_in_background(fe, front_end=fe_i))
            for srv in servers:
                clients.append(SocketSearchClient(
                    srv.host, srv.port, deadline_ms=cfg.serve.deadline_ms,
                    compress=cfg.serve.wire_compress,
                    result_cache=fleet_cache))
            if fleet_cache and n_fe > 1:
                # each front end shares its result cache with the others
                for fe_i, fe in enumerate(fe_svcs):
                    fe.attach_cache_peers([
                        SocketSearchClient(srv.host, srv.port,
                                           result_cache=True)
                        for j, srv in enumerate(servers) if j != fe_i])
            client = (clients[0] if n_fe == 1 else
                      BalancedClient(clients, policy=args.balance,
                                     seed=args.seed))
        distinct = max(1, args.distinct)
        queries = [trainer.corpus.query_text(i) for i in range(distinct)]
        wl = make_workload(args.shape, seed=args.seed, distinct=distinct,
                           profile=((k, None, 1.0),), filter_scenarios=scen)
        trial_s = (args.trial_s if args.trial_s is not None
                   else cfg.obs.window_s)
        if args.chaos:
            # armed only now: the store, the fleet's start and its
            # registrations must not take the plan's scheduled calls
            faults.install(faults.FaultPlan.parse(args.chaos,
                                                  seed=cfg.faults.seed))
        report = find_qps_at_p99(
            svc, wl, queries, p99_target_ms=args.p99_ms,
            start=args.start_qps, iters=args.iters, duration_s=trial_s,
            warmup_s=args.warmup_s, client=client, mutator=mut,
            progress=lambda line: print(line, file=sys.stderr, flush=True),
            progress_every_s=max(1.0, trial_s / 2.0),
            front_ends=fe_svcs if n_fe > 1 else None)
        final = svc.metrics()
    finally:
        # the orderly teardown: clients, listeners, then the gateways'
        # BYE, which ends each worker, then every process reaped
        for c in clients:
            c.close()
        for srv in servers:
            srv.close()
        for gw in gateways:
            gw.close()
        _stop_workers(procs.values())
        for fe in fe_svcs:
            fe.close()
    if servers:
        report.update({"transport": "socket",
                       "listen": ",".join(f"{srv.host}:{srv.port}"
                                          for srv in servers),
                       **({"transport_totals": final["transport"]}
                          if "transport" in final else {})})
        if n_fe > 1:
            report["front_ends"] = n_fe
            report["balance_policy"] = args.balance
    if scen is not None:
        # each trial record has its scenarios' qps and p99
        # (loadgen/driver.py "filter_scenarios"); this says the mix ran
        report["filters"] = [
            {"scenario": name, "predicate": pred, "weight": w}
            for name, pred, w in scen]
    if "result_cache" in final:
        report["result_cache"] = final["result_cache"]
    if svc.partition_set is not None:
        # the partitioned topology and its routing health
        report.update({key: final[key] for key in (
            "serve_partitions", "serve_replicas", "replica_shed",
            "partition_degraded", "partitions")})
    if args.chaos:
        report["chaos"] = _chaos_block(report, args.chaos)
    report.update({
        "store_vectors": store.num_vectors, "query_batch": svc.query_batch,
        "k": k, "serve_index": cfg.serve.index,
        "hbm_resident": svc.preloaded,
        "batch_window_adaptive": cfg.serve.batch_window_adaptive,
        "batch_window_ms": round(svc.batch_window_ms, 3),
        "warm_latency_ms": round(svc.warm_latency_ms, 3),
        "encodes": svc.encodes, "batch_retries": svc.batch_retries,
        "mean_batch": final.get("serve_mean_batch"),
        "fault_counters": faults.counters()})
    if mut is not None:
        report.update({"mutate_every_s": args.mutate_every,
                       "mutate_mode": args.mutate_mode,
                       "mutator_calls": mut.calls,
                       "mutator_calls_by_op": mut.calls_by_op,
                       "mutator_errors": mut.errors,
                       "store_generation": final["store_generation"],
                       "refreshes": final["refreshes"],
                       "full_rebuilds": final["full_rebuilds"]})
    print(json.dumps(report))
    if mut is not None and mut.errors:
        # the trial survives a failed mutation; the command does not
        raise SystemExit(f"{len(mut.errors)} of {mut.calls} mutations "
                         f"failed under the load: {mut.errors[:3]}")


STORE_ADMIN = ("init-store", "merge-store", "reset-store", "refresh",
               "index", "maintain")


def _ids_arg(text: Optional[str]) -> List[int]:
    return [int(x) for x in (text or "").split(",") if x.strip()]


def _store_admin(args, cfg, workdir: str, store_dir: str) -> None:
    """The store commands that need no model: init-store (the stamp of a
    manual fleet, from the newest checkpoint's step), merge-store,
    reset-store, refresh (the IVF index brought up to date on --device),
    index (the IVF index built) and maintain (the MaintenanceService)."""
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    if args.command == "init-store":
        from dnn_page_vectors_tpu_torch.infer.vector_store import (
            prepare_store)
        from dnn_page_vectors_tpu_torch.train.checkpoint import (
            CheckpointManager)
        step = CheckpointManager(os.path.join(workdir, "ckpt")).latest_step()
        model_step = step or 0
        prepare_store(store_dir, cfg.model.out_dim, cfg.eval.store_shard_size,
                      cfg.eval.store_dtype, model_step)
        print(json.dumps({"store": store_dir, "model_step": model_step}))
        return
    try:
        store = VectorStore(store_dir)
    except FileNotFoundError:
        raise SystemExit(f"no store at {store_dir}; run 'embed' first")
    if args.command == "index":
        _index(args, cfg, store, store_dir)
        return
    if args.command == "maintain":
        _maintain(args, cfg, store, store_dir)
        return
    if args.command == "reset-store":
        n = store.num_vectors
        store.reset()
        print(json.dumps({"store": store_dir, "dropped_vectors": n}))
        return
    if args.command == "merge-store":
        store.merge_writers()
        print(json.dumps({"store": store_dir,
                          "shards": len(store.manifest["shards"]),
                          "vectors": store.num_vectors}))
        return
    # refresh: the IVF index brought up to date with the store
    from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
    idx, info = IVFIndex.update(store, rebuild_drift=cfg.updates.rebuild_drift,
                                nlist=cfg.serve.nlist,
                                iters=cfg.serve.kmeans_iters,
                                init=cfg.serve.kmeans_init,
                                device=args.device)
    print(json.dumps({
        "store": store_dir, "vectors": store.num_vectors,
        "store_generation": store.generation, "nlist": idx.nlist,
        "imbalance": idx.imbalance, "index_generation": idx.index_generation,
        **info}, sort_keys=True))


def _index(args, cfg, store, store_dir: str) -> None:
    """index: the IVF index built over the store on --device (--pq, or a
    non-zero serve.pq_m: with OPQ+PQ codes; --pq alone takes dim/8
    subspaces), overwriting the live index directory."""
    from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
    from dnn_page_vectors_tpu_torch.index.pq import auto_pq_m
    from dnn_page_vectors_tpu_torch.utils import faults
    sv = cfg.serve
    pq_m = sv.pq_m
    if args.pq and not pq_m:
        pq_m = auto_pq_m(store.dim)
    t0 = time.perf_counter()
    idx = IVFIndex.build(store, nlist=sv.nlist, iters=sv.kmeans_iters,
                         seed=cfg.data.seed, init=sv.kmeans_init,
                         balance=sv.kmeans_balance, pq_m=pq_m,
                         pq_iters=sv.pq_iters, opq_iters=sv.pq_opq_iters,
                         device=args.device)
    # what the seeding bought (init -> final) and the assignment cap
    # (raw -> balanced)
    init_imb = float(idx.manifest.get("init_imbalance", 0.0))
    raw_imb = float(idx.manifest.get("imbalance_raw", idx.imbalance))
    pq_sec = idx.manifest.get("pq") or {}
    print(json.dumps({
        "store": store_dir, "vectors": store.num_vectors,
        "nlist": idx.nlist, "imbalance": idx.imbalance,
        "kmeans_init": idx.manifest.get("init"),
        "imbalance_init": init_imb,
        "imbalance_delta": round(init_imb - idx.imbalance, 4),
        "balance_cap": idx.manifest.get("balance_cap", 0),
        "imbalance_raw": raw_imb,
        "imbalance_balance_delta": round(raw_imb - idx.imbalance, 4),
        "pq_m": idx.pq_m,
        "codebook_build_seconds": pq_sec.get("train_seconds"),
        "model_step": idx.model_step,
        "build_seconds": round(time.perf_counter() - t0, 3),
        "fault_counters": faults.counters()}, sort_keys=True))


def _maintain(args, cfg, store, store_dir: str) -> None:
    """maintain: the MaintenanceService over the store on --device.
    --once prints one pass of every pillar; otherwise the pillar workers
    poll every maintenance.interval_s until interrupted, one JSON line a
    pass that did work."""
    from dnn_page_vectors_tpu_torch.maintenance import MaintenanceService
    from dnn_page_vectors_tpu_torch.utils import faults
    ms = MaintenanceService(cfg, store.directory, device=args.device)
    if args.once:
        out = ms.run_once()
        print(json.dumps({"store": store_dir, **out,
                          "fault_counters": faults.counters()},
                         sort_keys=True))
        return
    print(json.dumps({"maintaining": store_dir,
                      "interval_s": cfg.maintenance.interval_s}),
          file=sys.stderr, flush=True)
    ms.start()
    seen: Dict[str, int] = {}
    try:
        while True:
            time.sleep(cfg.maintenance.interval_s)
            snap = ms.stats()
            for pillar, n in snap["passes"].items():
                if n != seen.get(pillar):
                    seen[pillar] = n
                    print(json.dumps(
                        {pillar: snap["last"].get(pillar), "passes": n},
                        sort_keys=True), flush=True)
    except KeyboardInterrupt:
        ms.close()


def _migrate(cfg, trainer, embedder, store_dir: str) -> None:
    """migrate: the store re-embedded to the checkpoint's step, unit by
    unit (maintenance/migrate.py), then the superseded files purged
    (migrate.purge)."""
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.maintenance import (
        migrate_store, purge_stale)
    from dnn_page_vectors_tpu_torch.utils import faults
    try:
        store = VectorStore(store_dir)
    except FileNotFoundError:
        raise SystemExit(f"no store at {store_dir}; run 'embed' before "
                         "migrating")
    out = migrate_store(store, trainer.corpus, embedder, trainer.step,
                        batch_rows=cfg.migrate.batch_rows)
    purged = {}
    if cfg.migrate.purge and out.get("action") == "migrated":
        purged = purge_stale(store, out)
    print(json.dumps({
        "store": store_dir,
        **{k: v for k, v in out.items()
           if k not in ("stale_files", "stale_dirs")},
        **purged, "store_generation": store.generation,
        "fault_counters": faults.counters()}, sort_keys=True))


def _append(cfg, trainer, embedder, store_dir: str, workdir: str,
            args) -> None:
    """append: the pages past the cursor, --tombstone and --update-ids
    into a new generation, then an existing IVF index brought up to date
    (updates.auto_update_index); a failed index update is reported in
    index_update and on stderr (the generation is committed)."""
    from dnn_page_vectors_tpu_torch.index.ivf import (
        MANIFEST, IVFIndex, index_dir)
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    from dnn_page_vectors_tpu_torch.updates import append_corpus
    from dnn_page_vectors_tpu_torch.utils import telemetry
    from dnn_page_vectors_tpu_torch.utils.logging import MetricsLogger
    try:
        store = VectorStore(store_dir)
    except FileNotFoundError:
        raise SystemExit(f"no store at {store_dir}; run 'embed' before "
                         "appending")
    if store.model_step != trainer.step:
        raise SystemExit(
            f"store at {store_dir} is stamped for model step "
            f"{store.model_step} but the checkpoint is at {trainer.step}; "
            "appended vectors must share the base weights: re-run 'embed' "
            "(a full re-embed) instead")
    attr_word = None
    if args.init_attrs:
        store.init_attrs()
    if args.attrs:
        from dnn_page_vectors_tpu_torch.index import attrs as attrs_mod
        try:
            attr_word = attrs_mod.parse_attr_assignments(args.attrs)
        except attrs_mod.FilterError as e:
            raise SystemExit(f"bad --attrs: {e}")
        if not store.attrs_enabled:
            raise SystemExit(
                f"store at {store_dir} has no attribute table; pass "
                "--init-attrs once to create it (older shards then read as "
                "all-zero attribute words), or drop --attrs")
    stats = append_corpus(
        embedder, trainer.corpus, store, tombstone=_ids_arg(args.tombstone),
        update_ids=_ids_arg(args.update_ids), attrs=attr_word,
        log=MetricsLogger(workdir, echo=False,
                          registry=telemetry.default_registry()))
    index_info = None
    if cfg.updates.auto_update_index and os.path.exists(
            os.path.join(index_dir(store), MANIFEST)):
        try:
            _, index_info = IVFIndex.update(
                store, rebuild_drift=cfg.updates.rebuild_drift,
                nlist=cfg.serve.nlist, iters=cfg.serve.kmeans_iters,
                init=cfg.serve.kmeans_init, device=embedder.device)
        except Exception as e:  # noqa: BLE001 -- the append is committed
            index_info = {"error": f"{type(e).__name__}: {e}"}
            print(f"WARNING: the IVF update after the append failed: "
                  f"{index_info['error']}", file=sys.stderr)
    print(json.dumps({"store": store_dir,
                      "store_generation": store.generation,
                      "store_vectors": store.num_vectors, **stats,
                      "index_update": index_info}, sort_keys=True))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="dnn_page_vectors_tpu_torch")
    ap.add_argument("command", choices=[*PORTED, *NOT_PORTED])
    ap.add_argument("--config", default="cdssm_toy", choices=sorted(CONFIGS))
    ap.add_argument("--set", dest="overrides", action="append",
                    metavar="section.field=value")
    ap.add_argument("--workdir", default=None,
                    help="checkpoints, vocab, store, metrics and the mined "
                         "table live here (required but for configs)")
    ap.add_argument("--steps", type=int, default=None,
                    help="train: steps to run (default: up to train.steps); "
                         "pipeline: steps a round")
    ap.add_argument("--rounds", type=int, default=2,
                    help="pipeline: train -> embed -> mine -> train rounds")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--start", type=int, default=0,
                    help="embed: first page of a manual-fleet slice (a "
                         "store shard bound; run init-store once first)")
    ap.add_argument("--stop", type=int, default=None,
                    help="embed: one past the slice's last page (a shard "
                         "bound or the corpus end)")
    ap.add_argument("--tombstone", default=None, metavar="IDS",
                    help="append: comma-separated page ids to delete")
    ap.add_argument("--update-ids", dest="update_ids", default=None,
                    metavar="IDS",
                    help="append: comma-separated existing page ids to "
                         "re-embed into the new generation (their old rows "
                         "are tombstoned)")
    ap.add_argument("--attrs", nargs="+", default=None, metavar="K=V",
                    help="append: stamp every appended or updated row with "
                         "these attributes (lang=<0-255>, site=<name or "
                         "bucket 0-65535>, recency=<band 0-15>), packed "
                         "into one attribute word a row; a store with no "
                         "attribute table refuses unless --init-attrs is "
                         "also given")
    ap.add_argument("--init-attrs", dest="init_attrs", action="store_true",
                    help="append: initialize the store's attribute table "
                         "first (the word layout in the manifest; shards "
                         "written before it read as all-zero words)")
    # -- search / trace / serve-metrics ------------------------------------
    ap.add_argument("--query", default=None,
                    help="search / trace: one query (search streams the "
                         "store shard by shard: preload_hbm_gb=0)")
    ap.add_argument("--queries", default=None, metavar="FILE",
                    help="search / trace: one query per line; search sends "
                         "the file through one search_many")
    ap.add_argument("--interactive", action="store_true",
                    help="search: queries from stdin, one JSON line each "
                         "(':metrics' prints the registry snapshot)")
    ap.add_argument("--topk", type=int, default=None,
                    help="results per query (default eval.recall_k)")
    ap.add_argument("--nprobe", type=int, default=None,
                    help="IVF lists probed per query; implies "
                         "serve.index=ivf")
    ap.add_argument("--filter", dest="filter_expr", default=None,
                    metavar="EXPR",
                    help="search: an attribute predicate every result "
                         "matches: 'lang==X', 'site in {a,b}', "
                         "'recency>=band', '&'-joined conjunctions")
    ap.add_argument("--json", action="store_true",
                    help="serve-metrics: the JSON registry snapshot instead "
                         "of the Prometheus text")
    ap.add_argument("--watch", type=float, default=None, metavar="N",
                    help="serve-metrics: a one-line JSON tick every N "
                         "seconds until interrupted")
    # -- loadtest ----------------------------------------------------------
    ap.add_argument("--shape", default="poisson",
                    choices=["poisson", "burst", "closed"],
                    help="loadtest: open-loop poisson, open-loop on/off "
                         "burst, or closed-loop workers")
    ap.add_argument("--p99-ms", dest="p99_ms", type=float, default=50.0,
                    help="loadtest: the highest sustained qps with the "
                         "windowed p99 under this")
    ap.add_argument("--seed", type=int, default=0,
                    help="loadtest: the workload seed")
    ap.add_argument("--distinct", type=int, default=64,
                    help="loadtest: distinct queries under the Zipfian "
                         "repeat distribution")
    ap.add_argument("--trial-s", dest="trial_s", type=float, default=None,
                    help="loadtest: measured seconds a trial (default "
                         "obs.window_s)")
    ap.add_argument("--warmup-s", dest="warmup_s", type=float, default=1.0,
                    help="loadtest: warmup seconds a trial")
    ap.add_argument("--start-qps", dest="start_qps", type=float, default=8.0,
                    help="loadtest: the first offered load (workers for "
                         "--shape closed)")
    ap.add_argument("--iters", type=int, default=4,
                    help="loadtest: bisection steps after the doubling")
    ap.add_argument("--result-cache", dest="result_cache", default=None,
                    choices=["on", "off"],
                    help="loadtest: serve.result_cache on or off")
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "socket"],
                    help="loadtest: 'socket' serves through the asyncio "
                         "front end on loopback and issues through the "
                         "socket client")
    ap.add_argument("--front-ends", dest="front_ends", type=int, default=1,
                    metavar="N",
                    help="loadtest: N socket front ends over one worker "
                         "set, each with its own gateway and listener, the "
                         "load spread by --balance; needs --transport "
                         "socket when N > 1")
    ap.add_argument("--balance", default="round_robin",
                    choices=["round_robin", "least_loaded"],
                    help="loadtest: the client-side policy across "
                         "--front-ends (seeded by --seed)")
    ap.add_argument("--partitions", type=int, default=None, metavar="P",
                    help="loadtest / search: serve.partitions, P "
                         "contiguous partitions of the store (in process; "
                         "loadtest --transport socket spawns a "
                         "partition-worker a replica); partition-worker: "
                         "the split this worker's partition belongs to")
    ap.add_argument("--replicas", type=int, default=None, metavar="R",
                    help="loadtest / search: serve.replicas, R replicas "
                         "of every partition")
    ap.add_argument("--worker-wait-s", dest="worker_wait_s", type=float,
                    default=120.0,
                    help="loadtest --transport socket: how long every "
                         "partition worker has to register; past it the "
                         "command exits non-zero naming the missing slots")
    # -- partition-worker --------------------------------------------------
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="partition-worker: the front end's gateway to "
                         "register with; HOST:PORT,... registers with "
                         "every one listed (several front ends)")
    ap.add_argument("--partition", type=int, default=0, metavar="I",
                    help="partition-worker: the partition of the "
                         "--partitions-way split this process serves")
    ap.add_argument("--replica", type=int, default=0, metavar="R",
                    help="partition-worker: this process's replica id "
                         "within its partition")
    ap.add_argument("--faults", default=None, metavar="PLAN",
                    help="a fault plan 'op:kind:at[:count],...' "
                         "(utils/faults.py; --set faults.plan=PLAN)")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="loadtest: a seeded plan of wire faults (ops "
                         "wire_send, wire_recv, worker_dial, "
                         "gateway_accept, cache_peer_send; kinds "
                         "conn_drop, frame_delay, frame_trunc, frame_dup) "
                         "armed once the fleet is up; the report gains a "
                         "chaos block")
    ap.add_argument("--filters", dest="lt_filters", action="store_true",
                    help="loadtest: mix seeded filtered queries into the "
                         "workload (one predicate scenario a request over "
                         "the Zipf repeats); each trial record gains a "
                         "filter_scenarios block")
    ap.add_argument("--mutate-every", dest="mutate_every", type=float,
                    default=None,
                    help="loadtest: a refresh() of the service every S "
                         "seconds of each trial")
    ap.add_argument("--mutate-mode", dest="mutate_mode", default="refresh",
                    choices=["refresh", "maintain"],
                    help="loadtest: what --mutate-every fires: 'refresh' "
                         "(the hot swap) or 'maintain' (a tombstone burst "
                         "and its refresh, then a maintenance pass, in "
                         "turns)")
    ap.add_argument("--once", action="store_true",
                    help="maintain: one synchronous pass of every pillar, "
                         "then exit")
    ap.add_argument("--pq", action="store_true",
                    help="index: also train OPQ+PQ codes (serve.pq_m "
                         "subspaces, or dim/8 when it is 0)")
    args = ap.parse_args(argv)

    if args.command == "configs":
        for name in sorted(CONFIGS):
            print(name)
        return
    if args.command in NOT_PORTED:
        item, need = NOT_PORTED[args.command]
        raise _not_ported(f"the '{args.command}' command", item, need)
    if not args.workdir:
        ap.error(f"{args.command} needs --workdir")
    if args.command == "search" and not (args.query or args.queries
                                         or args.interactive):
        ap.error("search requires --query TEXT, --queries FILE, "
                 "or --interactive")
    if args.command == "trace" and not (args.query or args.queries):
        ap.error("trace requires --query TEXT or --queries FILE")
    overrides = _parse_overrides(args.overrides)
    if args.nprobe is not None:
        overrides.update({"serve.index": "ivf", "serve.nprobe": args.nprobe})
    if args.result_cache is not None:
        overrides["serve.result_cache"] = args.result_cache == "on"
    if args.partitions is not None:
        overrides["serve.partitions"] = max(1, args.partitions)
    if args.replicas is not None:
        overrides["serve.replicas"] = max(1, args.replicas)
    if args.faults is not None:
        overrides["faults.plan"] = args.faults
    # the overrides as --set pairs: a loadtest's partition workers take the
    # front end's config
    args.set_pairs = [f"{key}={val}" for key, val in overrides.items()]
    cfg = get_config(args.config, overrides)
    from dnn_page_vectors_tpu_torch.utils import faults
    faults.install_from_config(cfg)
    workdir = os.path.abspath(args.workdir)
    store_dir = os.path.join(workdir, "store")
    if args.command in STORE_ADMIN:
        _store_admin(args, cfg, workdir, store_dir)
        return
    if args.command == "partition-worker":
        # one partition replica as a process of its own: the store and its
        # view on --device, no model or checkpoint
        if not args.connect:
            ap.error("partition-worker requires --connect HOST:PORT")
        from dnn_page_vectors_tpu_torch.infer.partition_host import (
            run_partition_worker)
        run_partition_worker(cfg, store_dir, args.connect,
                             partition=args.partition,
                             partitions=max(1, args.partitions or 1),
                             replica=args.replica, device=args.device)
        return
    trainer = _trainer(cfg, workdir, args.device)
    mgr = _restore(trainer, workdir)

    if args.command == "train":
        # a bare re-run after a crash completes to the configured total;
        # --steps N means N more steps
        steps = (max(0, cfg.train.steps - trainer.step) if args.steps is None
                 else args.steps)
        metrics = trainer.train(steps=steps, ckpt_manager=mgr)
        trainer.save(mgr)
        print(json.dumps({"final": metrics}, sort_keys=True))
        return

    if args.command == "pipeline":
        from dnn_page_vectors_tpu_torch.train.pipeline import run_pipeline
        steps_per_round = (args.steps if args.steps is not None
                           else max(1, cfg.train.steps // args.rounds))
        out = run_pipeline(cfg, rounds=args.rounds,
                           steps_per_round=steps_per_round, trainer=trainer,
                           ckpt_manager=mgr)
        trainer.save(mgr)
        print(json.dumps({"rounds": args.rounds, "recalls": out["recalls"]},
                         sort_keys=True))
        return

    if mgr.latest_step() is None:
        print(f"WARNING: no checkpoint under {workdir}/ckpt: "
              f"'{args.command}' runs with RANDOM weights; run 'train' "
              "first (or check --workdir)", file=sys.stderr)
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.infer.vector_store import (
        VectorStore, prepare_store)
    embedder = BulkEmbedder(cfg, trainer.model, trainer.page_tok,
                            query_tok=trainer.query_tok,
                            device=trainer.device)

    if args.command == "embed":
        # vectors of another checkpoint are stale, not resumable work:
        # prepare_store resets a store stamped for another step. A manual
        # fleet's slice must not make that call (a late slice would reset
        # a sibling's shards): it needs init-store first, takes the
        # store's geometry, and writes its own writer manifest
        from dnn_page_vectors_tpu_torch.utils.profiling import PipelineProfiler
        if args.start != 0 or args.stop is not None:
            try:
                store = VectorStore(store_dir)
            except FileNotFoundError:
                raise SystemExit(
                    f"no store at {store_dir}; run 'init-store' once before "
                    "launching --start/--stop embed slices")
            if store.model_step != trainer.step:
                raise SystemExit(
                    f"store at {store_dir} is stamped for model step "
                    f"{store.model_step} but the checkpoint is at "
                    f"{trainer.step}; run 'init-store' once before "
                    "launching --start/--stop embed slices")
            store = VectorStore(
                store_dir, writer_id=args.start // store.manifest["shard_size"])
        else:
            store = prepare_store(store_dir, cfg.model.out_dim,
                                  cfg.eval.store_shard_size,
                                  cfg.eval.store_dtype, trainer.step)
        prof = PipelineProfiler()
        embedder.embed_corpus(trainer.corpus, store, profiler=prof,
                              start=args.start, stop=args.stop)
        print(json.dumps({"embedded": store.num_vectors,
                          "model_step": trainer.step,
                          "tokenize_workers": cfg.data.tokenize_workers,
                          "pages_per_sec": embedder.stats["pages_per_sec"],
                          "stages": prof.summary()}, sort_keys=True))
        return

    if args.command == "append":
        _append(cfg, trainer, embedder, store_dir, workdir, args)
        return
    if args.command == "migrate":
        _migrate(cfg, trainer, embedder, store_dir)
        return
    store = VectorStore(store_dir)
    if args.command in SERVING:
        _serve_command(args, cfg, trainer, embedder, store, workdir)
        return
    index = _open_index(cfg, store, trainer.device)
    if args.command == "eval":
        from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
        recall, nq = evaluate_recall(embedder, trainer.corpus, store,
                                     k=cfg.eval.recall_k, index=index,
                                     nprobe=cfg.serve.nprobe)
        print(json.dumps({f"recall@{cfg.eval.recall_k}": recall,
                          "num_queries": nq,
                          "index": "ivf" if index is not None else "exact"},
                         sort_keys=True))
        return

    # mine
    from dnn_page_vectors_tpu_torch.mine.ann import mine_hard_negatives
    out = os.path.join(workdir, "hard_negatives.npy")
    negs = mine_hard_negatives(embedder, trainer.corpus, store,
                               num_negatives=cfg.train.hard_negatives or 7,
                               out_path=out, index=index,
                               nprobe=cfg.serve.nprobe)
    print(json.dumps({"mined": list(negs.table.shape), "path": out,
                      "index": "ivf" if index is not None else "exact"}))


if __name__ == "__main__":
    main()
