"""The port's CLI (``dnn_page_vectors_tpu_torch.cli``), called in process
with ``--device cpu`` at the verify skill's cdssm_toy overrides over a
600-page synthetic jsonl corpus: ``train``, ``embed``, ``eval``, ``mine``
and ``pipeline`` (4 tokenizer workers) give the same metrics, store
bytes, recall and mined table as the same calls through the API with one
worker; a second ``embed`` is a manifest no-op; every JAX command that is
not ported exits non-zero naming its ROADMAP item; ``partition-worker``
runs as a process of its own, and ``loadtest --transport socket`` spawns
the worker fleet."""
import json
import os

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu_torch import cli
from dnn_page_vectors_tpu_torch.config import CONFIGS, get_config
from dnn_page_vectors_tpu_torch.data.synth import write_synth_jsonl
from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import prepare_store
from dnn_page_vectors_tpu_torch.mine.ann import mine_hard_negatives
from dnn_page_vectors_tpu_torch.train.loop import Trainer
from dnn_page_vectors_tpu_torch.train.pipeline import run_pipeline



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests: pytest-xdist workers
    share the host's cores, and more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _overrides(path):
    return {"data.corpus": f"jsonl:{path}", "data.num_pages": 600,
            "data.trigram_buckets": 4096, "model.embed_dim": 64,
            "model.conv_channels": 128, "model.out_dim": 64,
            "train.batch_size": 64, "eval.embed_batch_size": 128,
            "eval.store_shard_size": 256, "train.steps": 20,
            "train.warmup_steps": 10, "train.learning_rate": 2e-3,
            "train.log_every": 20}


def _argv(command, workdir, ov, *extra):
    out = [command, "--config", "cdssm_toy", "--workdir", str(workdir),
           "--device", "cpu"]
    for k, v in ov.items():
        out += ["--set", f"{k}={v}"]
    return out + list(extra)


def _run(capsys, argv):
    cli.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def _npy_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".npy")}


@pytest.fixture(scope="module")
def corpus_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "c.jsonl")
    return write_synth_jsonl(path, 600, seed=3, page_len=24, query_len=6)


def test_offline_commands_equal_the_api(corpus_path, tmp_path, capsys):
    ov = _overrides(corpus_path)
    wd = tmp_path / "cli"
    final = _run(capsys, _argv("train", wd, ov))["final"]
    assert final["step"] == 20
    emb = _run(capsys, _argv("embed", wd, ov))
    assert emb["embedded"] == 600 and emb["model_step"] == 20
    assert emb["tokenize_workers"] == 4
    assert emb["stages"]["stage_tokenize_n"] == 5
    ev = _run(capsys, _argv("eval", wd, ov))
    assert ev["num_queries"] == 600 and ev["index"] == "exact"
    mined = _run(capsys, _argv("mine", wd, ov))
    assert mined["mined"] == [600, 7]

    # the same calls through the API, with one tokenizer worker (the CLI
    # ran data.tokenize_workers = 4)
    cfg = get_config("cdssm_toy", {**ov, "data.tokenize_workers": 1})
    api = tmp_path / "api"
    tr = Trainer(cfg, workdir=str(api), device="cpu")
    line = tr.train()
    for k in ("loss", "in_batch_acc", "scale", "grad_norm", "step"):
        assert final[k] == line[k], k
    e = BulkEmbedder(cfg, tr.model, tr.page_tok, query_tok=tr.query_tok,
                     device="cpu")
    store = prepare_store(str(api / "store"), 64, 256, "float16", tr.step)
    e.embed_corpus(tr.corpus, store)
    got, want = _npy_bytes(wd / "store"), _npy_bytes(api / "store")
    assert len(got) == 6 and got == want     # 3 shards: ids + vectors
    recall, nq = evaluate_recall(e, tr.corpus, store, k=10)
    assert ev["recall@10"] == recall and nq == 600
    assert recall > 0.2                      # random: about 0.017
    negs = mine_hard_negatives(e, tr.corpus, store, num_negatives=7,
                               out_path=str(api / "negs.npy"))
    np.testing.assert_array_equal(np.load(wd / "hard_negatives.npy"),
                                  negs.table)
    # a second embed is a manifest no-op: nothing is rewritten
    mtimes = {n: os.stat(wd / "store" / n).st_mtime_ns for n in got}
    again = _run(capsys, _argv("embed", wd, ov))
    assert again["embedded"] == 600 and "stage_tokenize_n" not in \
        again["stages"]
    assert mtimes == {n: os.stat(wd / "store" / n).st_mtime_ns for n in got}


def test_pipeline_command_equals_run_pipeline(corpus_path, tmp_path, capsys):
    ov = dict(_overrides(corpus_path), **{"train.hard_negatives": 3,
                                         "train.steps": 20})
    out = _run(capsys, _argv("pipeline", tmp_path / "cli", ov,
                             "--rounds", "2", "--steps", "10"))
    cfg = get_config("cdssm_toy", {**ov, "data.tokenize_workers": 1})
    tr = Trainer(cfg, workdir=str(tmp_path / "api"), device="cpu")
    want = run_pipeline(cfg, rounds=2, steps_per_round=10, trainer=tr)
    assert out == {"rounds": 2, "recalls": want["recalls"]}
    np.testing.assert_array_equal(
        np.load(tmp_path / "cli" / "hard_negatives.npy"),
        np.load(tmp_path / "api" / "hard_negatives.npy"))
    assert _npy_bytes(tmp_path / "cli" / "store") == \
        _npy_bytes(tmp_path / "api" / "store")


@pytest.mark.parametrize("command", sorted(cli.NOT_PORTED))
def test_unported_commands_exit_naming_their_item(command, tmp_path, capsys):
    with pytest.raises(SystemExit) as ei:
        cli.main([command, "--workdir", str(tmp_path), "--device", "cpu"])
    item = cli.NOT_PORTED[command][0]
    assert str(ei.value).endswith(f"(ROADMAP.md queue 1, item {item})")
    assert ei.value.code not in (0, None)
    assert not os.listdir(tmp_path)          # nothing ran in its place


def test_embed_slices_configs_and_workdir(tmp_path, capsys):
    # a manual-fleet slice needs init-store first (the slices run in
    # tests/test_torch_updates.py)
    for flag in ("--start", "--stop"):
        with pytest.raises(SystemExit, match="run 'init-store' once"):
            cli.main(["embed", "--workdir", str(tmp_path), "--device",
                      "cpu", "--set", "data.num_pages=64", flag, "256"])
    cli.main(["configs"])
    assert capsys.readouterr().out.split() == sorted(CONFIGS)
    with pytest.raises(SystemExit) as ei:
        cli.main(["train"])
    assert ei.value.code == 2 and "--workdir" in capsys.readouterr().err


# -- the serving commands ------------------------------------------------------

@pytest.fixture(scope="module")
def served(corpus_path, tmp_path_factory):
    """A workdir with a trained cdssm_toy and its store (20 steps)."""
    wd = tmp_path_factory.mktemp("served") / "wd"
    ov = {**_overrides(corpus_path), "obs.window_s": 0.5}
    cli.main(_argv("train", wd, ov))
    cli.main(_argv("embed", wd, ov))
    cfg = get_config("cdssm_toy", ov)
    tr = Trainer(cfg, workdir=str(wd), device="cpu")
    from dnn_page_vectors_tpu_torch.train.checkpoint import (
        CheckpointManager)
    tr.restore(CheckpointManager(str(wd / "ckpt")))
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    emb = BulkEmbedder(cfg, tr.model, tr.page_tok, query_tok=tr.query_tok,
                       device="cpu")
    svc = SearchService(cfg, emb, tr.corpus, VectorStore(str(wd / "store")))
    return {"wd": wd, "ov": ov, "svc": svc, "corpus": tr.corpus}


def _lines(capsys, argv):
    cli.main(argv)
    return [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]


def test_search_one_shot_queries_and_interactive(served, capsys, tmp_path,
                                                 monkeypatch):
    wd, ov, svc = served["wd"], served["ov"], served["svc"]
    qs = [served["corpus"].query_text(i) for i in (0, 5, 77, 5)]
    (one,) = _lines(capsys, _argv("search", wd, ov, "--query", qs[0]))
    # the one-shot streams the store: preload_hbm_gb=0
    assert one["hbm_resident"] is False
    assert one["results"] == svc.search(qs[0], k=10)
    path = tmp_path / "q.txt"
    path.write_text("\n".join(qs) + "\n\n")
    got = _lines(capsys, _argv("search", wd, ov, "--queries", str(path),
                               "--topk", "5"))
    assert [g["query"] for g in got] == qs
    assert [g["results"] for g in got] == svc.search_many(qs, k=5)
    import io
    monkeypatch.setattr("sys.stdin", io.StringIO(
        f"{qs[1]}\n\n:metrics\n{qs[1]}\n"))
    lines = _lines(capsys, _argv("search", wd, ov, "--interactive"))
    assert lines[0]["ready"] is True and lines[0]["hbm_resident"] is True
    assert lines[0]["vectors"] == 600 and lines[0]["latency_ms"] > 0
    assert lines[1]["results"] == svc.search(qs[1], k=10) == \
        lines[3]["results"]
    snap = lines[2]
    assert snap["metrics"]["serve_cache_misses"] == 2   # warmup + qs[1]
    assert snap["counters"]["serve.requests"]["value"] == 5
    monkeypatch.setattr("sys.stdin", io.StringIO(f":refresh\n{qs[1]}\n"))
    lines = _lines(capsys, _argv("search", wd, ov, "--interactive"))
    assert lines[1]["refreshed"]["store_generation"] == 0
    assert lines[1]["refreshed"]["new_docs"] == 0
    assert lines[2]["results"] == svc.search(qs[1], k=10)
    with pytest.raises(SystemExit) as ei:
        cli.main(_argv("search", wd, ov))
    assert ei.value.code == 2 and "--query" in capsys.readouterr().err
    # the metrics log holds the service's records
    with open(wd / "metrics.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    assert any("serve_hbm_resident" in r for r in recs)
    assert any("serve_window_qps" in r for r in recs)


# a target no trial meets: one trial at 30 qps, no doubling, no bisection
LOADTEST = ("--trial-s", "0.5", "--warmup-s", "0.1", "--iters", "0",
            "--start-qps", "30", "--p99-ms", "0.001", "--distinct", "32")


@pytest.mark.parametrize("transport", ["inproc", "socket"])
def test_loadtest_report_shape_and_seed_determinism(served, capsys,
                                                    transport):
    wd, ov = served["wd"], served["ov"]
    reps = [_lines(capsys, _argv("loadtest", wd, ov, *LOADTEST,
                                 "--transport", transport, "--seed",
                                 str(seed)))[-1]
            for seed in (0, 0, 1)]
    rep = reps[0]
    for key in ("qps_at_p99", "p99_target_ms", "shape", "seed",
                "load_sustained", "trials", "trial_duration_s",
                "store_vectors", "query_batch", "k", "serve_index",
                "hbm_resident", "batch_window_ms", "warm_latency_ms",
                "encodes", "batch_retries", "mean_batch"):
        assert key in rep, key
    assert rep["shape"] == "poisson" and rep["p99_target_ms"] == 0.001
    assert rep["store_vectors"] == 600 and rep["hbm_resident"] is True
    assert rep["batch_retries"] == 0 and rep["qps_at_p99"] == 0.0
    assert [t["offered_qps"] for t in rep["trials"]] == [30.0]
    assert rep["trials"][0]["met"] is False
    assert rep["trials"][0]["requests_sent"] > 0
    for t in rep["trials"]:
        for key in ("offered_qps", "achieved_qps", "p50_ms", "p99_ms",
                    "error_rate", "cache_hit_rate", "queue_wait_p99_ms",
                    "requests_sent", "errors", "events", "met",
                    "schedule_digest"):
            assert key in t, key
        assert ("transport" in t) == (transport == "socket")
    # the same seed offers the same schedule; another seed does not
    digests = [r["trials"][0]["schedule_digest"] for r in reps]
    assert digests[0] == digests[1] != digests[2]
    if transport == "socket":
        assert rep["transport"] == "socket" and ":" in rep["listen"]
        assert rep["transport_totals"]["wire_bytes"] > 0


def test_loadtest_mutate_every_hot_swaps_under_the_load(served, capsys,
                                                       tmp_path):
    """--mutate-every S: a refresh() every S seconds of each trial, after
    an append from another writer; the report counts them, and the swap
    lands the appended generation (a copy of the served workdir)."""
    import shutil
    wd = tmp_path / "wd"
    shutil.copytree(served["wd"], wd)
    # the served corpus grown by 50 pages (the writer is prefix-stable)
    grown = write_synth_jsonl(str(tmp_path / "c650.jsonl"), 650, seed=3,
                              page_len=24, query_len=6)
    ov = {**served["ov"], "data.corpus": f"jsonl:{grown}",
          "data.num_pages": 650}
    app = _lines(capsys, _argv("append", wd, ov, "--tombstone", "5"))[-1]
    assert app["generation"] == 1 and app["appended"] == 50
    rep = _lines(capsys, _argv("loadtest", wd, ov, *LOADTEST,
                               "--mutate-every", "0.2"))[-1]
    assert rep["mutator_calls"] >= 1 and rep["mutator_errors"] == []
    assert rep["store_generation"] == 1
    assert rep["refreshes"] == rep["mutator_calls"]
    assert rep["trials"][0]["mutator_calls"] >= 1


def test_loadtest_mutate_mode_maintain_compacts_under_the_load(
        served, capsys, tmp_path):
    """--mutate-mode maintain: a tombstone burst and its refresh, then a
    maintenance pass, in turns under the load; at a compaction trigger of
    0.01 the first pass folds the chain, and no mutation fails."""
    import shutil

    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    wd = tmp_path / "wd"
    shutil.copytree(served["wd"], wd)
    rep = _lines(capsys, _argv(
        "loadtest", wd, {**served["ov"],
                         "maintenance.compact_tombstone_density": 0.01},
        *LOADTEST, "--mutate-every", "0.1", "--mutate-mode", "maintain"))[-1]
    assert rep["mutate_mode"] == "maintain" and rep["mutator_errors"] == []
    calls = rep["mutator_calls_by_op"]
    assert calls["tombstone_refresh"] >= 1 and calls["maintain"] >= 1
    store = VectorStore(str(wd / "store"))
    assert store.compacted_through >= 1
    live = int((store.load_all()[0] >= 0).sum())
    assert live == 600 - 16 * calls["tombstone_refresh"]


def test_serve_metrics_and_trace(served, capsys):
    wd, ov = served["wd"], served["ov"]
    cli.main(_argv("serve-metrics", wd, ov))
    text = capsys.readouterr().out
    assert "# TYPE serve_requests counter" in text
    assert "serve_requests 1" in text and "serve_encodes 1" in text
    (snap,) = _lines(capsys, _argv("serve-metrics", wd, ov, "--json"))
    assert snap["metrics"]["serve_preloaded"] is False
    assert snap["counters"]["serve.requests"]["value"] == 1
    (out,) = _lines(capsys, _argv("trace", wd, ov, "--query", "one two",
                                  "--set", "obs.slow_ms=0"))
    assert out["traces"] == 1 and out["slow_queries"] == 1
    with open(out["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) == out["spans"]
    assert {e["name"] for e in events} == {"search_many", "tokenize",
                                           "encode", "topk", "format"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    with pytest.raises(SystemExit) as ei:
        cli.main(_argv("trace", wd, ov))
    assert ei.value.code == 2


def _fleet_procs(wd) -> list:
    """The live partition-worker processes serving workdir `wd`."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
        except OSError:
            continue
        if b"partition-worker" in cmd and str(wd).encode() in cmd:
            out.append(int(pid))
    return out


def test_partition_worker_subprocess_serves_and_is_lost_on_kill(served):
    """`partition-worker --device cpu` as a real process: it prints its
    ready line, registers, serves its slice byte for byte as the
    in-process scatter, and a kill -9 is seen as worker_lost while the
    front end serves on locally."""
    import signal
    import subprocess
    import sys
    import time

    from dnn_page_vectors_tpu_torch.infer.partition_host import (
        DeviceEmbedder, WorkerGateway)
    from dnn_page_vectors_tpu_torch.infer.serve import SearchService
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    wd, ov = served["wd"], served["ov"]
    cfg = get_config("cdssm_toy", {**ov, "serve.partitions": 2,
                                   "serve.heartbeat_s": 0.3})
    svc = SearchService(cfg, DeviceEmbedder("cpu"), None,
                        VectorStore(str(wd / "store")))
    qv = np.random.default_rng(0).standard_normal((3, 64)).astype(
        np.float32)
    want = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc)
    svc.attach_gateway(gw)
    argv = _argv("partition-worker", wd, ov, "--connect",
                 f"127.0.0.1:{gw.port}", "--partitions", "2",
                 "--set", "serve.heartbeat_s=0.3")
    procs = [subprocess.Popen([sys.executable, "-m",
                               "dnn_page_vectors_tpu_torch.cli", *argv,
                               "--partition", str(p)],
                              stdout=subprocess.PIPE, text=True)
             for p in range(2)]
    try:
        assert gw.wait_for_workers(2, timeout_s=120.0)
        ready = [json.loads(p.stdout.readline()) for p in procs]
        assert [r["partition_worker"] for r in ready] == [0, 1]
        for r, p in zip(ready, procs):
            assert r["partitions"] == 2 and r["replica"] == 0
            assert r["gateways"] == 1 and r["pid"] == p.pid
            assert r["device"] == "cpu" and r["staged_device"] == "cpu"
        assert sum(r["rows"] for r in ready) == 600
        got = svc.topk_vectors(qv, k=10)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert gw.stats()["rpcs"] == 2 and gw.stats()["rpc_fallbacks"] == 0
        procs[0].send_signal(signal.SIGKILL)
        t_end = time.monotonic() + 30.0
        while gw.worker_alive(0, 0) and time.monotonic() < t_end:
            time.sleep(0.01)
        assert not gw.worker_alive(0, 0)
        assert svc.registry.events("worker_lost")
        got = svc.topk_vectors(qv, k=10)
        assert np.array_equal(got[1], want[1])
    finally:
        gw.close()              # BYE: the live worker ends on its own
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        svc.close()
    assert procs[1].returncode == 0
    exit_line = json.loads(procs[1].stdout.read().strip().splitlines()[-1])
    assert exit_line["partition_worker_exit"] == 1
    assert exit_line["answered"] >= 1
    assert set(exit_line["kernel_launches"].values()) == {0}


@pytest.mark.parametrize("flags", [
    (), ("--front-ends", "2"), ("--chaos", "wire_send:frame_delay:2:3")],
    ids=["fleet", "front_ends_2", "chaos"])
def test_loadtest_over_a_socket_fleet_prints_the_jax_keys(served, capsys,
                                                          flags):
    """loadtest --transport socket --partitions 2 spawns a partition
    worker a replica behind a gateway a front end and reports the JAX
    CLI's keys; --front-ends 2 adds the tier block, --chaos the chaos
    block; no worker outlives the command."""
    from dnn_page_vectors_tpu_torch.utils import faults
    wd, ov = served["wd"], served["ov"]
    faults.reset()
    try:
        rep = _lines(capsys, _argv("loadtest", wd, ov, *LOADTEST,
                                   "--transport", "socket", "--partitions",
                                   "2", *flags))[-1]
    finally:
        faults.reset()          # the chaos plan is this process's
    for key in ("transport", "listen", "transport_totals",
                "serve_partitions", "serve_replicas", "replica_shed",
                "partitions", "fault_counters", "trials", "qps_at_p99"):
        assert key in rep, key
    assert rep["serve_partitions"] == 2
    totals = rep["transport_totals"]
    assert totals["workers_live"] == 2 and totals["rpcs"] > 0
    assert totals["rpc_fallbacks"] == 0
    trial = rep["trials"][0]
    assert trial["transport"]["rpcs"] > 0
    assert trial["transport"]["workers_live"] == 2
    if "--front-ends" in flags:
        assert rep["front_ends"] == 2
        assert rep["balance_policy"] == "round_robin"
        assert len(rep["listen"].split(",")) == 2
        assert [f["front_end"] for f in trial["front_ends"]] == [0, 1]
        assert min(trial["balance"]["sent"]) > 0
    else:
        assert "front_ends" not in rep and "front_ends" not in trial
    if "--chaos" in flags:
        chaos = rep["chaos"]
        assert set(chaos) == {"plan", "offered", "sheds", "errors",
                              "availability", "injected"}
        assert chaos["plan"] == flags[1] and chaos["errors"] == 0
        assert chaos["availability"] == 1.0
        assert chaos["injected"]["injected_wire_send_frame_delay"] == 3
    else:
        assert "chaos" not in rep
    assert _fleet_procs(wd) == []


def test_loadtest_exits_naming_the_workers_that_never_registered(
        served, tmp_path):
    """Workers that cannot reach their gateway (a persistent worker_dial
    fault, which --faults hands the workers with the rest of the config)
    never register: loadtest exits non-zero after --worker-wait-s, naming
    the (partition, replica) slots and the wait, and kills the workers."""
    from dnn_page_vectors_tpu_torch.utils import faults
    wd, ov = served["wd"], served["ov"]
    try:
        with pytest.raises(SystemExit) as ei:
            cli.main(_argv("loadtest", wd, ov, *LOADTEST, "--transport",
                           "socket", "--partitions", "2", "--replicas", "2",
                           "--faults", "worker_dial:io_error:0:*",
                           "--worker-wait-s", "1"))
    finally:
        faults.reset()
    msg = str(ei.value)
    assert ei.value.code not in (0, None)
    assert "4 of 4 partition workers did not register" in msg
    assert "[(0, 0), (0, 1), (1, 0), (1, 1)]" in msg
    assert "--worker-wait-s 1.0" in msg
    assert _fleet_procs(wd) == []


def test_partitioned_search_and_loadtest_print_the_single_views(
        served, capsys, tmp_path):
    """search --partitions 2 --replicas 2 prints what search prints
    without them (one-shot: streamed per partition; --queries: staged per
    replica); loadtest in process with them reports the partition block
    under the JAX CLI's keys."""
    wd, ov = served["wd"], served["ov"]
    flags = ("--partitions", "2", "--replicas", "2")
    qs = [served["corpus"].query_text(i) for i in (3, 8, 41)]
    (want,) = _lines(capsys, _argv("search", wd, ov, "--query", qs[0]))
    (got,) = _lines(capsys, _argv("search", wd, ov, "--query", qs[0],
                                  *flags))
    assert got == want
    path = tmp_path / "q.txt"
    path.write_text("\n".join(qs) + "\n")
    want = _lines(capsys, _argv("search", wd, ov, "--queries", str(path)))
    got = _lines(capsys, _argv("search", wd, ov, "--queries", str(path),
                               *flags))
    assert got == want and len(got) == 3
    rep = _lines(capsys, _argv("loadtest", wd, ov, *LOADTEST, *flags))[-1]
    assert rep["serve_partitions"] == 2 and rep["serve_replicas"] == 2
    assert rep["replica_shed"] == 0 and rep["partition_degraded"] == 0
    assert sum(p["rows"] for p in rep["partitions"]) == 600
    assert rep["trials"][0]["partitions"][0]["replicas"][0]["replica"] == 0


MAINT_OV = {"data.num_pages": 600, "data.trigram_buckets": 1024,
            "model.embed_dim": 16, "model.conv_channels": 32,
            "model.out_dim": 16, "eval.embed_batch_size": 128,
            "eval.store_shard_size": 256, "serve.nlist": 8,
            "serve.kmeans_iters": 3}


@pytest.mark.parametrize("command", ["migrate", "index", "maintain"])
def test_migrate_index_and_maintain_print_the_jax_keys(command, tmp_path,
                                                       capsys, monkeypatch):
    """Each command over a store the same command line embedded in each
    package (random weights): the JAX CLI's keys, and the same counts.
    `migrate` re-embeds a store stamped at another step (5) to the
    checkpoint's (0, none saved); `index` builds with --pq; `maintain
    --once` runs one pass."""
    from dnn_page_vectors_tpu import cli as jcli
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    extra = {"migrate": [], "index": ["--pq"], "maintain": ["--once"]}
    outs = []
    for pkg, main, dev in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jcli.main, [])):
        wd = tmp_path / pkg
        args = ["--config", "cdssm_toy", "--workdir", str(wd)]
        for k, v in MAINT_OV.items():
            args += ["--set", f"{k}={v}"]
        main(["embed", *args, *dev])
        if command == "migrate":
            store = VectorStore(str(wd / "store"))
            store.manifest["model_step"] = 5
            store._flush_manifest()
        capsys.readouterr()
        main([command, *args, *extra[command], *dev])
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    got, want = outs
    assert sorted(got) == sorted(want), (got, want)
    same = {"migrate": ("action", "from_step", "to_step", "units", "rows",
                        "completed", "purged_files", "store_generation"),
            "index": ("vectors", "nlist", "pq_m", "model_step",
                      "balance_cap"),
            "maintain": ()}[command]
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    if command == "migrate":
        assert (got["action"], got["to_step"], got["rows"]) == \
            ("migrated", 0, 600)
        assert VectorStore(str(tmp_path / "port" / "store")).model_steps() \
            == [0]
    if command == "index":
        assert got["pq_m"] == 2 and got["vectors"] == 600


@pytest.mark.parametrize("command", ["append", "search", "loadtest"])
def test_filtered_commands_print_the_jax_keys(command, tmp_path, capsys,
                                              monkeypatch):
    """The filtered-retrieval flags in each package over a store the same
    command line embedded (random weights) and grew by 50 pages with
    `append --init-attrs --attrs lang=3 site=wiki.org`: the append prints
    the JAX CLI's keys and stamps only the appended rows; `search --queries
    --filter lang==3` answers from appended rows only, in the JAX CLI's
    line shape; `loadtest --filters` reports the JAX CLI's scenario list
    and a filter_scenarios block a trial."""
    from dnn_page_vectors_tpu import cli as jcli
    from dnn_page_vectors_tpu_torch.index import attrs
    from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    word = attrs.pack_word(lang=3, site="wiki.org")
    qfile = tmp_path / "q.txt"
    qfile.write_text("first query\nsecond one here\n")
    extra = {"search": ["--queries", str(qfile), "--filter", "lang==3"],
             "loadtest": [*LOADTEST, "--filters"]}
    outs = {}
    for pkg, main, dev in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jcli.main, [])):
        wd = tmp_path / pkg
        args = ["--config", "cdssm_toy", "--workdir", str(wd)]
        for k, v in MAINT_OV.items():
            args += ["--set", f"{k}={v}"]
        main(["embed", *args, *dev])
        capsys.readouterr()
        main(["append", *args, "--set", "data.num_pages=650",
              "--init-attrs", "--attrs", "lang=3", "site=wiki.org", *dev])
        app = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        app.pop("fault_counters", None)
        outs[pkg] = [app]
        if command != "append":
            main([command, *args, "--set", "data.num_pages=650",
                  *extra[command], *dev])
            outs[pkg].append([json.loads(ln) for ln in
                              capsys.readouterr().out.strip().splitlines()])
        store = VectorStore(str(wd / "store"))
        got = {}
        for e in store.shards():
            for pid, w in zip(store.load_ids(e), store.load_attrs(e)):
                got[int(pid)] = int(w)
        assert got == {i: (word if i >= 600 else 0) for i in range(650)}
    (papp, *prest), (japp, *jrest) = outs["port"], outs["jax"]
    assert sorted(papp) == sorted(japp), (papp, japp)
    assert (papp["appended"], papp["generation"], papp["store_vectors"]) \
        == (japp["appended"], japp["generation"], japp["store_vectors"]) \
        == (50, 1, 650)
    if command == "search":
        (plines,), (jlines,) = prest, jrest
        assert [sorted(x) for x in plines] == [sorted(x) for x in jlines]
        for line in plines + jlines:
            assert line["results"]
            assert all(r["page_id"] >= 600 for r in line["results"])
            assert sorted(line["results"][0]) == ["page_id", "score",
                                                  "snippet"]
    if command == "loadtest":
        (prep,), (jrep,) = prest[0][-1:], jrest[0][-1:]
        assert prep["filters"] == [list(f) if isinstance(f, tuple) else f
                                   for f in jrep["filters"]]
        for rep in (prep, jrep):
            blocks = [t["filter_scenarios"] for t in rep["trials"]]
            assert blocks and all(set(b) <= {"unfiltered", "lang", "site",
                                             "recent"} for b in blocks)
            assert all(sorted(v) == ["p50_ms", "p99_ms", "qps", "requests"]
                       for b in blocks for v in b.values())
