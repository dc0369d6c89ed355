"""The port's background maintenance (maintenance/service.py, the
deferred IVF rebuild of index/ivf.py, SearchService.start_maintenance)
against the JAX package's, on the CPU: one run_once of each pillar; a
drift rebuild deferred off ``update`` and built by the rebuild pillar in
ivf-0001, whose posting files are byte for byte JAX's (centroids within
1e-5, as tests/test_torch_index.py holds builds) and whose seeded build
equals the same build in ivf byte for byte; the pointer flipped as JAX
flips it; the janitor keeps the old index for one pass; the autoscaler
decides as JAX's on the same telemetry windows; `maintain --once` prints
JAX's keys; and a live service migrates under a query hammer with every
answer right, judged by counts and generations, never by the clock."""
import json
import os
import shutil
import threading
import zlib

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.index.ivf import IVFIndex as JaxIndex
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.maintenance.service import (
    MaintenanceService as JaxMaintenance)
from dnn_page_vectors_tpu.utils import faults as jfaults
from dnn_page_vectors_tpu.utils import telemetry as jtelemetry
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.maintenance.service import (
    MaintenanceService, _next_index_dirname)
from dnn_page_vectors_tpu_torch.utils import faults, telemetry

N, DIM, NLIST = 400, 32, 12
SHARDS = ((0, 160), (160, 320), (320, 400))
OV = {"serve.nlist": NLIST, "serve.kmeans_iters": 4, "data.seed": 0}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    for mod in (faults, jfaults):
        mod.reset()
    telemetry.reset_default()
    jtelemetry.reset_default()
    yield


@pytest.fixture(scope="module")
def mesh():
    from dnn_page_vectors_tpu.config import MeshConfig
    from dnn_page_vectors_tpu.parallel.mesh import make_mesh
    return make_mesh(MeshConfig(data=1))


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


_RNG = np.random.default_rng(3)
VECS = _unit(_RNG.normal(size=(12, DIM))[_RNG.integers(0, 12, N + 150)]
             + 0.3 * _RNG.normal(size=(N + 150, DIM)))


def _write(d):
    store = VectorStore(d, dim=DIM, shard_size=160)
    store.ensure_model_step(1)
    for i, (lo, hi) in enumerate(SHARDS):
        store.write_shard(i, np.arange(lo, hi, dtype=np.int64), VECS[lo:hi])
    return store


def _append(d, lo, hi, tombstones=()):
    store = VectorStore(d)
    w = store.begin_generation(tombstones=tombstones)
    if hi > lo:
        w.write_shard(np.arange(lo, hi, dtype=np.int64), VECS[lo:hi])
    w.commit()


def _bytes(d, names=None):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))
            if n.endswith(".npy") and (names is None or n in names)}


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man.pop("build_seconds", None)
    man.get("pq", {}).pop("train_seconds", None)
    return man


# -- the rebuild pillar ---------------------------------------------------------

def test_next_index_dirname():
    assert _next_index_dirname("ivf") == "ivf-0001"
    assert _next_index_dirname("ivf-0009") == "ivf-0010"


def test_deferred_rebuild_builds_beside_flips_and_equals_jax(tmp_path, mesh):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    for d in (port, ref):
        _write(d)
    cfg = get_config("cdssm_toy", OV)
    jcfg = jax_get_config("cdssm_toy", OV)
    # each package's index over the base, then an append to a drift of
    # 0.27, past the 0.25 limit, and the deferred update
    IVFIndex.build(VectorStore(port), nlist=NLIST, iters=4, seed=0,
                   device="cpu")
    JaxIndex.build(JaxStore(ref), mesh, nlist=NLIST, iters=4, seed=0)
    for d in (port, ref):
        _append(d, N, N + 150)
    idx, info = IVFIndex.update(VectorStore(port), defer_rebuild=True,
                                nlist=NLIST, iters=4, device="cpu")
    jidx, jinfo = JaxIndex.update(JaxStore(ref), mesh, defer_rebuild=True,
                                  nlist=NLIST, iters=4)
    for k in ("action", "new_shards", "appended_rows", "drift",
              "rebuild_pending", "index_generation"):
        assert info[k] == jinfo[k], k
    assert info["action"] == "incremental" and info["rebuild_pending"]
    assert idx.index_generation == 1
    # the rebuild pillar of each package builds ivf-0001 and flips to it
    out = MaintenanceService(cfg, port, device="cpu").run_once()
    jout = JaxMaintenance(jcfg, ref, mesh).run_once()
    assert sorted(out) == sorted(jout) == ["rebuild"]
    rb, jrb = out["rebuild"], jout["rebuild"]
    assert rb["dirname"] == jrb["dirname"] == "ivf-0001"
    assert rb["reason"] == jrb["reason"] and rb["nlist"] == jrb["nlist"]
    assert VectorStore(port).index_dirname == JaxStore(ref).index_dirname \
        == "ivf-0001"
    pd, jd = os.path.join(port, "ivf-0001"), os.path.join(ref, "ivf-0001")
    posting = [n for n in os.listdir(pd) if n.startswith("posting_")]
    assert len(posting) == 8
    assert _bytes(pd, posting) == _bytes(jd, posting)
    np.testing.assert_allclose(np.load(os.path.join(pd, "centroids.npy")),
                               np.load(os.path.join(jd, "centroids.npy")),
                               rtol=0, atol=1e-5)
    pm, jm = _manifest(pd), _manifest(jd)
    for m in (pm, jm):
        m.pop("centroids")
    assert pm == jm
    # each package opens the other's flipped index
    assert JaxIndex.open(JaxStore(port)).nlist == NLIST
    assert IVFIndex.open(VectorStore(ref), device="cpu").nlist == NLIST
    # the old index waits one pass for the janitor, then goes
    assert os.path.isdir(os.path.join(port, "ivf"))
    again = MaintenanceService(cfg, port, device="cpu").run_once()
    assert again["janitor"]["index_dirs_removed"] == 1
    assert not os.path.exists(os.path.join(port, "ivf"))
    assert os.path.isdir(pd) and "rebuild" not in again


def test_a_seeded_build_in_ivf_0001_equals_the_build_in_ivf(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for d in (a, b):
        _write(d)
    IVFIndex.build(VectorStore(a), nlist=NLIST, iters=4, seed=0, pq_m=8,
                   device="cpu")
    IVFIndex.build(VectorStore(b), nlist=NLIST, iters=4, seed=0, pq_m=8,
                   device="cpu", dirname="ivf-0001")
    assert not os.path.exists(os.path.join(b, "ivf"))
    ia, ib = os.path.join(a, "ivf"), os.path.join(b, "ivf-0001")
    assert _bytes(ia) == _bytes(ib) and len(_bytes(ia)) == 12
    assert _manifest(ia) == _manifest(ib)


def test_defer_rebuild_refuses_a_structural_rebuild(tmp_path, mesh):
    from dnn_page_vectors_tpu.index.ivf import (
        IndexUnavailable as JaxUnavailable)
    from dnn_page_vectors_tpu_torch.index.ivf import IndexUnavailable
    d = str(tmp_path / "s")
    _write(d)
    with pytest.raises(IndexUnavailable, match="deferred"):
        IVFIndex.update(VectorStore(d), defer_rebuild=True, device="cpu")
    with pytest.raises(JaxUnavailable, match="deferred"):
        JaxIndex.update(JaxStore(d), mesh, defer_rebuild=True)
    assert not os.path.exists(os.path.join(d, "ivf"))


def test_a_service_defers_the_drift_rebuild_to_its_rebuild_pillar(tmp_path):
    """refresh() under start_maintenance appends to the index and raises
    serve.index_rebuild_pending; the pillar's pass clears it, counts a
    rebuild and serves the new index generation."""

    class _Emb:
        device = torch.device("cpu")
        query_tok = object()
        model = torch.nn.Identity()

    d = str(tmp_path / "s")
    _write(d)
    IVFIndex.build(VectorStore(d), nlist=NLIST, iters=4, seed=0,
                   device="cpu")
    cfg = get_config("cdssm_toy", {**OV, "serve.index": "ivf",
                                   "model.out_dim": DIM})
    svc = SearchService(cfg, _Emb(), None, VectorStore(d))
    maint = svc.start_maintenance(threads=False)
    gauge = svc.registry.gauge("serve.index_rebuild_pending")
    _append(d, N, N + 150)
    info = svc.refresh()
    assert info["index_update"]["rebuild_pending"] and gauge.value == 1.0
    assert svc.full_rebuilds == 0 and svc.index.index_generation == 1
    out = maint.run_once()
    assert out["rebuild"]["dirname"] == "ivf-0001"
    assert gauge.value == 0.0 and svc.full_rebuilds == 1
    assert svc.index.index_generation == 0
    assert svc._view.store.index_dirname == "ivf-0001"
    s, i = svc.topk_vectors(VECS[N: N + 4], k=3)
    assert i[:, 0].tolist() == list(range(N, N + 4))
    svc.close()


# -- the other pillars ------------------------------------------------------------

def test_one_pass_of_the_janitor_and_the_compactor(tmp_path, mesh):
    """Each package's run_once over equal stores: an expired lease, an
    index directory the pointer left, an unreferenced migration unit
    directory, and a chain past the compaction trigger."""
    outs = []
    for pkg in ("port", "jax"):
        d = str(tmp_path / pkg)
        _write(d)
        _append(d, N, N + 20, tombstones=range(0, 120))
        with open(os.path.join(d, "append.lease.json"), "w") as f:
            json.dump({"token": "t", "owner": "gone", "acquired": 0.0,
                       "expires": 1.0, "cursor": 0}, f)
        os.makedirs(os.path.join(d, "ivf-0003"))
        os.makedirs(os.path.join(d, "migrate-9-0000"))
        ov = {**OV, "maintenance.compact_tombstone_density": 0.2}
        if pkg == "port":
            out = MaintenanceService(get_config("cdssm_toy", ov), d,
                                     device="cpu").run_once()
            store = VectorStore(d)
        else:
            out = JaxMaintenance(jax_get_config("cdssm_toy", ov), d,
                                 mesh).run_once()
            store = JaxStore(d)
        assert store.compacted_through == 1 and store.num_vectors == 300
        assert not os.path.exists(os.path.join(d, "gen-0001"))
        assert not os.path.exists(os.path.join(d, "append.lease.json"))
        outs.append(out)
    got, want = outs
    assert sorted(got) == sorted(want) == ["compaction", "janitor"]
    assert got["janitor"] == want["janitor"] == {
        "lease_expired": True, "index_dirs_removed": 1,
        "migrate_dirs_removed": 1, "purged_dirs": 0, "purged_files": 0}
    drop = ("seconds", "compact_docs_per_s")
    assert {k: v for k, v in got["compaction"].items() if k not in drop} \
        == {k: v for k, v in want["compaction"].items() if k not in drop}
    assert faults.counters()["store_compactions"] == 1
    assert faults.counters()["lease_expired"] == 1


def test_a_pillar_error_is_counted_and_never_kills_the_pass(tmp_path):
    d = str(tmp_path / "s")
    _write(d)
    _append(d, N, N + 20, tombstones=range(0, 120))
    faults.install(faults.FaultPlan.parse("compact_swap_dump:io_error:0:*"))
    faults.configure_retry(2, 0.0, 0.0)
    ms = MaintenanceService(get_config("cdssm_toy", OV), d, device="cpu")
    out = ms.run_once()
    assert "InjectedFault" in out["compaction"]["error"]
    assert faults.counters()["maintenance_compaction_errors"] == 1
    assert ms.stats()["passes"]["compaction"] == 1
    faults.install(faults.FaultPlan())
    assert ms.run_once()["compaction"]["action"] == "compacted"
    ms.start()
    ms.pause()
    assert ms.drain(5.0)
    ms.resume()
    ms.close()


class _Clock:
    t = 0.0

    def __call__(self):
        return self.t


class _FakeSvc:
    _fanout = None

    def __init__(self, registry):
        self.registry = registry
        self.sig = {}

    def autoscale_signals(self):
        return dict(self.sig)


def test_the_autoscaler_decides_as_jax_on_the_same_windows(tmp_path, mesh):
    d = str(tmp_path / "s")
    _write(d)
    windows = [  # (queue p99 ms, samples, shed rate, seconds later)
        (80.0, 10, 0.0, 0), (80.0, 2, 0.0, 40), (10.0, 10, 0.9, 40),
        (90.0, 10, 0.0, 5), (1.0, 10, 0.0, 40), (1.0, 10, 0.0, 40),
        (3.0, 8, 0.0, 40), (60.0, 9, 0.0, 40), (60.0, 9, 0.0, 40)]
    runs = []
    ov = {**OV, "maintenance.autoscale": True,
          "maintenance.autoscale_max_workers": 3}
    for pkg in ("port", "jax"):
        if pkg == "port":
            reg = telemetry.MetricsRegistry()
            svc = _FakeSvc(reg)
            ms = MaintenanceService(get_config("cdssm_toy", ov), d,
                                    device="cpu", svc=svc)
        else:
            reg = jtelemetry.MetricsRegistry()
            svc = _FakeSvc(reg)
            ms = JaxMaintenance(jax_get_config("cdssm_toy", ov), d, mesh,
                                svc=svc)
        clock, size, calls = _Clock(), [2], []
        ms._clock = clock

        def spawn(i, size=size, calls=calls):
            calls.append(("spawn", i))
            size[0] += 1

        def drain(i, size=size, calls=calls):
            calls.append(("drain", i))
            size[0] -= 1
        ms.attach_scaler(spawn, drain, size=lambda size=size: size[0])
        out = []
        for p99, n, shed, dt in windows:
            clock.t += dt
            svc.sig = {"queue_wait_p99_ms": p99, "queue_wait_samples": n,
                       "shed_rate": shed, "window_s": 10.0}
            out.append(ms._autoscale_once())
        runs.append((out, calls, [e["event"] for e in reg.events()],
                     reg.counter("maintenance.autoscale_decisions").value))
    assert runs[0] == runs[1]
    out, calls, events, decisions = runs[0]
    assert calls and decisions == len(calls)
    assert "autoscale_up" in events and "autoscale_down" in events


def test_maintain_once_prints_the_jax_keys(tmp_path, capsys, monkeypatch):
    from dnn_page_vectors_tpu import cli as jcli
    from dnn_page_vectors_tpu_torch import cli
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    got = []
    for pkg, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, [])):
        wd = tmp_path / pkg
        _write(str(wd / "store"))
        _append(str(wd / "store"), N, N + 20, tombstones=range(0, 120))
        main(["maintain", "--config", "cdssm_toy", "--workdir", str(wd),
              "--once", "--set", "maintenance.compact_tombstone_density=0.2",
              *extra])
        got.append(json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1]))
    port, ref = got
    assert sorted(port) == sorted(ref)
    assert sorted(port["compaction"]) == sorted(ref["compaction"])
    assert port["compaction"]["action"] == "compacted"
    assert port["fault_counters"]["store_compactions"] == 1


# -- the migrator, live --------------------------------------------------------------

SDIM, SSHARD = 24, 40


def _vec(text, step):
    seed = zlib.crc32(f"{int(step)}|{text}".encode()) & 0xFFFFFFFF
    v = np.random.default_rng(seed).standard_normal(SDIM).astype(np.float32)
    return v / np.linalg.norm(v)


class _Corpus:
    def page_text(self, i):
        return f"page {int(i)}"


class _Pages:
    def __init__(self, step):
        self.step = step
        self.model = torch.nn.Identity()

    def embed_texts(self, texts, tower="page", batch_size=None):
        return np.stack([_vec(t, self.step) for t in texts])


def _stub_store(d, nbase=3, gen_rows=20):
    store = VectorStore(d, dim=SDIM, shard_size=SSHARD)
    store.ensure_model_step(1)
    for si in range(nbase):
        ids = np.arange(si * SSHARD, (si + 1) * SSHARD, dtype=np.int64)
        store.write_shard(si, ids, _Pages(1).embed_texts(
            [f"page {i}" for i in ids]))
    _stub_append(d, gen_rows)


def _stub_append(d, rows):
    store = VectorStore(d)
    lo = store.next_page_id()
    ids = np.arange(lo, lo + rows, dtype=np.int64)
    w = store.begin_generation()
    w.write_shard(ids, _Pages(1).embed_texts([f"page {i}" for i in ids]))
    w.commit()


def test_a_live_service_migrates_under_a_query_hammer(tmp_path):
    """request_migration, then run_once passes on a serving store while
    two threads search without pause and an append lands mid-sweep (a
    new pending unit). Between passes the main thread waits for the
    hammer to finish more searches (a count, not a sleep). Every answer's
    top hit is the page itself, no search fails, and the flips move the
    view's generation as the epoch says."""

    class _Emb:
        device = torch.device("cpu")
        query_tok = object()
        model = torch.nn.Identity()

    d = str(tmp_path / "s")
    _stub_store(d)                                   # 140 rows
    cfg = get_config("cdssm_toy", {"model.out_dim": SDIM,
                                   "serve.result_cache": True})
    svc = SearchService(cfg, _Emb(), _Corpus(), VectorStore(d))

    def _step(queries, step):
        use = svc.store.model_step if step is None else step
        return torch.from_numpy(np.stack([_vec(q, use) for q in queries]))
    svc._embed_queries_step = _step
    maint = svc.start_maintenance(threads=False)
    target = _Pages(2)
    maint.request_migration(2, _Corpus(), target)
    assert list(svc._towers) == [2]

    stop = threading.Event()
    cond = threading.Condition()
    stats = {"total": 0, "right": 0, "errors": 0, "steps": set()}

    def hammer(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            pid = int(rng.integers(0, 140))
            try:
                steps = tuple(svc._view.steps)
                hits = svc.search(f"page {pid}", k=10)
                ok = int(hits[0]["page_id"]) == pid
            except Exception:  # noqa: BLE001 -- counted
                ok, steps = None, ()
            with cond:
                if ok is None:
                    stats["errors"] += 1
                else:
                    stats["total"] += 1
                    stats["right"] += int(ok)
                    stats["steps"].add(steps)
                cond.notify_all()

    def wait_for(more):
        with cond:
            want = stats["total"] + stats["errors"] + more
            assert cond.wait_for(
                lambda: stats["total"] + stats["errors"] >= want,
                timeout=120)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in (0, 1)]
    for t in threads:
        t.start()
    passes, gens = [], [svc._view.generation]
    try:
        for _ in range(10):
            wait_for(20)
            out = maint.run_once().get("migrate")
            if out is None:
                break
            passes.append(out)
            gens.append(svc._view.generation)
            if out["action"] == "completed":
                break
            if len(passes) == 1:
                _stub_append(d, 10)                  # mid-sweep, old stamp
        wait_for(20)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert [p["action"] for p in passes] == ["migrating"] * 3 + ["completed"]
    assert [p["units"] for p in passes[:3]] == [[0], [1], [2]]
    assert all(p["refresh_swap_ms"] is not None for p in passes)
    # the superseded vec and ids files, once the view moved: 3 base shards,
    # then one a generation
    assert [p["purged"]["purged_files"] for p in passes[:3]] == [6, 2, 2]
    assert stats["errors"] == 0 and stats["total"] >= 100
    assert stats["right"] == stats["total"]
    assert (1, 2) in stats["steps"] and (2,) in stats["steps"]
    # generation = generations + migration epoch: begin and unit 0, then
    # unit 1 (with the appended generation), unit 2, the completion
    assert gens == [1, 3, 5, 6, 7] and svc._view.generation == 7
    store = VectorStore(d)
    assert store.model_step == 2 and store.model_steps() == [2]
    assert store.migration is None and store.num_vectors == 150
    assert svc._towers == {} and svc.embedder.model is target.model
    assert svc._view.steps == [2]
    reg = maint.registry
    assert reg.counter("maintenance.migrations").value == 1
    assert reg.gauge("migrate.generations_done").value >= 1
    names = {e["event"] for e in reg.events()}
    assert {"migration_started", "migration_generation_done",
            "migration_complete"} <= names
    assert not [p for p in os.listdir(d) if p.startswith("shard_")]
    svc.close()
