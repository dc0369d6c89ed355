"""Partitioned and replicated serving in one process (infer/partition.py)
of the port against the JAX package on the CPU, model-free through
``topk_vectors`` (the query tower is a stand-in), on one seeded store of 6
shards of 50 unit vectors of dim 32 that both packages open:

* ``partition_shard_ranges`` and ``make_partition_specs`` equal JAX's
  exactly (P above the shard count too); ``merge_partition_topk`` equals
  JAX's exactly on seeded inputs with ties and empty slots;
* a PartitionSet at P in {1, 2, 3} x R in {1, 2} gives the JAX service's
  partitioned ``topk_vectors`` and the port's own single view: ids equal,
  scores within 1e-6; the same with tombstones, and with a PQ index at
  full probe while one partition serves the exact fallback;
* ``IVFIndex.partition_view`` gives the JAX view's results and stats on
  the same index files, and ``stage_hot`` pins per partition the lists
  JAX pins;
* routing sheds off a restaging, degraded or over-budget primary with
  JAX's counters and events (on changes of state only); no result set
  mixes generations under a partitioned refresh with appends; ``simulate``
  returns its critical path and scan bytes as JAX's does; the trial
  record carries the partition block under JAX's keys; ``resize(2 -> 3
  -> 2)`` publishes one table each time with the results unchanged."""
import dataclasses
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.index.ivf import IVFIndex as JaxIndex
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.utils import faults as jax_faults
from dnn_page_vectors_tpu.utils import telemetry as jax_telemetry
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
from dnn_page_vectors_tpu_torch.infer.partition import (
    PartitionSpec, make_partition_specs)
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.ops.topk import merge_partition_topk
from dnn_page_vectors_tpu_torch.parallel.multihost import (
    partition_shard_ranges)
from dnn_page_vectors_tpu_torch.utils import telemetry

DIM = 32
SHARD = 50
NSHARDS = 6
ROWS = SHARD * NSHARDS
NLIST = 8
PQ_M = 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests: pytest-xdist workers
    share the host's cores, and more threads per worker only contend (the
    replicas run threads of their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registries():
    for mod in (telemetry, jax_telemetry):
        mod.reset_default()
    jax_faults.reset()
    yield
    for mod in (telemetry, jax_telemetry):
        mod.reset_default()
    jax_faults.reset()


def _vecs(seed=0, n=ROWS):
    v = np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _qv(n=4, seed=1):
    return _vecs(seed, n)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("partition") / "store")
    store = VectorStore(d, dim=DIM, shard_size=SHARD)
    store.ensure_model_step(0)
    vecs = _vecs()
    for si in range(NSHARDS):
        lo, hi = si * SHARD, (si + 1) * SHARD
        store.write_shard(si, np.arange(lo, hi, dtype=np.int64),
                          vecs[lo:hi])
    return d


@pytest.fixture(scope="module")
def mesh():
    from dnn_page_vectors_tpu.config import MeshConfig
    from dnn_page_vectors_tpu.parallel.mesh import make_mesh
    return make_mesh(MeshConfig(data=1))


@pytest.fixture(scope="module")
def pq_dir(store_dir, mesh, tmp_path_factory):
    """The store with the JAX package's IVF-PQ index beside it."""
    d = str(tmp_path_factory.mktemp("partition_pq") / "store")
    shutil.copytree(store_dir, d)
    JaxIndex.build(JaxStore(d), mesh, nlist=NLIST, iters=5, seed=0,
                   pq_m=PQ_M)
    return d


def _copy(src, tmp_path, name="copy"):
    d = str(tmp_path / name)
    shutil.copytree(src, d)
    return d


class _Tok:
    def encode_batch(self, texts):
        out = np.zeros((len(texts), 4), np.int32)
        for r, t in enumerate(texts):
            for c, w in enumerate(t.split()[:4]):
                out[r, c] = 1 + sum(w.encode()) % 997
        return out


class _StubEmbedder:
    """The query tower's stand-in: token ids -> unit vectors through a
    fixed random table."""

    def __init__(self):
        g = torch.Generator().manual_seed(0)
        self.table = torch.randn(1000, DIM, generator=g)
        self.table[0] = 0
        self.query_tok = _Tok()
        self.device = torch.device("cpu")

    def encode_queries(self, ids):
        v = self.table[ids.long()].sum(1)
        return v / v.norm(dim=1, keepdim=True).clamp_min(1e-6)


class _Corpus:
    def page_text(self, i):
        return f"page {int(i)}"


def _service(d, **serve):
    cfg = get_config("cdssm_toy", {
        "model.out_dim": DIM, **{f"serve.{k}": v for k, v in serve.items()}})
    return SearchService(cfg, _StubEmbedder(), _Corpus(), VectorStore(d))


def _jax_service(d, mesh, **serve):
    from dnn_page_vectors_tpu.infer.partition_host import MeshEmbedder
    from dnn_page_vectors_tpu.infer.serve import SearchService as JaxService
    cfg = jax_get_config("cdssm_toy", {"model.out_dim": DIM})
    if serve:
        cfg = cfg.replace(serve=dataclasses.replace(cfg.serve, **serve))
    return JaxService(cfg, MeshEmbedder(mesh), None, JaxStore(d),
                      preload_hbm_gb=4.0)


def _same_topk(got_s, got_i, want_s, want_i, atol=1e-6):
    """Scores within `atol`; ids equal except where two scores tie within
    1e-6; an empty slot (-inf) the same in both."""
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    filled = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), filled)
    np.testing.assert_allclose(got_s[filled], want_s[filled], rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(got_i[~filled], want_i[~filled])
    differ = (got_i != want_i) & filled
    assert (np.abs(got_s[differ] - want_s[differ]) <= 1e-6).all()


# -- the split and the merge --------------------------------------------------

COUNTS = ([64] * 6, [100, 1, 1, 1, 1, 100], [5, 90, 5, 90, 5, 90],
          [1, 2, 3, 4, 5, 6, 7, 8], [50, 50, 100, 50, 50], [7], [],
          [0, 0, 30, 0, 12])


@pytest.mark.parametrize("counts", COUNTS,
                         ids=lambda c: "_".join(map(str, c)) or "none")
@pytest.mark.parametrize("parts", [1, 2, 3, 4, 99])
def test_shard_ranges_and_specs_equal_jax(counts, parts):
    from dnn_page_vectors_tpu.infer.partition import (
        make_partition_specs as jax_specs)
    from dnn_page_vectors_tpu.parallel.multihost import (
        partition_shard_ranges as jax_ranges)
    got = partition_shard_ranges(counts, parts)
    assert got == jax_ranges(counts, parts)
    if counts:
        assert got[0][0] == 0 and got[-1][1] == len(counts)
        assert all(lo < hi for lo, hi in got)
        assert len(got) == min(parts, len(counts))
    entries = [{"index": 10 + i, "count": c} for i, c in enumerate(counts)]
    specs = make_partition_specs(entries, parts, hot_gb=3.0)
    want = jax_specs(entries, parts, hot_gb=3.0)
    assert [dataclasses.asdict(s) for s in specs] == \
        [dataclasses.asdict(s) for s in want]
    if sum(counts):
        assert abs(sum(s.hot_gb for s in specs) - 3.0) < 1e-9


@pytest.mark.parametrize("parts", [1, 2, 3, 5])
def test_merge_partition_topk_equals_jax(parts):
    from dnn_page_vectors_tpu.ops.topk import (
        merge_partition_topk as jax_merge)
    rng = np.random.default_rng(parts)
    nq, k = 7, 6
    sets = []
    for p in range(parts):
        # scores on a coarse grid (ties across partitions), sorted per
        # row, with empty slots (-inf / -1) at the tail of some rows
        s = np.sort(rng.integers(0, 5, (nq, k)).astype(np.float32) / 4,
                    axis=1)[:, ::-1].copy()
        i = rng.permutation(1000)[: nq * k].reshape(nq, k).astype(np.int64) \
            + 1000 * p
        cut = rng.integers(0, k + 1, nq)
        for r, c in enumerate(cut):
            s[r, c:], i[r, c:] = -np.inf, -1
        sets.append((s, i))
    got_s, got_i = merge_partition_topk(sets)
    want_s, want_i = jax_merge(sets)
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    assert got_s.dtype == np.float32 and got_i.dtype == np.int64
    with pytest.raises(ValueError, match="at least one partition"):
        merge_partition_topk([])


# -- the scatter-gather against JAX and the single view ----------------------

@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("partitions", [1, 2, 3])
def test_partitioned_topk_equals_jax_and_the_single_view(
        store_dir, mesh, partitions, replicas):
    qv = _qv(5, seed=2)
    one = _service(store_dir)
    svc = _service(store_dir, partitions=partitions, replicas=replicas)
    jsvc = _jax_service(store_dir, mesh, partitions=partitions,
                        replicas=replicas)
    try:
        s1, i1 = one.topk_vectors(qv, k=10)
        s, i = svc.topk_vectors(qv, k=10)
        js, ji = jsvc.topk_vectors(qv, k=10)
        _same_topk(s, i, s1, i1)
        _same_topk(s, i, js, ji)
        pset = svc.partition_set
        if partitions * replicas == 1:
            assert pset is None and jsvc.partition_set is None
            return
        jset = jsvc.partition_set
        assert (pset.partitions, pset.replicas) == \
            (jset.partitions, jset.replicas) == (partitions, replicas)
        assert [s_.shard_indices for s_ in pset.specs()] == \
            [s_.shard_indices for s_ in jset.specs()]
        # the text path: encoded once, then the scatter
        texts = ["alpha beta", "gamma", "delta eps zeta"]
        assert svc.search_many(texts, k=5) == one.search_many(texts, k=5)
        met = svc.metrics()
        assert met["serve_partitions"] == partitions
        assert met["serve_replicas"] == replicas
        assert sum(p["rows"] for p in met["partitions"]) == ROWS
        assert [s_ for p in met["partitions"] for s_ in p["shards"]] == \
            list(range(NSHARDS))
        assert all(len(p["replicas"]) == replicas
                   for p in met["partitions"])
        assert met["replica_shed"] == met["partition_degraded"] == 0
        assert svc.search_many([], k=5) == []
        # every replica holds a view of its own, staged over its range
        for reps in pset._parts:
            views = [r.view for r in reps]
            assert len({id(v) for v in views}) == replicas
            for v in views:
                assert v.restricted and v.pages is not None
                assert v.pages.shape[0] == sum(e["count"]
                                               for e in v.entries)
    finally:
        for x in (one, svc, jsvc):
            x.close()


def test_partitioned_tombstones_equal_jax(store_dir, mesh, tmp_path):
    d = _copy(store_dir, tmp_path)
    dead = [3, 42, 123, 250, 299]
    w = VectorStore(d).begin_generation(tombstones=dead)
    w.commit()
    qv = np.concatenate([_vecs()[dead], _qv(3, seed=4)])
    one = _service(d)
    svc = _service(d, partitions=3, replicas=2)
    jsvc = _jax_service(d, mesh, partitions=3, replicas=2)
    try:
        s1, i1 = one.topk_vectors(qv, k=10)
        s, i = svc.topk_vectors(qv, k=10)
        js, ji = jsvc.topk_vectors(qv, k=10)
        _same_topk(s, i, s1, i1)
        _same_topk(s, i, js, ji)
        assert not set(i.ravel().tolist()) & set(dead)
        assert svc.num_vectors == ROWS - len(dead)
    finally:
        for x in (one, svc, jsvc):
            x.close()


def test_partitioned_pq_and_exact_fallback_equal_jax(pq_dir, mesh, tmp_path):
    """Full probe with a full re-rank makes the ADC path exact, and a
    partition whose index is gone serves the exact fallback: mixed across
    partitions, the results are still the exact single view's and JAX's."""
    qv = _qv(6, seed=5)
    knobs = {"partitions": 2, "index": "ivf", "nprobe": 10_000,
             "pq_rerank": ROWS}
    exact = _service(pq_dir)
    svc = _service(pq_dir, **knobs)
    jsvc = _jax_service(pq_dir, mesh, **knobs)
    try:
        want_s, want_i = exact.topk_vectors(qv, k=10)
        js, ji = jsvc.topk_vectors(qv, k=10)
        s, i = svc.topk_vectors(qv, k=10)
        _same_topk(s, i, want_s, want_i, atol=1e-5)
        _same_topk(s, i, js, ji, atol=1e-5)
        pset = svc.partition_set
        for reps, jreps in zip(pset._parts, jsvc.partition_set._parts):
            idx = reps[0].view.index
            assert idx is not None
            assert set(idx._postings) == set(reps[0].spec.shard_indices)
            assert set(idx._postings) == set(jreps[0].view.index._postings)
        assert svc.ann_fallbacks == 0 and svc.ann_lists_scanned > 0
        # partition 1 loses its index: it serves exact (a degraded view
        # in the port: the streaming sweep), partition 0 stays on ADC
        for rep in pset._parts[1]:
            rep.view.index = None
        for rep in jsvc.partition_set._parts[1]:
            rep.view.index = None
        s, i = svc.topk_vectors(qv, k=10)
        js, ji = jsvc.topk_vectors(qv, k=10)
        _same_topk(s, i, want_s, want_i, atol=1e-5)
        _same_topk(s, i, js, ji, atol=1e-5)
        assert svc.ann_fallbacks == len(qv) == jsvc.ann_fallbacks
        assert svc.partition_degraded_serves == 1
        assert svc.registry.events("partition_degraded")[-1]["attrs"] == \
            {"partition": 1, "replica": 0}
    finally:
        for x in (exact, svc, jsvc):
            x.close()


# -- the index's partition views ---------------------------------------------

@pytest.mark.parametrize("shards", [(0, 1, 2), (3,), (4, 5)])
def test_partition_view_equals_jax(pq_dir, shards):
    port = IVFIndex.open(VectorStore(pq_dir), device="cpu")
    ref = JaxIndex.open(JaxStore(pq_dir))
    pv, jv = port.partition_view(shards), ref.partition_view(shards)
    assert set(pv._postings) == set(jv._postings) == set(shards)
    np.testing.assert_array_equal(pv.list_sizes, jv.list_sizes)
    assert int(pv.list_sizes.sum()) == SHARD * len(shards)
    assert pv.centroids is port.centroids and pv.pq is port.pq
    qv = _qv(5, seed=7)
    for nprobe in (1, 3, NLIST):
        s, i, st = pv.search(qv, 10, nprobe=nprobe)
        js, ji, jst = jv.search(qv, 10, nprobe=nprobe)
        _same_topk(s, i, js, ji, atol=1e-5)
        assert st == jst, nprobe
        ids = i[i >= 0]
        assert ((ids // SHARD)[:, None] == np.array(shards)).any(1).all()
    np.testing.assert_array_equal(pv.scan_counts, jv.scan_counts)
    # the parent's accounting is untouched
    assert port.stats["searches"] == 0 and port.scan_counts.sum() == 0


def test_stage_hot_per_partition_equals_jax(pq_dir, mesh):
    gb = 0.5 * ROWS * (PQ_M + 4) / 2 ** 30
    knobs = {"partitions": 3, "index": "ivf", "nprobe": 2,
             "hot_postings_gb": gb}
    svc = _service(pq_dir, **knobs)
    jsvc = _jax_service(pq_dir, mesh, **knobs)
    try:
        staged = 0
        for reps, jreps in zip(svc.partition_set._parts,
                               jsvc.partition_set._parts):
            spec = reps[0].spec
            assert spec.hot_gb == jreps[0].spec.hot_gb
            ph, jh = reps[0].view.index._hot, jreps[0].view.index._hot
            np.testing.assert_array_equal(ph["lists"], jh["lists"])
            assert ph["rows"] == jh["rows"] and ph["bytes"] == jh["bytes"]
            np.testing.assert_array_equal(ph["ids"], jh["ids"][:ph["rows"]])
            assert set(np.unique(ph["shard"])) <= set(spec.shard_indices)
            # exactly the resident rows, no padding
            assert ph["codes"].shape[0] == ph["rows"]
            assert ph["bytes"] <= spec.hot_gb * 2 ** 30
            staged += ph["bytes"]
        assert 0 < staged <= gb * 2 ** 30
        qv = _qv(4, seed=9)
        s, i = svc.topk_vectors(qv, k=10)
        js, ji = jsvc.topk_vectors(qv, k=10)
        _same_topk(s, i, js, ji, atol=1e-5)
        out = svc.restage_hot()
        assert out["hot_rows"] > 0 and out["hot_by_popularity"] is True
        assert svc.registry.events("hot_restaged")[-1]["attrs"] == out
    finally:
        svc.close()
        jsvc.close()


# -- routing ------------------------------------------------------------------

def _degrade(view) -> None:
    """A view that serves by the streaming sweep (its rows unstaged, no
    index): the port's degraded state."""
    view.pages = None
    view.index = None


def _jax_degrade(view) -> None:
    view.stream_entries = list(view.entries)
    view.shards = None


def _routing_record(svc):
    return (svc.replica_shed, svc.partition_degraded_serves,
            [(e["event"], e["attrs"]) for e in svc.registry.events()
             if e["event"] in ("replica_shed", "partition_degraded")])


def test_routing_sheds_and_degrades_as_jax(store_dir, mesh):
    """The JAX test's sequence on both packages: a restaging primary
    sheds to its sibling, then a degraded one, then with both replicas
    degraded one still serves (never an empty slice); the counters move
    per request, the events on changes of state only."""
    svc = _service(store_dir, partitions=2, replicas=2)
    jsvc = _jax_service(store_dir, mesh, partitions=2, replicas=2)
    qv = _qv(2, seed=11)
    try:
        base_s, base_i = svc.topk_vectors(qv, k=10)
        for pkg, deg in ((svc, _degrade), (jsvc, _jax_degrade)):
            pset = pkg.partition_set
            pset._parts[0][0].set_restaging(True)
            for _ in range(2):
                _same_topk(*pkg.topk_vectors(qv, k=10), base_s, base_i)
            pset._parts[0][0].set_restaging(False)
            deg(pset._parts[0][0].view)
            _same_topk(*pkg.topk_vectors(qv, k=10), base_s, base_i)
            deg(pset._parts[0][1].view)
            for _ in range(2):
                s, i = pkg.topk_vectors(qv, k=10)
                assert (i >= 0).all()
                _same_topk(s, i, base_s, base_i)
        got, want = _routing_record(svc), _routing_record(jsvc)
        assert got == want
        # 3 sheds (2 restaging, 1 degraded), then the degraded primary
        # serves twice: not a shed, a degraded serve
        assert got[:2] == (3, 2)
        assert [e for e, _ in got[2]] == ["replica_shed", "replica_shed",
                                          "partition_degraded"]
        assert got[2][0][1]["reason"] == "restaging"
        assert got[2][1][1]["reason"] == "degraded"
        met = svc.metrics()
        p0 = met["partitions"][0]
        assert p0["sheds"] == 3 and p0["degraded_serves"] == 2
        assert p0["replicas"][0]["degraded"] and p0["replicas"][1]["degraded"]
        assert met["partitions"][1]["sheds"] == 0
    finally:
        svc.close()
        jsvc.close()


def test_shed_on_queue_budget_as_jax(store_dir, mesh):
    svc = _service(store_dir, partitions=1, replicas=2,
                   replica_shed_queue=0)
    jsvc = _jax_service(store_dir, mesh, partitions=1, replicas=2,
                        replica_shed_queue=0)
    qv = _qv(1, seed=13)
    try:
        base, _ = svc.topk_vectors(qv, k=10)
        for pkg in (svc, jsvc):
            rep0 = pkg.partition_set._parts[0][0]
            with rep0._lock:              # a stuck backlog
                rep0._outstanding = 5
            s, _ = pkg.topk_vectors(qv, k=10)
            np.testing.assert_allclose(s, base, rtol=0, atol=1e-6)
            with rep0._lock:
                rep0._outstanding = 0
            pkg.topk_vectors(qv, k=10)    # back on the primary, no shed
        assert _routing_record(svc) == _routing_record(jsvc)
        assert svc.replica_shed == 1
        assert svc.registry.events("replica_shed")[-1]["attrs"] == {
            "partition": 0, "from_replica": 0, "to_replica": 1,
            "reason": "queue"}
        # the liveness seam: a dead primary worker sheds, reason liveness
        svc.partition_set.set_liveness(lambda pid, rid: rid != 0)
        svc.topk_vectors(qv, k=10)
        assert svc.registry.events("replica_shed")[-1]["attrs"][
            "reason"] == "liveness"
        svc.partition_set.set_liveness(None)
    finally:
        svc.close()
        jsvc.close()


def test_a_view_that_fails_to_stage_raises(store_dir):
    """No quiet fallback: a replica whose view fails to build raises out
    of the service's constructor, and its worker threads stop."""
    before = {t.name for t in threading.enumerate()}
    orig = SearchService._stage_view

    def broken(self, view, reuse=None):
        raise RuntimeError("staging failed")
    SearchService._stage_view = broken
    try:
        with pytest.raises(RuntimeError, match="staging failed"):
            _service(store_dir, partitions=2, replicas=2)
    finally:
        SearchService._stage_view = orig
    left = {t.name for t in threading.enumerate()} - before
    assert not any(n.startswith("serve-part") for n in left)


# -- the rolling refresh ------------------------------------------------------

def test_no_mixed_result_sets_under_partitioned_refresh(store_dir, tmp_path):
    """Hammer threads query a P=2, R=2 service while a generation appends
    rows equal to the queries (they top every new answer, in the last
    partition) and tombstones each query's old best page (spread over the
    partitions), then refresh() restages partition by partition: every
    result set is the old table's or the new table's, never a mix."""
    d = _copy(store_dir, tmp_path)
    svc = _service(d, partitions=2, replicas=2)
    qv = _qv(4, seed=17)
    old_s, old_i = svc.topk_vectors(qv, k=10)
    victims = sorted(set(old_i[:, 0].tolist()))
    stop = threading.Event()
    errors, seen = [], []

    def hammer():
        while not stop.is_set():
            try:
                seen.append(svc.topk_vectors(qv, k=10)[1])
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        w = VectorStore(d).begin_generation(tombstones=victims)
        w.write_shard(np.arange(ROWS, ROWS + len(qv), dtype=np.int64), qv)
        w.commit()
        info = svc.refresh()
        n_during = len(seen)
        deadline = time.monotonic() + 30
        while (len(seen) < n_during + 6 and not errors
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    new_s, new_i = svc.topk_vectors(qv, k=10)
    np.testing.assert_array_equal(new_i[:, 0], np.arange(ROWS, ROWS + 4))
    assert not set(new_i.ravel().tolist()) & set(victims)
    for ids in seen:
        assert (np.array_equal(ids, old_i) or np.array_equal(ids, new_i)), \
            f"a mixed result set: {ids}"
    assert any(np.array_equal(ids, new_i) for ids in seen)
    parts = info["partitions"]
    assert [p["partition"] for p in parts] == [0, 1]
    assert all(len(p["restage_ms"]) == 2 for p in parts)
    assert sum(p["rows"] for p in parts) == ROWS + len(qv)
    assert info["store_generation"] == 1 and "stage" not in info
    assert svc.metrics()["refreshes"] == 1
    # the single view over the same generation agrees
    one = _service(d)
    s1, i1 = one.topk_vectors(qv, k=10)
    _same_topk(new_s, new_i, s1, i1)
    one.close()
    svc.close()


def test_restaging_replica_sheds_and_r1_serves_the_old_view(store_dir,
                                                           tmp_path):
    """While a replica rebuilds, routing sheds to its sibling (R=2); with
    R=1 the old view answers until the table is published."""
    d = _copy(store_dir, tmp_path)
    qv = _qv(2, seed=19)
    for replicas in (2, 1):
        svc = _service(d, partitions=2, replicas=replicas)
        pset = svc.partition_set
        old_s, old_i = svc.topk_vectors(qv, k=10)
        during = []
        orig = svc._build_view

        def build(*a, **kw):
            # a query routed while this replica is marked restaging
            during.append(svc.topk_vectors(qv, k=10)[1])
            return orig(*a, **kw)
        svc._build_view = build
        victim = int(old_i[0, 0])
        VectorStore(d).begin_generation(tombstones=[victim]).commit()
        svc.refresh()
        del svc._build_view
        assert len(during) == 2 * replicas
        for ids in during:
            np.testing.assert_array_equal(ids, old_i)
        new_i = svc.topk_vectors(qv, k=10)[1]
        assert victim not in new_i
        if replicas == 2:
            # each partition's primary restaged once (its sibling served);
            # while the sibling restaged, the primary's old view served
            assert svc.replica_shed == 2
            reasons = {e["attrs"]["reason"]
                       for e in svc.registry.events("replica_shed")}
            assert reasons == {"restaging"}
        else:
            assert svc.replica_shed == 0
        assert svc.partition_degraded_serves == 0
        assert not any(r.restaging for reps in pset._parts for r in reps)
        svc.close()


def test_resize_publishes_one_table_each_time(store_dir, mesh):
    svc = _service(store_dir, partitions=2)
    jsvc = _jax_service(store_dir, mesh, partitions=2)
    pset, jset = svc.partition_set, jsvc.partition_set
    qv = _qv(5, seed=23)
    base_s, base_i = svc.topk_vectors(qv, k=10)
    try:
        for width in (3, 2):
            before = pset.table()
            out = pset.resize(VectorStore(store_dir), width)
            jout = jset.resize(JaxStore(store_dir), width)
            after = pset.table()
            assert len(after) == pset.partitions == width
            assert not {id(v) for row in before for v in row} & \
                {id(v) for row in after for v in row}
            assert [(o["partition"], o["shards"], o["rows"]) for o in out] \
                == [(o["partition"], o["shards"], o["rows"]) for o in jout]
            s, i = svc.topk_vectors(qv, k=10)
            _same_topk(s, i, base_s, base_i)
            js, ji = jsvc.topk_vectors(qv, k=10)
            _same_topk(s, i, js, ji)
            assert len(svc.metrics()["partitions"]) == width
        # the grid only grows: the stranded row is never routed again
        assert len(pset._parts) == 3
        assert pset._parts[2][0].stats()["requests"] == 1
    finally:
        svc.close()
        jsvc.close()


# -- simulation, the trial record, the spec -----------------------------------

def test_simulate_critical_path_and_scan_bytes_as_jax(store_dir, mesh):
    qv = _qv(1, seed=29)
    svc1 = _service(store_dir, partitions=1, replicas=2)
    svc4 = _service(store_dir, partitions=4)
    jsvc4 = _jax_service(store_dir, mesh, partitions=4)
    try:
        sim1 = svc1.partition_set.simulate(qv, 1, 10)
        sim4 = svc4.partition_set.simulate(qv, 1, 10)
        jsim4 = jsvc4.partition_set.simulate(qv, 1, 10)
        np.testing.assert_array_equal(sim1["ids"], sim4["ids"])
        np.testing.assert_allclose(sim1["scores"], sim4["scores"], rtol=0,
                                   atol=1e-6)
        _same_topk(sim4["scores"], sim4["ids"], jsim4["scores"],
                   jsim4["ids"])
        assert len(sim4["partition_seconds"]) == 4
        assert sim4["critical_path_seconds"] >= max(
            sim4["partition_seconds"])
        assert sim4["critical_path_seconds"] == max(
            sim4["partition_seconds"]) + sim4["merge_seconds"]
        row_bytes = DIM * 2
        assert sim1["scan_bytes"] == [ROWS * row_bytes]
        assert sim4["scan_bytes"] == jsim4["scan_bytes"]
        assert sum(sim4["scan_bytes"]) == ROWS * row_bytes
        assert max(sim4["scan_bytes"]) * 3 <= max(sim1["scan_bytes"])
        reps = [r for reps in svc4.partition_set._parts for r in reps]
        assert sum(r.scan_bytes for r in reps) == ROWS * row_bytes
        # a partitioned streaming service scans its entries' rows
        stream = _service(store_dir, partitions=3)
        stream._preload_gb = 0.0
        stream.partition_set.resize(VectorStore(store_dir), 3)
        sim = stream.partition_set.simulate(qv, 1, 10)
        assert sim["scan_bytes"] == [2 * SHARD * row_bytes] * 3
        _same_topk(sim["scores"], sim["ids"], sim1["scores"], sim1["ids"])
        assert stream.partition_degraded_serves == 3
        stream.close()
    finally:
        for x in (svc1, svc4, jsvc4):
            x.close()


def test_trial_record_carries_the_partition_block(store_dir):
    from dnn_page_vectors_tpu_torch.loadgen import make_workload, run_trial
    svc = _service(store_dir, partitions=2)
    svc.start_batcher()
    try:
        wl = make_workload("poisson", seed=3, distinct=4)
        queries = [f"query {i}" for i in range(4)]
        tr = run_trial(svc, wl, 40.0, queries, duration_s=0.4,
                       warmup_s=0.0, workers=4)
        assert tr["errors"] == 0 and tr["requests_sent"] > 0
        assert len(tr["partitions"]) == 2
        for p in tr["partitions"]:
            for key in ("partition", "shards", "rows", "qps", "p99_ms",
                        "sheds", "degraded_serves", "replicas"):
                assert key in p, key
        assert tr["replica_shed"] == 0 and tr["partition_degraded"] == 0
        assert sum(r["requests"] for p in tr["partitions"]
                   for r in p["replicas"]) == 2 * svc.batch_retries + \
            2 * len(svc.batch_sizes)
    finally:
        svc.close()


def test_empty_partition_spec_serves_nothing(store_dir):
    """A refresh over a table that shrank below the live width gives the
    tail partitions empty specs: they answer no rows (not a stale view)
    and are not degraded."""
    svc = _service(store_dir, partitions=2)
    pset = svc.partition_set
    try:
        spec = PartitionSpec(pid=1, entries=(), shard_indices=(), rows=0,
                             hot_gb=0.0)
        view = svc._build_view(VectorStore(store_dir), entries=[],
                               hot_gb=0.0)
        rep = pset._parts[1][0]
        rep.view, rep.spec = view, spec
        s, i, scan = svc._topk_view(view, _qv(2), 2, 5)
        assert (i == -1).all() and scan == 0 and not rep.degraded
        assert make_partition_specs([], 3) == [PartitionSpec(
            pid=0, entries=(), shard_indices=(), rows=0, hot_gb=0.0)]
    finally:
        svc.close()


def test_a_dual_stamp_matrix_splits_per_partition_as_one_view(store_dir,
                                                              mesh, tmp_path):
    """Mid-migration the store holds two stamps: the bucket is encoded
    once per stamp and stacked [n, 2*D]; each partition splits it by the
    store-wide stamps (``_qv_blocks``) and scores each shard with its
    stamp's block, so the scatter answers as the single view and the JAX
    package's partitioned service do; a narrow matrix scores every shard
    with it on both."""
    import zlib

    from dnn_page_vectors_tpu_torch.maintenance.migrate import MigrationPlan

    class _Pages:
        def page_text(self, i):
            return f"page {int(i)}"

    class _Tower:
        model = torch.nn.Identity()

        def embed_texts(self, texts, tower="page", batch_size=None):
            out = np.stack([np.random.default_rng(zlib.crc32(
                t.encode())).standard_normal(DIM) for t in texts])
            return (out / np.linalg.norm(out, axis=1, keepdims=True)
                    ).astype(np.float32)

    d = _copy(store_dir, tmp_path)
    for g in range(2):                  # generations 1 and 2: 20 rows each
        w = VectorStore(d).begin_generation()
        w.write_shard(np.arange(ROWS + 20 * g, ROWS + 20 * (g + 1)),
                      _vecs(40 + g, 20))
        w.commit()
    plan = MigrationPlan(VectorStore(d), _Pages(), _Tower(), 2)
    plan.begin()
    plan.migrate_unit(1)                # stamps 0 | 2 | 0 over the table
    one = _service(d)
    svc = _service(d, partitions=3, replicas=2)
    jsvc = _jax_service(d, mesh, partitions=3)
    try:
        assert one._view.steps == [0, 2] and svc.partition_set is not None
        wide = np.concatenate([_qv(4, seed=31), _qv(4, seed=32)], axis=1)
        for qv in (wide, _qv(4, seed=33)):
            s1, i1 = one.topk_vectors(qv, k=10)
            s, i = svc.topk_vectors(qv, k=10)
            js, ji = jsvc.topk_vectors(qv, k=10)
            _same_topk(s, i, s1, i1)
            _same_topk(s, i, js, ji)
        # every stamp's rows answer: each half of the matrix reaches them
        s, i = svc.topk_vectors(wide, k=ROWS + 40)
        assert set(i.ravel().tolist()) == set(range(ROWS + 40))
    finally:
        for x in (one, svc, jsvc):
            x.close()


def test_replica_bookkeeping_holds_under_a_thread_storm(store_dir):
    """More query threads than cores against P=2 x R=2 with a short
    switch interval: every scatter reaches each partition once (the
    replicas' request counts sum to calls x P), every queue drains to 0,
    and the service's shed counter equals the partitions' (a lost update
    would break one of them)."""
    import sys
    svc = _service(store_dir, partitions=2, replicas=2,
                   replica_shed_queue=0)
    qv = _qv(2, seed=37)
    want_s, want_i = svc.topk_vectors(qv, k=10)
    n_threads, calls = 12, 15
    errors = []

    def storm():
        try:
            for _ in range(calls):
                s, i = svc.topk_vectors(qv, k=10)
                _same_topk(s, i, want_s, want_i)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=storm) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errors, errors[:3]
        stats = svc.metrics()["partitions"]
        total = 1 + n_threads * calls
        for p in stats:
            assert sum(r["requests"] for r in p["replicas"]) == total
            assert all(r["queue"] == 0 for r in p["replicas"])
        assert svc.replica_shed == sum(p["sheds"] for p in stats) > 0
    finally:
        svc.close()
