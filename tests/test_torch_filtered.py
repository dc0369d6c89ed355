"""Filtered retrieval and the hot posting set of the port against the JAX
package on the CPU (the JAX tests/test_filtered.py and tests/test_pq.py
cases that need no partitions), on the same seeded store: 6 shards of 50
unit vectors of dim 32 whose attribute words make lang==1 keep 1/2 of the
rows, site in {0} 1/10 and recency>=3 the 6 planted rows (one a shard).

* attributed stores each package writes and the other reads: manifests
  and every .npy file (the .atr.npy words included) byte for byte, CRCs
  too; a generation, compaction, a migration and append_corpus(attrs=)
  carry the words as JAX's do, file for file;
* filtered exact (``_filtered_exact``): the ids of JAX's except where two
  scores tie within 1e-6, scores within 1e-5 (float32 products summed in
  another order), ``scan_bytes`` equal;
* ``IVFIndex.search(predicate=)`` over the JAX package's index files: the
  ids and scores under the same tolerance, every stat equal
  (``filter_escalations`` and ``gather_bytes`` included);
* ``stage_hot``: summaries, resident lists and staged rows equal to JAX's
  after the same searches, exactly; the hot path's results equal the mmap
  path's under the tolerance above, with and without a predicate;
* the service: the result cache's predicate slot, a JAX client's filtered
  queries on the port's server, ``serve.filters=False`` refusing, the
  batcher coalescing per predicate, the hot set staged per view and a
  failed stage raising."""
import dataclasses
import json
import os
import shutil
import socket
import threading

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.index import attrs as JA
from dnn_page_vectors_tpu.index.ivf import IVFIndex as JaxIndex
from dnn_page_vectors_tpu.infer import transport as jt
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.utils import faults as jax_faults
from dnn_page_vectors_tpu.utils import telemetry as jax_telemetry
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.index import attrs as A
from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
from dnn_page_vectors_tpu_torch.infer import transport as tt
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.server import serve_in_background
from dnn_page_vectors_tpu_torch.infer.transport import (
    RemoteError, SocketSearchClient)
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.utils import telemetry

DIM = 32
SHARD = 50
NSHARDS = 6
ROWS = SHARD * NSHARDS
NLIST = 8
PQ_M = 8
ARMS = (("lang==1", 0.5), ("site in {0}", 0.1), ("recency>=3", 0.02))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests: pytest-xdist workers
    share the host's cores, and more threads per worker only contend."""
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


def _words(n=ROWS):
    ids = np.arange(n)
    return A.pack_words(lang=(ids % 2).astype(np.uint32),
                        site=(ids % 10).astype(np.uint32),
                        recency=np.where(ids % SHARD == 0, 3,
                                         0).astype(np.uint32))


def _vecs(seed=0, n=ROWS):
    v = np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _write(cls, d, dtype, attrs=True):
    store = cls(d, dim=DIM, shard_size=SHARD, dtype=dtype)
    store.ensure_model_step(0)
    if attrs:
        store.init_attrs()
    words, vecs = _words(), _vecs()
    for si in range(NSHARDS):
        lo, hi = si * SHARD, (si + 1) * SHARD
        store.write_shard(si, np.arange(lo, hi, dtype=np.int64),
                          vecs[lo:hi], attrs=words[lo:hi] if attrs else None)
    return cls(d)


@pytest.fixture(scope="module")
def mesh():
    from dnn_page_vectors_tpu.config import MeshConfig
    from dnn_page_vectors_tpu.parallel.mesh import make_mesh
    return make_mesh(MeshConfig(data=1))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """dtype -> {port, jax}: the attributed store written by each
    package."""
    root = tmp_path_factory.mktemp("filtered")
    return {dtype: {"port": _write(VectorStore, str(root / f"{dtype}_port"),
                                   dtype),
                    "jax": _write(JaxStore, str(root / f"{dtype}_jax"),
                                  dtype)}
            for dtype in ("float16", "int8")}


@pytest.fixture(scope="module")
def indexes(stores, mesh):
    """pq_m -> the JAX package's index over its float16 store (each test
    opens its own objects over these files)."""
    js = stores["float16"]["jax"]
    out = {}
    for pq_m in (0, PQ_M):
        d = js.directory + f"_pq{pq_m}"
        shutil.copytree(js.directory, d)
        out[pq_m] = d
        JaxIndex.build(JaxStore(d), mesh, nlist=NLIST, iters=5, seed=0,
                       pq_m=pq_m)
    return out


def _qv(n=3, seed=1):
    q = np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _same_topk(got_s, got_i, want_s, want_i):
    """Scores within 1e-5; ids equal except where two scores tie within
    1e-6; an empty slot (-inf) the same in both."""
    filled = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), filled)
    np.testing.assert_allclose(got_s[filled], want_s[filled], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_i[~filled], want_i[~filled])
    differ = (got_i != want_i) & filled
    assert (np.abs(got_s[differ] - want_s[differ]) <= 1e-6).all()


def _oracle(store, qv, pred, k=10):
    """Exact post-filter top-k over the dequantized rows."""
    deq = np.concatenate([np.asarray(store._load_entry(e)[1], np.float32)
                          for e in store.shards()])
    sc = qv @ deq.T
    sc[:, ~pred.matches(_words())] = -np.inf
    order = np.argsort(-sc, axis=1, kind="stable")[:, :k]
    s = np.take_along_axis(sc, order, axis=1).astype(np.float32)
    ids = np.where(np.isfinite(s), order, -1).astype(np.int64)
    return s, ids


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


def _service(store, **serve):
    cfg = get_config("cdssm_toy", {
        "model.out_dim": DIM, **{f"serve.{k}": v for k, v in serve.items()}})
    return SearchService(cfg, _StubEmbedder(), _Corpus(), store)


def _jax_service(store, mesh, **serve):
    from dnn_page_vectors_tpu.infer.partition_host import MeshEmbedder
    from dnn_page_vectors_tpu.infer.serve import SearchService as JaxService
    cfg = jax_get_config("cdssm_toy", {"model.out_dim": DIM})
    if serve:
        cfg = cfg.replace(serve=dataclasses.replace(cfg.serve, **serve))
    return JaxService(cfg, MeshEmbedder(mesh), None, store,
                      preload_hbm_gb=4.0)


def _tree_bytes(d):
    """Every .npy file under `d`, by path relative to it, as bytes."""
    out = {}
    for root, _, files in os.walk(d):
        for name in files:
            if name.endswith(".npy"):
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, d)] = f.read()
    return out


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


# -- the store ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_attributed_store_equals_jax_both_ways(stores, dtype):
    port, ref = stores[dtype]["port"], stores[dtype]["jax"]
    assert _manifest(port.directory) == _manifest(ref.directory)
    files = _tree_bytes(port.directory)
    assert files == _tree_bytes(ref.directory)
    assert sum(n.endswith(".atr.npy") for n in files) == NSHARDS
    for entry in port.shards():
        # a 128-byte .npy header and one word a row
        assert entry["bytes"]["atr"] == 128 + 4 * SHARD
        assert "atr" in entry["crc"]
    # each package reads the other's words
    for reader, other in ((VectorStore, ref), (JaxStore, port)):
        st = reader(other.directory)
        assert st.attrs_enabled and st.entry_error(st.shards()[0]) is None
        words = np.concatenate([st.load_attrs(e) for e in st.shards()])
        assert words.dtype == np.uint32
        np.testing.assert_array_equal(words, _words())


def test_words_ride_appends_compaction_and_migration_as_jax(tmp_path):
    """The JAX test_attrs_survive_append_compact_migrate in both packages,
    plus append_corpus(attrs=): a generation writing its own words and
    tombstoning two rows, an append of two updated pages stamped with one
    word, compaction, then a migration: each package's store files equal
    the other's after every step, and the live rows keep their words."""
    from dnn_page_vectors_tpu.maintenance.compact import (
        compact_store as jax_compact)
    from dnn_page_vectors_tpu.maintenance.migrate import (
        migrate_store as jax_migrate)
    from dnn_page_vectors_tpu.updates import append_corpus as jax_append
    from dnn_page_vectors_tpu_torch.maintenance.compact import compact_store
    from dnn_page_vectors_tpu_torch.maintenance.migrate import migrate_store
    from dnn_page_vectors_tpu_torch.updates import append_corpus

    class _Embedder:
        query_tok = page_tok = mesh = None

        def __init__(self, cfg, step):
            self.cfg, self.step, self.params = cfg, step, ("tower", step)
            self.model = torch.nn.Identity()

        def embed_texts(self, texts, tower="page", batch_size=None):
            out = np.stack([np.random.default_rng(
                len(t) + 7 * self.step).standard_normal(DIM).astype(
                    np.float32) for t in texts])
            return out / np.linalg.norm(out, axis=1, keepdims=True)

    class _Pages(_Corpus):
        num_pages = 120                 # the generation's cursor: no new id

    pkgs = {"port": (VectorStore, append_corpus, compact_store,
                     migrate_store, get_config("cdssm_toy")),
            "jax": (JaxStore, jax_append, jax_compact, jax_migrate,
                    jax_get_config("cdssm_toy"))}
    rng = np.random.default_rng(2)
    base_words = _words(2 * SHARD)
    base_vecs = rng.standard_normal((2 * SHARD, DIM)).astype(np.float32)
    new_ids = np.arange(100, 120, dtype=np.int64)
    new_words = A.pack_words(lang=np.full(20, 5, np.uint32),
                             site=np.full(20, 9, np.uint32),
                             recency=np.full(20, 2, np.uint32))
    new_vecs = rng.standard_normal((20, DIM)).astype(np.float32)
    upd_word = A.pack_word(lang=9, site="wiki.org", recency=4)
    expect = {int(i): int(w) for i, w in enumerate(base_words)}
    expect.update({int(i): int(w) for i, w in zip(new_ids, new_words)})
    for dead in (3, 7):
        expect.pop(dead)
    for upd in (11, 13):
        expect[upd] = upd_word

    def check(cls, d, what):
        st = cls(d)
        got = {}
        for e in st.shards():
            for pid, w in zip(st._load_entry(e)[0], st.load_attrs(e)):
                if pid >= 0:
                    got[int(pid)] = int(w)
        assert got == expect, what

    dirs = {}
    for name, (cls, append, compact, migrate, cfg) in pkgs.items():
        d = dirs[name] = str(tmp_path / name)
        st = cls(d, dim=DIM, shard_size=SHARD)
        st.ensure_model_step(1)
        st.init_attrs()
        for si in range(2):
            lo = si * SHARD
            st.write_shard(si, np.arange(lo, lo + SHARD, dtype=np.int64),
                           base_vecs[lo:lo + SHARD],
                           attrs=base_words[lo:lo + SHARD])
        w = cls(d).begin_generation(tombstones=[3, 7])
        w.write_shard(new_ids, new_vecs, attrs=new_words)
        w.commit()
        out = append(_Embedder(cfg, 1), _Pages(), cls(d),
                     update_ids=[11, 13], attrs=upd_word)
        assert out["updated"] == 2 and out["generation"] == 2
    for name, (cls, _, compact, migrate, cfg) in pkgs.items():
        check(cls, dirs[name], f"{name} after the appends")
    assert _tree_bytes(dirs["port"]) == _tree_bytes(dirs["jax"])
    for name, (cls, _, compact, migrate, cfg) in pkgs.items():
        assert compact(cls(dirs[name])).get("action") == "compacted"
        check(cls, dirs[name], f"{name} after compaction")
    assert _tree_bytes(dirs["port"]) == _tree_bytes(dirs["jax"])
    for name, (cls, _, compact, migrate, cfg) in pkgs.items():
        out = migrate(cls(dirs[name]), _Corpus(), _Embedder(cfg, 2), 2)
        assert out["action"] == "migrated" and out["units"] > 0
        assert cls(dirs[name]).model_steps() == [2]
        check(cls, dirs[name], f"{name} after the migration")
    assert _tree_bytes(dirs["port"]) == _tree_bytes(dirs["jax"])


def test_append_without_attr_table_refuses(tmp_path):
    """attrs against a store with no attribute table is an error raised
    before any work, never a zero-fill; init_attrs unlocks it, and the
    shards written before it read as all-zero words, which only a
    predicate matching the zero word keeps."""
    from dnn_page_vectors_tpu_torch.updates import append_corpus
    store = _write(VectorStore, str(tmp_path / "plain"), "float16",
                   attrs=False)
    assert not store.attrs_enabled
    with pytest.raises(ValueError, match="no attribute table"):
        append_corpus(None, None, store, attrs=A.pack_word(lang=1))
    with pytest.raises(ValueError, match="no attribute table"):
        store.write_shard(NSHARDS, np.arange(ROWS, ROWS + SHARD),
                          _vecs(1, SHARD), attrs=np.zeros(SHARD, np.uint32))
    store.init_attrs()
    store = VectorStore(store.directory)
    assert store.attrs_enabled
    assert store.manifest["attrs"] == JA.attrs_manifest_section()
    assert not store.load_attrs(store.shards()[0]).any()
    # a new shard gets its words file, zeros when none are given
    store.write_shard(NSHARDS, np.arange(ROWS, ROWS + SHARD),
                      _vecs(1, SHARD))
    entry = VectorStore(store.directory).shards()[-1]
    assert "atr" in entry and not store.load_attrs(entry).any()
    svc = _service(VectorStore(store.directory))
    try:
        qv = _qv(2)
        full_s, full_i = svc.topk_vectors(qv, k=10)
        s, i = svc.topk_vectors(qv, k=10, filters="lang==0")
        _same_topk(s, i, full_s, full_i)
        s, i = svc.topk_vectors(qv, k=10, filters="lang==1")
        assert (i == -1).all()
    finally:
        svc.close()


# -- filtered exact -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_filtered_exact_equals_jax(stores, mesh, dtype):
    port, ref = stores[dtype]["port"], stores[dtype]["jax"]
    svc, jsvc = _service(port), _jax_service(ref, mesh)
    qv = _qv(4, seed=3)
    try:
        for text, _ in ARMS:
            pred, jpred = A.Predicate.parse(text), JA.Predicate.parse(text)
            s, i, scan = svc._topk_view(svc._view, qv, 4, 10, None,
                                        predicate=pred)
            js, ji, jscan = jsvc._topk_view(jsvc._view, qv, 4, 10, None,
                                            predicate=jpred)
            _same_topk(s, i, js, ji)
            assert scan == jscan, text
            _same_topk(s, i, *_oracle(port, qv, pred))
            assert pred.matches(_words()[i[i >= 0]]).all()
            s2, i2 = svc.topk_vectors(qv, k=10, filters=text)
            assert np.array_equal(i2, i) and np.array_equal(s2, s)
        # the text path records one filtered_query event a dispatch
        res = svc.search("event probe", k=5, filters=" lang == 1 ")
        assert res and all(A.unpack_word(_words()[r["page_id"]])[0] == 1
                           for r in res)
        ev = svc.registry.events("filtered_query")
        assert ev[-1]["attrs"] == {"predicate": "lang==1", "n_queries": 1}
        with pytest.raises(A.FilterError):
            svc.search("x", filters="lang==300")
    finally:
        svc.close()
        jsvc.close()


def test_filtered_scan_bytes_contract(stores):
    """At selectivity 0.1 the filtered exact scan reads at most 0.3x the
    unfiltered bytes (the words and the matching rows only), and the
    bytes fall with selectivity."""
    svc = _service(stores["float16"]["port"])
    qv = _qv(1, seed=5)
    try:
        _, _, base = svc._topk_view(svc._view, qv, 1, 10, None)
        assert base == ROWS * DIM * 2
        scans = {}
        for text, sel in ARMS:
            _, _, sb = svc._topk_view(svc._view, qv, 1, 10, None,
                                      predicate=A.Predicate.parse(text))
            scans[sel] = sb
            assert sb == ROWS * 4 + int(sel * ROWS) * DIM * 2
        assert scans[0.1] <= 0.3 * base
        assert scans[0.02] < scans[0.1] < scans[0.5] < base
    finally:
        svc.close()


# -- the index ----------------------------------------------------------------

def _both(indexes, pq_m):
    """(port index, JAX index) opened over the same files."""
    d = indexes[pq_m]
    return (IVFIndex.open(VectorStore(d), device="cpu"),
            JaxIndex.open(JaxStore(d)))


@pytest.mark.parametrize("pq_m", [0, PQ_M])
def test_ivf_filtered_search_equals_jax(indexes, pq_m):
    port, ref = _both(indexes, pq_m)
    qv = _qv(5, seed=3)
    for text, _ in ARMS + (("lang==1&site in {1,3}", 0.2),):
        pred, jpred = A.Predicate.parse(text), JA.Predicate.parse(text)
        for nprobe in (1, 2, NLIST):
            s, i, st = port.search(qv, 10, nprobe=nprobe, predicate=pred)
            js, ji, jst = ref.search(qv, 10, nprobe=nprobe, predicate=jpred)
            _same_topk(s, i, js, ji)
            assert st == jst, (text, nprobe)
            assert pred.matches(_words()[i[i >= 0]]).all()
        # full probe: the oracle's ids (the default rerank depth covers
        # the matching rows of a probed list)
        if pq_m == 0:
            _same_topk(s, i, *_oracle(VectorStore(indexes[pq_m]), qv, pred))
    assert port.stats == ref.stats
    np.testing.assert_array_equal(port.scan_counts, ref.scan_counts)


def test_ivf_underfilled_probe_escalates(indexes):
    """A selective predicate under a narrow probe drains more lists
    (counted, as JAX counts) instead of returning a short result."""
    port, ref = _both(indexes, 0)
    pred = A.Predicate.parse("recency>=3")        # 6 rows in 300
    qv = _qv(3, seed=9)
    _, ids, st = port.search(qv, 4, nprobe=1, predicate=pred)
    _, jids, jst = ref.search(qv, 4, nprobe=1,
                              predicate=JA.Predicate.parse("recency>=3"))
    assert st == jst and st["filter_escalations"] > 0
    np.testing.assert_array_equal(ids, jids)
    want = set(np.nonzero(pred.matches(_words()))[0].tolist())
    for q in range(3):
        got = [int(x) for x in ids[q] if x >= 0]
        assert len(got) == 4 and set(got) <= want
    assert telemetry.default_registry().counter(
        "ivf.filter_escalations").value == st["filter_escalations"]
    # escalate <= 1 turns it off: the short result stands
    _, ids1, st1 = port.search(qv, 4, nprobe=1, predicate=pred, escalate=1)
    assert "filter_escalations" not in st1 and (ids1 == -1).any()


def _hot_arrays(port, ref):
    ph, jh = port._hot, ref._hot
    n = ph["rows"]
    assert n == jh["rows"] and ph["bytes"] == jh["bytes"]
    np.testing.assert_array_equal(ph["lists"], jh["lists"])
    for key in ("ids", "shard", "row"):
        np.testing.assert_array_equal(ph[key], jh[key])
    np.testing.assert_array_equal(ph["codes"].numpy(),
                                  np.asarray(jh["codes"])[:n])
    np.testing.assert_array_equal(ph["cent"].numpy(),
                                  np.asarray(jh["cent"])[:n])
    np.testing.assert_array_equal(ph["attrs"].numpy().view(np.uint32),
                                  np.asarray(jh["attrs"])[:n])


def test_stage_hot_equals_jax_after_the_same_searches(indexes):
    port, ref = _both(indexes, PQ_M)
    budget = 0.5 * ROWS * (PQ_M + 4)
    # a cold table ranks by list size
    got, want = port.stage_hot(budget), ref.stage_hot(budget)
    assert got == want and got["hot_by_popularity"] is False
    assert 0 < got["hot_lists"] < NLIST and got["hot_bytes"] <= budget
    _hot_arrays(port, ref)
    assert port.hot_rows == ref.hot_rows == got["hot_rows"]
    # the same searches give the same popularity table
    for seed in range(4):
        qv = _qv(6, seed=20 + seed)
        port.search(qv, 5, nprobe=2)
        ref.search(qv, 5, nprobe=2)
    np.testing.assert_array_equal(port.scan_counts, ref.scan_counts)
    got, want = port.stage_hot(budget), ref.stage_hot(budget)
    assert got == want and got["hot_by_popularity"] is True
    _hot_arrays(port, ref)
    np.testing.assert_array_equal(port.scan_counts, ref.scan_counts)
    # the restage ranked by popularity: the resident lists are the most
    # probed ones that fit, and the table was halved
    assert port.scan_counts.sum() > 0
    with pytest.raises(ValueError, match="needs a PQ index"):
        _both(indexes, 0)[0].stage_hot(budget)


def test_hot_set_equals_the_mmap_path(indexes, tmp_path):
    """Half the rows staged: the results with and without a predicate are
    the mmap path's and JAX's hot path's; fewer bytes move, the staged
    rows are scored. Then a generation tombstoning rows of staged lists:
    after the index update the restaged dead rows carry list -2 and never
    serve."""
    port, ref = _both(indexes, PQ_M)
    mmap = IVFIndex.open(VectorStore(indexes[PQ_M]), device="cpu")
    budget = 0.5 * ROWS * (PQ_M + 4)
    port.stage_hot(budget)
    ref.stage_hot(budget)
    qv = _qv(6, seed=31)
    for text in (None,) + tuple(t for t, _ in ARMS):
        pred = None if text is None else A.Predicate.parse(text)
        jpred = None if text is None else JA.Predicate.parse(text)
        for nprobe in (2, NLIST):
            s, i, st = port.search(qv, 10, nprobe=nprobe, predicate=pred)
            ms, mi, mst = mmap.search(qv, 10, nprobe=nprobe, predicate=pred)
            js, ji, jst = ref.search(qv, 10, nprobe=nprobe, predicate=jpred)
            _same_topk(s, i, ms, mi)
            _same_topk(s, i, js, ji)
            assert st == jst, (text, nprobe)
            assert st["hot_rows_scored"] > 0
            assert st["gather_bytes"] < mst["gather_bytes"]
            assert "hot_rows_scored" not in mst
    # tombstones: a generation kills rows, the update and restage mask them
    d = str(tmp_path / "tomb")
    shutil.copytree(indexes[PQ_M], d)
    store = VectorStore(d)
    dead = [1, 2, 60, 61, 150]
    w = store.begin_generation(tombstones=dead)
    w.write_shard(np.arange(ROWS, ROWS + 10), _vecs(5, 10),
                  attrs=np.zeros(10, np.uint32))
    w.commit()
    idx, info = IVFIndex.update(VectorStore(d), device="cpu")
    assert info["action"] == "incremental"
    idx.stage_hot(1 << 20)
    hot = idx._hot
    assert hot["rows"] == ROWS + 10
    assert set(hot["ids"][hot["cent"].numpy() == -2].tolist()) == {-1}
    assert int((hot["cent"].numpy() == -2).sum()) == len(dead)
    plain = IVFIndex.open(VectorStore(d), device="cpu")
    for text in (None, "lang==0"):
        pred = None if text is None else A.Predicate.parse(text)
        s, i, _ = idx.search(qv, 10, nprobe=NLIST, predicate=pred)
        ms, mi, _ = plain.search(qv, 10, nprobe=NLIST, predicate=pred)
        _same_topk(s, i, ms, mi)
        assert not set(i.ravel().tolist()) & set(dead)


# -- the service --------------------------------------------------------------

def _ivf_service(d, **serve):
    return _service(VectorStore(d), index="ivf", nprobe=2, **serve)


def test_service_stages_the_hot_set_per_view(indexes, tmp_path):
    d = str(tmp_path / "svc")
    shutil.copytree(indexes[PQ_M], d)
    gb = 0.5 * ROWS * (PQ_M + 4) / 2 ** 30
    hot, cold = _ivf_service(d, hot_postings_gb=gb), _ivf_service(d)
    try:
        assert 0 < hot.metrics()["ann_index"]["hot_rows"] < ROWS
        assert cold.metrics()["ann_index"]["hot_rows"] == 0
        qv = _qv(8, seed=41)
        for text in (None, "lang==1", "site in {0}"):
            s, i = hot.topk_vectors(qv, k=10, filters=text)
            cs, ci = cold.topk_vectors(qv, k=10, filters=text)
            _same_topk(s, i, cs, ci)
        out = hot.restage_hot()
        assert out["hot_by_popularity"] is True and out["hot_rows"] > 0
        assert hot.registry.events("hot_restaged")[-1]["attrs"] == out
        assert cold.restage_hot() == {}
        # a refresh opens a fresh index and stages it with the window of
        # the view it replaces
        counts = hot.index.scan_counts.copy()
        old = hot.index
        hot.refresh()
        assert hot.index is not old and hot.index.hot_rows > 0
        np.testing.assert_array_equal(
            hot.index.scan_counts + 0, counts >> 1)
    finally:
        hot.close()
        cold.close()
    # a stage that fails raises: no quiet fall back to the mmap path
    orig = IVFIndex.stage_hot

    def broken(self, budget):
        raise RuntimeError("staging failed")
    IVFIndex.stage_hot = broken
    try:
        with pytest.raises(RuntimeError, match="staging failed"):
            _ivf_service(d, hot_postings_gb=gb)
    finally:
        IVFIndex.stage_hot = orig


@pytest.mark.parametrize("topo", ["local", "socket"])
def test_result_cache_never_crosses_filter_boundary(stores, topo):
    """A filtered request is never answered by the unfiltered entry of the
    same text, nor the reverse; a canonical twin of a predicate hits its
    entry."""
    svc = _service(stores["float16"]["port"], result_cache=True)
    srv = client = None
    words = _words()
    q = "query zero"
    try:
        if topo == "socket":
            srv = serve_in_background(svc)
            client = SocketSearchClient(srv.host, srv.port)
            search = client.search
        else:
            search = svc.search
        unfiltered = search(q, k=10)
        assert any(A.unpack_word(words[r["page_id"]])[0] == 0
                   for r in unfiltered), "the check needs a lang==0 row"
        filtered = search(q, k=10, filters="lang==1")
        assert filtered and filtered != unfiltered
        assert all(A.unpack_word(words[r["page_id"]])[0] == 1
                   for r in filtered)
        assert search(q, k=10, filters="lang==1") == filtered
        assert search(q, k=10) == unfiltered
        hits = svc.metrics()["result_cache"]["hits"]
        assert search(q, k=10, filters=" lang == 1 ") == filtered
        assert svc.metrics()["result_cache"]["hits"] == hits + 1
        keys = {key[5] for key in svc._rcache}
        assert keys == {"", "lang==1"}
    finally:
        if client is not None:
            client.close()
        if srv is not None:
            srv.close()
        svc.close()


def test_jax_client_filtered_queries_on_the_port_server(stores):
    svc = _service(stores["float16"]["port"])
    svc.start_batcher()
    srv = serve_in_background(svc)
    clients = [jt.SocketSearchClient(srv.host, srv.port),
               jt.SocketSearchClient(srv.host, srv.port, compress=False),
               SocketSearchClient(srv.host, srv.port)]
    qv = _qv(3, seed=7)
    try:
        for text, _ in ARMS:
            want_s, want_i = svc.topk_vectors(qv, k=10, filters=text)
            local = svc.search("some words", k=10, filters=text)
            for client in clients:
                for _ in range(2):        # a compressing one interns
                    s, i, _ = client.topk_vectors(qv, k=10, filters=text)
                    assert np.array_equal(i, want_i)
                    assert np.array_equal(s, want_s)
                got = client.search("some words", k=10, filters=text)
                assert [(r["page_id"], round(r["score"], 4))
                        for r in got] == [(r["page_id"], r["score"])
                                          for r in local]
    finally:
        for c in clients:
            c.close()
        srv.close()
        svc.close()


def test_filters_off_server_refuses_filtered_frames(stores):
    """serve.filters=False: the server does not confirm FLAG_FILTERS, so
    both packages' clients refuse a filtered call themselves; a filtered
    frame sent anyway gets one T_ERROR and nothing is admitted; unfiltered
    requests on the same connections keep working."""
    svc = _service(stores["float16"]["port"], filters=False)
    srv = serve_in_background(svc)
    port_c = SocketSearchClient(srv.host, srv.port)
    jax_c = jt.SocketSearchClient(srv.host, srv.port)
    qv = _qv(2, seed=23)
    try:
        base_s, base_i = svc.topk_vectors(qv, k=10)
        for client, err in ((port_c, RemoteError), (jax_c, jt.RemoteError)):
            _, ids, _ = client.topk_vectors(qv, k=10)
            assert np.array_equal(ids, base_i)
            with pytest.raises(err, match="FLAG_FILTERS"):
                client.topk_vectors(qv, k=10, filters="lang==1")
            with pytest.raises(err, match="FLAG_FILTERS"):
                client.search("x", filters="lang==1")
            _, ids, _ = client.topk_vectors(qv, k=10)
            assert np.array_equal(ids, base_i)
        served = svc._m_requests.value
        for frame in ((tt.T_QUERY, tt.encode_query(7, ["x"], k=5,
                                                   filters="lang==1")),
                      (tt.T_VQUERY, tt.encode_vquery(8, qv, k=5,
                                                     filters="lang==1"))):
            raw = socket.create_connection((srv.host, srv.port), timeout=5)
            tt.write_frame(raw, *frame)
            ftype, body = tt.read_frame(raw)
            assert ftype == tt.T_ERROR
            assert "serve.filters is off" in tt.decode_error(body)[1]
            raw.close()
        assert svc._m_requests.value == served
    finally:
        port_c.close()
        jax_c.close()
        srv.close()
        svc.close()


def test_batcher_coalesces_per_predicate(stores):
    """Concurrent searches with three predicates and none through the
    micro-batcher: each answer is its own filter's, equal to a direct
    call."""
    svc = _service(stores["float16"]["port"], batch_window_ms=20.0)
    svc.start_batcher()
    texts = (None,) + tuple(t for t, _ in ARMS)
    want = {t: svc.search_many(["alpha beta"], k=10, filters=t)[0]
            for t in texts}
    out, errors = {}, []

    def run(i):
        t = texts[i % len(texts)]
        try:
            out[i] = (t, svc.search("alpha beta", k=10, filters=t))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors and len(out) == 16
        for t, res in out.values():
            assert res == want[t], t
        assert svc.batch_retries == 0
        assert max(svc.batch_sizes) > 1       # coalesced, per predicate
    finally:
        svc.close()
