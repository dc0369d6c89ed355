"""The port's IVF/PQ index (index/kmeans.py, index/pq.py, index/ivf.py),
the re-ranks of ops/topk.py, recall_vs_exact, the index route of the
eval and of the miner, and serve.index="ivf" against the JAX package on
the CPU, at small sizes: 400 clustered unit vectors of dim 32 in 3 shards
(160, 160, 80 rows), float16 and int8 stores, nlist 12, pq_m 8. Every
store and index is built once per package in a module fixture.

Tolerances, each with its reason:
* posting (ord/off) and PQ code files, assignments and codes:
  byte-identical (argmax and argsort over scores that agree to float32
  rounding; these seeded clusters leave no near-tie);
* centroids within 1e-5, OPQ rotation and codebooks within 1e-4 (float32
  sums in other orders; the rotation passes through a float64 SVD);
* search scores within 1e-5, ids equal except where two scores tie
  within 1e-6, stats equal (the same candidates, scored in float32 in
  other orders);
* full probe against the exact sweep: the same id set in every row (full
  probe with every candidate re-ranked is exact search)."""
import json
import math
import os
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import MeshConfig
from dnn_page_vectors_tpu.evals.recall import (
    hits_from_store as jax_hits, recall_vs_exact as jax_recall_vs_exact)
from dnn_page_vectors_tpu.index import kmeans as jax_kmeans
from dnn_page_vectors_tpu.index import pq as jax_pq
from dnn_page_vectors_tpu.index.ivf import IVFIndex as JaxIndex
from dnn_page_vectors_tpu.index.ivf import auto_nlist as jax_auto_nlist
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.mine.ann import mine_hard_negatives as jax_mine
from dnn_page_vectors_tpu.ops import topk as jax_topk
from dnn_page_vectors_tpu.parallel.mesh import make_mesh
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.loader import (
    build_corpus, build_tokenizer)
from dnn_page_vectors_tpu_torch.evals.recall import (
    hits_from_store, recall_from_store, recall_vs_exact)
from dnn_page_vectors_tpu_torch.index import kmeans, pq
from dnn_page_vectors_tpu_torch.index.ivf import (
    IndexUnavailable, IVFIndex, auto_nlist, index_dir)
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.mine.ann import mine_hard_negatives
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.ops.topk import (
    rerank_candidates, rerank_positions, topk_over_store)

N, DIM, NLIST, PQ_M = 400, 32, 12, 8
SHARDS = ((0, 160), (160, 320), (320, 400))
BUILD = dict(nlist=NLIST, iters=4, seed=0)
# case -> (store dtype, pq_m, kmeans_balance)
CASES = {"fp16": ("float16", 0, 0.0), "int8": ("int8", 0, 0.0),
         "fp16_pq": ("float16", PQ_M, 0.0), "int8_pq": ("int8", PQ_M, 0.0),
         "fp16_balanced": ("float16", 0, 1.2)}
FLOAT_FILES = ("centroids.npy", "pq_rotation.npy", "pq_codebooks.npy")


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


VECS = _unit((lambda r: r.normal(size=(12, DIM))[r.integers(0, 12, N)]
              + 0.3 * r.normal(size=(N, DIM)))(np.random.default_rng(3)))
QUERIES = _unit(VECS[np.random.default_rng(1).choice(N, 24, replace=False)]
                + 0.1 * np.random.default_rng(2).normal(size=(24, DIM)))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshConfig(data=1))


def _write(cls, d, dtype):
    store = cls(d, dim=DIM, shard_size=160, dtype=dtype)
    store.ensure_model_step(1)
    for i, (lo, hi) in enumerate(SHARDS):
        store.write_shard(i, np.arange(lo, hi, dtype=np.int64), VECS[lo:hi])
    return store


@pytest.fixture(scope="module")
def built(tmp_path_factory, mesh):
    """case -> {port, jax}: (store, index) built by each package from the
    same vectors into stores of its own; the port's from the serve.* knobs
    of its config (``build_from_config``), JAX's from the same values."""
    root = tmp_path_factory.mktemp("index")
    out = {}
    for case, (dtype, pq_m, balance) in CASES.items():
        ps = _write(VectorStore, str(root / f"{case}_port"), dtype)
        js = _write(JaxStore, str(root / f"{case}_jax"), dtype)
        cfg = get_config("cdssm_toy", {
            "serve.nlist": BUILD["nlist"],
            "serve.kmeans_iters": BUILD["iters"],
            "data.seed": BUILD["seed"], "serve.pq_m": pq_m,
            "serve.kmeans_balance": balance})
        out[case] = {
            "port": (ps, IVFIndex.build_from_config(ps, cfg, device="cpu")),
            "jax": (js, JaxIndex.build(js, mesh, pq_m=pq_m, balance=balance,
                                       **BUILD))}
    return out


def _npy_files(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".npy"))


def _manifest_core(man):
    """A manifest without wall-clock seconds and without the CRCs of float
    files, which hold sums in another order."""
    man = json.loads(json.dumps(man))
    man.pop("build_seconds")
    man["centroids"].pop("crc")
    if "pq" in man:
        man["pq"].pop("train_seconds")
        for key in ("rotation", "codebooks"):
            man["pq"][key].pop("crc")
    return man


def _same_topk(got_s, got_i, want_s, want_i):
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    filled = np.isfinite(want_s)        # -inf slots carry id -1 in both
    np.testing.assert_array_equal(got_i[~filled], want_i[~filled])
    differ = (got_i != want_i) & filled
    assert (np.abs(got_s[differ] - want_s[differ]) <= 1e-6).all()


@pytest.mark.parametrize("case", CASES)
def test_build_files_equal_jax(built, case):
    (ps, pidx), (js, jidx) = built[case]["port"], built[case]["jax"]
    pd, jd = index_dir(ps), index_dir(js)
    names = _npy_files(pd)
    assert names == _npy_files(jd)
    assert ("pq_rotation.npy" in names) == bool(CASES[case][1])
    for name in names:
        a, b = np.load(os.path.join(pd, name)), np.load(os.path.join(jd, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name in FLOAT_FILES:
            tol = 1e-5 if name == "centroids.npy" else 1e-4
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)
        else:                        # ord, off, pqc: byte for byte
            with open(os.path.join(pd, name), "rb") as f, \
                    open(os.path.join(jd, name), "rb") as g:
                assert f.read() == g.read(), name
    assert _manifest_core(pidx.manifest) == _manifest_core(jidx.manifest)
    np.testing.assert_array_equal(pidx.list_sizes, jidx.list_sizes)
    assert int(pidx.list_sizes.sum()) == N
    assert set(pidx.build_stats) >= {"kmeans_s", "assign_s", "seconds"}
    if CASES[case][2]:               # lists capped as in JAX
        cap = math.ceil(1.2 * N / NLIST)
        assert pidx.manifest["balance_cap"] == cap
        assert pidx.imbalance <= pidx.manifest["imbalance_raw"]


@pytest.mark.parametrize("case", CASES)
def test_each_package_opens_the_others_index(built, case):
    (ps, _), (js, _) = built[case]["port"], built[case]["jax"]
    for store_dir in (ps.directory, js.directory):
        port = IVFIndex.open(VectorStore(store_dir), device="cpu")
        jax_ = JaxIndex.open(JaxStore(store_dir))
        for kw in ({"nprobe": 3}, {"nprobe": 5, "rerank": 24}, {}):
            got_s, got_i, got_st = port.search(QUERIES, k=10, **kw)
            want_s, want_i, want_st = jax_.search(QUERIES, k=10, **kw)
            _same_topk(got_s, got_i, want_s, want_i)
            assert got_st == want_st, kw
        # the keys the port counts agree; JAX's others (the hot set, the
        # filter escalation) are not ported and stay 0 in its own run
        assert port.stats == {k: jax_.stats[k] for k in port.stats}
        assert not any(v for k, v in jax_.stats.items()
                       if k not in port.stats)


@pytest.mark.parametrize("case", CASES)
def test_full_probe_equals_exact(built, case):
    store, idx = built[case]["port"]
    _, exact = topk_over_store(QUERIES, store, k=10, device="cpu")
    # every candidate survives the ADC cut: full probe is exact search
    _, ann, st = idx.search(QUERIES, k=10, nprobe=NLIST, rerank=N)
    assert st["candidates_reranked"] == len(QUERIES) * N
    for a, e in zip(ann, exact):
        assert set(a.tolist()) == set(e.tolist())
    if idx.pq is not None:           # JAX tests/test_pq.py:220's bar
        _, ann, _ = idx.search(QUERIES, k=10, nprobe=NLIST, rerank=64)
        rec = np.mean([len(set(a.tolist()) & set(e.tolist())) / 10
                       for a, e in zip(ann, exact)])
        assert rec >= 0.95


def test_kmeans_and_pq_training_match_jax(built, mesh):
    ps, js = built["int8"]["port"][0], built["int8"]["jax"][0]
    pool = kmeans.sample_rows(ps, 200, seed=5)
    np.testing.assert_array_equal(pool, jax_kmeans.sample_rows(js, 200, 5))
    np.testing.assert_array_equal(
        kmeans._kmeans_pp(pool, 9, np.random.default_rng(4)),
        jax_kmeans._kmeans_pp(pool, 9, np.random.default_rng(4)))
    for init, sample in (("kmeans++", None), ("random", 64)):
        got, gst = kmeans.train_kmeans(ps, 10, iters=3, seed=2, init=init,
                                       sample_per_shard=sample, device="cpu")
        want, wst = jax_kmeans.train_kmeans(js, mesh, 10, iters=3, seed=2,
                                            init=init,
                                            sample_per_shard=sample)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert gst == wst
    for choices in (1, 3):
        got = list(kmeans.assign_store(ps, want, choices=choices,
                                       device="cpu"))
        ref = list(jax_kmeans.assign_store(js, mesh, want, choices=choices))
        assert [e["index"] for e, _ in got] == [e["index"] for e, _ in ref]
        for (_, a), (_, b) in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    x3 = pool.reshape(200, 8, 4)
    cb, cst = kmeans.grouped_kmeans(x3, 16, iters=3, seed=(1, 2),
                                    device="cpu")
    wcb, wcst = jax_kmeans.grouped_kmeans(x3, 16, iters=3, seed=(1, 2))
    np.testing.assert_allclose(cb, wcb, rtol=0, atol=1e-5)
    assert cst == wcst
    np.testing.assert_array_equal(
        kmeans.grouped_assign(x3, wcb, chunk=64, device="cpu"),
        jax_kmeans.grouped_assign(x3, wcb, chunk=64))
    codec, st = pq.train_pq(ps, 4, ksub=32, iters=3, opq_iters=2, seed=1,
                            device="cpu")
    wcodec, wst = jax_pq.train_pq(js, 4, ksub=32, iters=3, opq_iters=2,
                                  seed=1)
    np.testing.assert_allclose(codec.rotation, wcodec.rotation, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(codec.codebooks, wcodec.codebooks, rtol=0,
                               atol=1e-4)
    st.pop("train_seconds"), wst.pop("train_seconds")
    assert st == wst
    np.testing.assert_array_equal(codec.encode(VECS, device="cpu"),
                                  wcodec.encode(VECS))
    assert pq.auto_pq_m(48) == jax_pq.auto_pq_m(48) == 6
    assert pq.auto_pq_m(30) == jax_pq.auto_pq_m(30) == 5
    for n in (1, 10, 400, 10**8):
        assert auto_nlist(n) == jax_auto_nlist(n)


@pytest.mark.parametrize("scaled", [False, True], ids=["fp16", "int8"])
def test_shard_pass_matches_jax(built, mesh, scaled):
    store = built["int8" if scaled else "fp16"]["port"][0]
    _, rows, scl = next(store.iter_shards(raw=True))
    rows = np.array(rows)
    cents = _unit(np.random.default_rng(9).normal(size=(7, DIM)))
    for choices in (1, 3):
        s, c, a = kmeans.shard_pass(
            torch.from_numpy(rows),
            None if scl is None else torch.from_numpy(scl),
            torch.from_numpy(cents), chunk=64, choices=choices)
        pages, scales = jax_topk.stage_shard(rows, rows.shape[0], DIM, mesh,
                                             scales=scl)
        ws, wc, wa = jax_kmeans.shard_pass(pages, scales, rows.shape[0],
                                           jnp.asarray(cents), mesh, 7,
                                           chunk=64, choices=choices)
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(a.numpy(), np.asarray(wa))


def test_reranks_and_adc_match_jax():
    rng = np.random.default_rng(7)
    B, C, nprobe, k = 6, 96, 3, 10
    q = _unit(rng.normal(size=(B, DIM)))
    cand16 = _unit(rng.normal(size=(C, DIM))).astype(np.float16)
    codes8 = rng.integers(-127, 128, size=(C, DIM)).astype(np.int8)
    scl = (rng.random(C) * 0.01 + 1e-3).astype(np.float16)
    cent = rng.integers(0, 8, C).astype(np.int32)
    cent[:5] = -1                                  # padding
    cent[5:9] = -2                                 # dead rows
    sel = np.stack([rng.choice(8, nprobe, replace=False)
                    for _ in range(B)]).astype(np.int32)
    T = torch.from_numpy
    for cand, scales in ((cand16, None), (codes8, scl)):
        got_s, got_p = rerank_candidates(
            T(q), T(cand), None if scales is None else T(scales),
            T(cent), T(sel), k)
        want_s, want_p = jax_topk.rerank_candidates(
            jnp.asarray(q), jnp.asarray(cand),
            None if scales is None else jnp.asarray(scales),
            jnp.asarray(cent), jnp.asarray(sel), k)
        _same_topk(got_s.numpy(), got_p.numpy(), np.asarray(want_s),
                   np.asarray(want_p))
        assert not np.isin(got_p.numpy(), np.arange(9)).any()
        pos = np.stack([rng.choice(C, 24, replace=False)
                        for _ in range(B)]).astype(np.int64)
        pos[0, 20:] = -1                           # empty slots
        got_s, got_p = rerank_positions(
            T(q), T(cand), None if scales is None else T(scales), T(pos), k)
        want_s, want_p = jax_topk.rerank_positions(
            jnp.asarray(q), jnp.asarray(cand),
            None if scales is None else jnp.asarray(scales),
            jnp.asarray(pos.astype(np.int32)), k)
        _same_topk(got_s.numpy(), got_p.numpy(), np.asarray(want_s),
                   np.asarray(want_p))
    m, ksub = 8, 16
    rot = np.linalg.qr(rng.normal(size=(DIM, DIM)))[0].astype(np.float32)
    cb = rng.normal(size=(m, ksub, DIM // m)).astype(np.float32)
    lut = pq._pq_lut(T(q), T(rot), T(cb))
    want_lut = jax_pq._pq_lut(jnp.asarray(q), jnp.asarray(rot),
                              jnp.asarray(cb))
    np.testing.assert_allclose(lut.numpy(), np.asarray(want_lut), rtol=0,
                               atol=1e-5)
    codes = rng.integers(0, ksub, size=(C, m)).astype(np.uint8)
    for r, chunk in ((12, 32), (40, 1000)):
        got_s, got_p = pq.adc_topr(lut, T(codes), T(cent), T(sel), r=r,
                                   chunk=chunk)
        want_s, want_p = jax_pq.adc_topr(want_lut, jnp.asarray(codes),
                                         jnp.asarray(cent), jnp.asarray(sel),
                                         r=r, chunk=C)
        _same_topk(got_s.numpy(), got_p.numpy(), np.asarray(want_s),
                   np.asarray(want_p))


def test_seeded_build_is_byte_identical(built, tmp_path):
    src = built["int8_pq"]["port"][0]
    idxs, files = [], []
    for name in ("a", "b"):
        d = str(tmp_path / name)
        shutil.copytree(src.directory, d)
        shutil.rmtree(os.path.join(d, "ivf"))
        store = VectorStore(d)
        idxs.append(IVFIndex.build(store, pq_m=PQ_M, device="cpu", **BUILD))
        files.append({n: open(os.path.join(index_dir(store), n), "rb").read()
                      for n in _npy_files(index_dir(store))})
    assert files[0] == files[1]
    mans = [json.loads(json.dumps(i.manifest)) for i in idxs]
    for man in mans:
        man.pop("build_seconds")
        man["pq"].pop("train_seconds")
    assert mans[0] == mans[1]
    other = IVFIndex.build(VectorStore(str(tmp_path / "a")),
                           **{**BUILD, "seed": 4}, device="cpu")
    assert not np.array_equal(other.centroids, idxs[0].centroids)


def test_recall_vs_exact_and_index_hits_match_jax(built, mesh):
    for case in ("fp16", "int8_pq"):
        js, _ = built[case]["jax"]
        port_store = VectorStore(js.directory)
        port = IVFIndex.open(port_store, device="cpu")
        jax_ = JaxIndex.open(js)
        gold = np.arange(len(QUERIES)) * 7
        for nprobe in (1, 3):
            got = recall_vs_exact(port, port_store, QUERIES, k=10,
                                  nprobe=nprobe, device="cpu")
            want = jax_recall_vs_exact(jax_, js, QUERIES, mesh, k=10,
                                       nprobe=nprobe)
            assert got == pytest.approx(want, abs=1e-12)
            assert 0.0 < got <= 1.0
            hits = hits_from_store(QUERIES, port_store, gold, k=10,
                                   index=port, nprobe=nprobe)
            assert hits == jax_hits(QUERIES, js, gold, mesh, k=10,
                                    index=jax_, nprobe=nprobe)
            assert recall_from_store(QUERIES, port_store, gold, k=10,
                                     index=port, nprobe=nprobe) == \
                hits / len(QUERIES)
        assert recall_vs_exact(port, port_store, QUERIES, k=10, nprobe=NLIST,
                               device="cpu") >= 0.95


class _Corpus:
    num_pages = len(QUERIES)

    @staticmethod
    def query_text(i: int) -> str:
        return f"q{i}"


def test_mine_with_index_matches_jax(built, mesh, tmp_path):
    def embed_texts(texts, tower="query"):
        return QUERIES[[int(t[1:]) for t in texts]]

    cfg = SimpleNamespace(eval=SimpleNamespace(embed_batch_size=8))
    port_emb = SimpleNamespace(cfg=cfg, device=torch.device("cpu"),
                               embed_texts=embed_texts)
    jax_emb = SimpleNamespace(cfg=cfg, mesh=mesh, embed_texts=embed_texts)
    for case in ("int8", "fp16_pq"):
        js, _ = built[case]["jax"]
        port_store = VectorStore(js.directory)
        port = IVFIndex.open(port_store, device="cpu")
        for nprobe, block in ((2, None), (NLIST, 10)):
            got = mine_hard_negatives(
                port_emb, _Corpus(), port_store, num_negatives=5,
                search_k=20, query_block=block, index=port, nprobe=nprobe)
            want = jax_mine(jax_emb, _Corpus(), js, num_negatives=5,
                            search_k=20, query_block=block,
                            index=JaxIndex.open(js), nprobe=nprobe)
            np.testing.assert_array_equal(got.table, want.table)
            assert not (got.table == np.arange(len(QUERIES))[:, None]).any()
    path = str(tmp_path / "negs.npy")
    got = mine_hard_negatives(port_emb, _Corpus(), port_store,
                              num_negatives=5, search_k=20, index=port,
                              nprobe=NLIST, out_path=path)
    np.testing.assert_array_equal(np.load(path), got.table)


def test_unported_parts_raise(built):
    """update() is ported (tests/test_torch_updates.py): on an index that
    is current it is a no-op, deferred or not (the deferred rebuild is
    tests/test_torch_maintenance_service.py's). The hot posting set and
    filtered search serve (tests/test_torch_filtered.py holds them against
    the JAX package): here, over a store without an attribute table, the
    whole index staged gives the mmap path's results, and lang==0 keeps
    every row (all-zero words) while lang==1 keeps none. A partition's
    view holds only its shards' postings (tests/test_torch_partition.py
    holds it against the JAX package)."""
    from dnn_page_vectors_tpu_torch.index.attrs import Predicate
    store, idx = built["fp16_pq"]["port"]
    same, info = IVFIndex.update(store, device="cpu")
    assert info["action"] == "noop" and same.index_generation == 0
    same, info = IVFIndex.update(store, defer_rebuild=True, device="cpu")
    assert info["action"] == "noop" and same.index_generation == 0
    hot = IVFIndex.open(store, device="cpu")
    summary = hot.stage_hot(1 << 20)
    assert summary == {"hot_lists": NLIST, "hot_rows": N,
                       "hot_bytes": N * (PQ_M + 4),
                       "hot_by_popularity": False}
    assert hot.hot_rows == N
    want_s, want_i, want_st = idx.search(QUERIES, k=5, nprobe=4)
    got_s, got_i, got_st = hot.search(QUERIES, k=5, nprobe=4)
    _same_topk(got_s, got_i, want_s, want_i)
    assert got_st["hot_rows_scored"] == want_st["candidates_reranked"] > 0
    assert got_st["gather_bytes"] < want_st["gather_bytes"]
    s0, i0, st0 = idx.search(QUERIES, k=5, nprobe=4,
                             predicate=Predicate.parse("lang==0"))
    _same_topk(s0, i0, want_s, want_i)
    assert st0["gather_bytes"] == want_st["gather_bytes"]
    _, i1, st1 = idx.search(QUERIES, k=5, nprobe=4,
                            predicate=Predicate.parse("lang==1"))
    assert (i1 == -1).all() and st1["gather_bytes"] == 0
    part = idx.partition_view([0])
    assert set(part._postings) == {0} and part.pq is idx.pq
    assert int(part.list_sizes.sum()) == store.shards()[0]["count"]


# -- the index behind SearchService, and its faults ---------------------------

SERVE_OV = {"data.num_pages": 300, "data.trigram_buckets": 512,
            "model.embed_dim": 16, "model.conv_channels": 32,
            "model.out_dim": 24, "eval.embed_batch_size": 100,
            "eval.store_shard_size": 100}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A seeded cdssm_toy tower at small widths, its 300 pages in a 3-shard
    float16 store stamped at step 5."""
    cfg = get_config("cdssm_toy", SERVE_OV)
    corpus = build_corpus(cfg)
    q_tok, p_tok = build_tokenizer(cfg, corpus)
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device="cpu")
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device="cpu")
    store = VectorStore(str(tmp_path_factory.mktemp("served") / "store"),
                        dim=24, shard_size=100)
    store.ensure_model_step(5)
    emb.embed_corpus(corpus, store)
    queries = [corpus.query_text(i) for i in (2, 77, 290, 150)]
    return SimpleNamespace(cfg=cfg, corpus=corpus, emb=emb, store=store,
                           queries=queries)


def _service_store(served, tmp_path, pq_m=0):
    """A copy of the served store with an index of 8 lists."""
    d = str(tmp_path / "store")
    shutil.copytree(served.store.directory, d)
    store = VectorStore(d)
    IVFIndex.build(store, nlist=8, iters=3, seed=0, pq_m=pq_m, device="cpu")
    return store


def _ivf_cfg(served, **kw):
    return get_config("cdssm_toy", {**SERVE_OV, "serve.index": "ivf", **{
        f"serve.{k}": v for k, v in kw.items()}})


def test_ivf_service_serves_and_counts(served, tmp_path):
    store = _service_store(served, tmp_path, pq_m=4)
    svc = SearchService(_ivf_cfg(served, nprobe=8), served.emb,
                        served.corpus, store)
    exact = SearchService(served.cfg, served.emb, served.corpus, store)
    got = svc.search_many(served.queries, k=10)
    want = exact.search_many(served.queries, k=10)
    # nprobe = nlist, the default rerank depth covers the 300 rows' cut
    for g, w in zip(got, want):
        assert {r["page_id"] for r in g} == {r["page_id"] for r in w}
    met = svc.metrics()
    assert met["ann_fallbacks"] == 0
    assert met["ann_lists_scanned"] == len(served.queries) * 8
    assert met["ann_candidates_reranked"] > 0 and met["ann_gather_bytes"] > 0
    assert met["ann_index"] == {"index": "ivf", "nprobe": 8, "nlist": 8,
                                "available": True, "pq_m": 4, "hot_rows": 0}
    assert not any(k.startswith("ann_") for k in exact.metrics())
    assert svc.search(served.queries[0], k=10) == got[0]


def test_model_step_restamp_falls_back_to_exact(served, tmp_path):
    store = _service_store(served, tmp_path)
    svc = SearchService(_ivf_cfg(served), served.emb, served.corpus, store)
    assert svc.index is not None
    store.ensure_model_step(6)                      # reset + restamp
    with pytest.raises(IndexUnavailable, match="stale"):
        IVFIndex.open(store, device="cpu")
    assert svc.search("anything", k=5) == []        # the store is empty now
    assert svc.ann_fallbacks == 1 and svc.metrics()["ann_fallbacks"] == 1


@pytest.mark.parametrize("victim", ["posting_00001.ord.npy",
                                    "posting_00002.pqc.npy"])
def test_corrupt_index_file_quarantined_service_serves_exact(
        served, tmp_path, victim):
    store = _service_store(served, tmp_path, pq_m=4)
    path = os.path.join(index_dir(store), victim)
    with open(path, "r+b") as f:                    # flip one byte
        f.seek(-3, os.SEEK_END)
        b = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IndexUnavailable, match="rebuild"):
        IVFIndex.open(store, device="cpu")
    assert os.path.exists(path + ".quarantined") and not os.path.exists(path)
    svc = SearchService(_ivf_cfg(served), served.emb, served.corpus, store)
    assert svc.index is None and "rebuild" in svc.index_error
    exact = SearchService(served.cfg, served.emb, served.corpus, store)
    got = svc.search_many(served.queries, k=10)
    want = exact.search_many(served.queries, k=10)
    assert [[r["page_id"] for r in g] for g in got] == \
        [[r["page_id"] for r in w] for w in want]
    met = svc.metrics()
    assert met["ann_fallbacks"] == len(served.queries)
    assert not met["ann_index"]["available"] and "error" in met["ann_index"]
    with pytest.raises(ValueError, match="serve.index"):
        SearchService(get_config("cdssm_toy", {**SERVE_OV,
                                               "serve.index": "hnsw"}),
                      served.emb, served.corpus, store)
