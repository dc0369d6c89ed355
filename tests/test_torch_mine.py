"""The port's mining slice (infer/vector_store.py read_ahead and
iter_shards, ops/topk.py topk_over_store, mine/ann.py and the streaming
evals/recall.py) against the JAX package on the CPU, at small sizes: the
same fp16 store directory read by both packages, the same seeded query
vectors, the same flax-initialised weights through convert.py.

Tolerances, each with its reason:
* shard reads, picked negatives and mined tables: byte-identical (the
  same integer and float16 data through the same selection);
* topk_over_store: ids equal, scores within 1e-6 (both score float16 rows
  widened to float32 against float32 queries in full precision; seeded
  normal vectors have no ties);
* evaluate_recall on converted weights: equal up to one query (a score
  tie may order two pages either way), as tests/test_torch_t5.py holds
  it;
* the mirror of the JAX package's tests/test_pipeline.py
  ``test_hard_negatives_beat_in_batch_only`` at its overrides: its own
  inequalities."""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import MeshConfig
from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.loader import build_corpus as jax_build_corpus
from dnn_page_vectors_tpu.data.loader import (
    build_tokenizer as jax_build_tokenizer)
from dnn_page_vectors_tpu.evals.recall import (
    evaluate_recall as jax_evaluate_recall)
from dnn_page_vectors_tpu.infer.bulk_embed import BulkEmbedder as JaxEmbedder
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.infer.vector_store import (
    read_ahead as jax_read_ahead)
from dnn_page_vectors_tpu.mine.ann import (
    _pick_negatives as jax_pick, mine_hard_negatives as jax_mine)
from dnn_page_vectors_tpu.models.factory import build_two_tower as jax_build
from dnn_page_vectors_tpu.ops.topk import topk_over_store as jax_topk_store
from dnn_page_vectors_tpu.parallel.mesh import make_mesh
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.convert import params_from_flax
from dnn_page_vectors_tpu_torch.data.loader import (
    build_corpus, build_tokenizer)
from dnn_page_vectors_tpu_torch.evals.recall import (
    evaluate_recall, hits_from_store, recall_from_store)
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import (
    VectorStore, read_ahead)
from dnn_page_vectors_tpu_torch.mine.ann import (
    HardNegatives, _pick_negatives, mine_hard_negatives)
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.ops.topk import topk_over_store
from dnn_page_vectors_tpu_torch.train.loop import Trainer

DIM = 16
# uneven shards and an empty one (an all-padding write records count 0)
SHARD_ROWS = (40, 0, 25, 7)


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """A port-written fp16 store of 72 vectors over 4 uneven shards, page
    ids shuffled so rows and ids differ."""
    d = str(tmp_path_factory.mktemp("store") / "store")
    rng = np.random.default_rng(11)
    n = sum(SHARD_ROWS)
    vecs = _unit(rng.normal(size=(n, DIM))).astype(np.float32)
    ids = rng.permutation(n).astype(np.int64)
    store = VectorStore(d, dim=DIM, shard_size=64)
    lo = 0
    for i, rows in enumerate(SHARD_ROWS):
        if rows:
            store.write_shard(i, ids[lo: lo + rows], vecs[lo: lo + rows])
        else:
            store.write_shard(i, np.full(8, -1, np.int64),
                              np.zeros((8, DIM), np.float32))
        lo += rows
    assert [s["count"] for s in store.shards()] == list(SHARD_ROWS)
    return d


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshConfig(data=1))


# -- the store's reader ----------------------------------------------------------

@pytest.mark.parametrize("impl", [read_ahead, jax_read_ahead],
                         ids=["port", "jax"])
def test_read_ahead_order_and_error_propagation(impl):
    assert list(impl(iter(range(20)), depth=1)) == list(range(20))
    assert list(impl(iter(range(7)), depth=3)) == list(range(7))
    assert list(impl(iter([]), depth=2)) == []

    def _boom():
        yield 1
        yield 2
        raise IOError("disk died mid-sweep")

    got = []
    with pytest.raises(IOError, match="disk died"):
        for x in impl(_boom(), depth=1):
            got.append(x)
    assert got == [1, 2]     # the items before the fault, in order
    # an abandoning consumer does not deadlock against a blocked reader
    it = impl(iter(range(1000)), depth=1)
    assert next(it) == 0
    it.close()


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_iter_shards_equal_jax_store(store_dir, prefetch):
    mine = list(VectorStore(store_dir).iter_shards(prefetch=prefetch))
    want = list(JaxStore(store_dir).iter_shards(prefetch=prefetch))
    assert len(mine) == len(want) == len(SHARD_ROWS)
    for (ids, vecs), (wids, wvecs) in zip(mine, want):
        assert ids.dtype == np.int64 and vecs.dtype == np.float16
        np.testing.assert_array_equal(ids, wids)
        np.testing.assert_array_equal(vecs, np.asarray(wvecs))
        if prefetch:         # read into memory on the reader's side
            assert not isinstance(vecs, np.memmap)
    # an explicit entries snapshot sweeps exactly those shards
    store = VectorStore(store_dir)
    entries = store.shards()[2:]
    got = [ids for ids, _ in store.iter_shards(prefetch=prefetch,
                                               entries=entries)]
    assert [len(g) for g in got] == list(SHARD_ROWS[2:])


def test_iter_shards_read_error_reaches_the_consumer(store_dir, tmp_path):
    import shutil
    d = str(tmp_path / "broken")
    shutil.copytree(store_dir, d)
    store = VectorStore(d, verify=False)
    os.remove(os.path.join(d, store.shards()[2]["vec"]))
    it = store.iter_shards(prefetch=1)
    got = []
    with pytest.raises(FileNotFoundError):
        for ids, _ in it:
            got.append(len(ids))
    assert got == list(SHARD_ROWS[:2])
    with pytest.raises(FileNotFoundError):
        topk_over_store(np.ones((2, DIM), np.float32), store, k=3,
                        device="cpu")


# -- the store-streamed top-k ------------------------------------------------------

@pytest.mark.parametrize("k,query_batch", [(10, 16), (5, 37), (100, 8)],
                         ids=["k10_qb16", "k5_one_block", "k100_pad"])
def test_topk_over_store_matches_jax(store_dir, mesh, k, query_batch):
    rng = np.random.default_rng(k)
    q = _unit(rng.normal(size=(37, DIM))).astype(np.float32)
    want_s, want_i = jax_topk_store(q, JaxStore(store_dir), mesh, k=k,
                                    chunk=16, query_batch=query_batch)
    got_s, got_i = topk_over_store(q, VectorStore(store_dir), k=k, chunk=16,
                                   query_batch=query_batch, device="cpu")
    assert got_s.dtype == np.float32 and got_i.dtype == np.int64
    assert got_s.shape == got_i.shape == (37, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-6)
    # against a plain top-k of the whole store
    ids, vecs = VectorStore(store_dir).load_all()
    full = q @ vecs.astype(np.float32).T
    n = min(k, full.shape[1])
    order = np.argsort(-full, axis=1, kind="stable")[:, :n]
    np.testing.assert_array_equal(got_i[:, :n], ids[order])
    if k > full.shape[1]:               # a store of fewer than k vectors
        assert (got_i[:, n:] == -1).all()
        assert np.isneginf(got_s[:, n:]).all()


def test_topk_over_store_edges(store_dir):
    store = VectorStore(store_dir)
    s, i = topk_over_store(np.zeros((0, DIM), np.float32), store, k=4,
                           device="cpu")
    assert s.shape == i.shape == (0, 4)
    q = np.ones((3, DIM), np.float32)
    # only the empty shard: nothing is staged, every slot stays empty
    s, i = topk_over_store(q, store, k=4, device="cpu",
                           entries=[store.shards()[1]])
    assert (i == -1).all() and np.isneginf(s).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            topk_over_store(q, store, k=4)


# -- picking negatives ---------------------------------------------------------------

def test_pick_negatives_byte_identical_to_jax():
    rng = np.random.default_rng(7)
    num_pages, B, k = 50, 64, 12
    gold = rng.integers(0, num_pages, B).astype(np.int64)
    retrieved = np.stack([rng.permutation(num_pages)[:k] for _ in range(B)])
    # the gold page among the results (first, middle, last)
    retrieved[0, 0] = gold[0]
    retrieved[1, 5] = gold[1]
    retrieved[2, -1] = gold[2]
    retrieved[3:10, 4:] = -1                   # -1 padding
    retrieved[10, :] = -1                      # nothing retrieved
    retrieved[11, 1:] = -1
    retrieved[11, 0] = gold[11]                # only the gold page
    for H in (3, 7, 12, 15):                   # H > k: the filler loop
        want = jax_pick(retrieved, gold, H, num_pages)
        got = _pick_negatives(retrieved, gold, H, num_pages)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert not (got == gold[:, None]).any() and (got >= 0).all()
    # a corpus smaller than H + 1: the filler cycles, never the gold page
    small = np.array([[1, -1]]), np.array([0])
    np.testing.assert_array_equal(_pick_negatives(*small, 4, 3),
                                  jax_pick(*small, 4, 3))


def test_hard_negatives_table(tmp_path):
    negs = HardNegatives(np.arange(12, dtype=np.int64).reshape(4, 3))
    assert negs.table.dtype == np.int32 and negs.num_negatives == 3
    np.testing.assert_array_equal(negs(np.array([3, 0])),
                                  [[9, 10, 11], [0, 1, 2]])
    with pytest.raises(ValueError, match="covers page ids < 4"):
        negs(np.array([1, 4]))
    path = str(tmp_path / "negs.npy")
    negs.save(path)
    assert not os.path.exists(path + ".tmp")
    back = HardNegatives.load(path)
    assert isinstance(back.table, np.memmap)
    np.testing.assert_array_equal(back.table, negs.table)
    with pytest.raises(ValueError, match="queries, H"):
        HardNegatives(np.zeros(3, np.int32))


# -- the miner, against the JAX miner on one store and one set of queries ----

NQ = 50


class _Corpus:
    num_pages = NQ

    @staticmethod
    def query_text(i: int) -> str:
        return f"q{i}"


def _stub_embedders(mesh):
    """Port and JAX stand-ins for BulkEmbedder that embed query `qi` as
    the seeded vector qi: both miners see the same queries."""
    vecs = _unit(np.random.default_rng(3).normal(size=(NQ, DIM))
                 ).astype(np.float32)

    def embed_texts(texts, tower="query"):
        assert tower == "query"
        return vecs[[int(t[1:]) for t in texts]]

    cfg = SimpleNamespace(eval=SimpleNamespace(embed_batch_size=8))
    port = SimpleNamespace(cfg=cfg, device=torch.device("cpu"),
                           embed_texts=embed_texts)
    jax_ = SimpleNamespace(cfg=cfg, mesh=mesh, embed_texts=embed_texts)
    return port, jax_


@pytest.fixture(scope="module")
def mine_store(tmp_path_factory):
    """NQ pages in 3 uneven shards; page i lies close to query i, so the
    gold page is usually the top hit and must be dropped."""
    d = str(tmp_path_factory.mktemp("mine") / "store")
    q = _unit(np.random.default_rng(3).normal(size=(NQ, DIM)))
    pages = _unit(q + 0.6 * np.random.default_rng(4).normal(size=q.shape))
    store = VectorStore(d, dim=DIM, shard_size=32)
    for i, (lo, hi) in enumerate(((0, 21), (21, 22), (22, NQ))):
        store.write_shard(i, np.arange(lo, hi), pages[lo:hi])
    return d


@pytest.mark.parametrize("search_k,query_block", [(10, None), (6, 16)])
def test_mine_in_memory_byte_identical_to_jax(mine_store, mesh, search_k,
                                              query_block):
    port, jemb = _stub_embedders(mesh)
    want = jax_mine(jemb, _Corpus(), JaxStore(mine_store), num_negatives=5,
                    search_k=search_k, query_block=query_block)
    got = mine_hard_negatives(port, _Corpus(), VectorStore(mine_store),
                              num_negatives=5, search_k=search_k,
                              query_block=query_block)
    assert got.table.dtype == want.table.dtype == np.int32
    np.testing.assert_array_equal(got.table, want.table)
    assert got.table.shape == (NQ, 5)
    assert not (got.table == np.arange(NQ)[:, None]).any()
    assert set(got.stats) == {"queries", "embed_s", "sweep_s", "pick_s",
                              "seconds"}
    assert got.stats["queries"] == NQ


def test_mine_out_path_and_incremental_byte_identical_to_jax(
        mine_store, mesh, tmp_path):
    port, jemb = _stub_embedders(mesh)
    paths = {w: str(tmp_path / f"{w}.npy") for w in ("port", "jax")}
    # a first mine over the first 30 queries, then the appended 20 (start)
    for num_queries, start in ((30, 0), (NQ, 30)):
        want = jax_mine(jemb, _Corpus(), JaxStore(mine_store),
                        num_negatives=4, search_k=9, query_block=16,
                        num_queries=num_queries, out_path=paths["jax"],
                        start=start)
        got = mine_hard_negatives(port, _Corpus(), VectorStore(mine_store),
                                  num_negatives=4, search_k=9,
                                  query_block=16, num_queries=num_queries,
                                  out_path=paths["port"], start=start)
        assert isinstance(got.table, np.memmap)
        assert got.table.shape == (num_queries, 4)
        np.testing.assert_array_equal(got.table, want.table)
        with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
            assert a.read() == b.read()
        assert not [f for f in os.listdir(tmp_path)
                    if f.endswith((".tmp", ".part"))]
    # the spliced rows equal a full mine's
    full = mine_hard_negatives(port, _Corpus(), VectorStore(mine_store),
                               num_negatives=4, search_k=9)
    np.testing.assert_array_equal(np.load(paths["port"]), full.table)
    with pytest.raises(ValueError, match="start > 0"):
        mine_hard_negatives(port, _Corpus(), VectorStore(mine_store),
                            num_negatives=4, start=5)
    with pytest.raises(NotImplementedError, match="IVF"):
        mine_hard_negatives(port, _Corpus(), VectorStore(mine_store),
                            index=object())


# -- the streaming eval on converted weights ------------------------------------

OV = {"data.num_pages": 160, "data.vocab_size": 400, "model.num_layers": 1,
      "model.model_dim": 32, "model.num_heads": 2, "model.mlp_dim": 64,
      "model.out_dim": 16, "data.page_len": 24, "data.query_len": 8,
      "model.dtype": "float32", "eval.embed_batch_size": 32,
      "eval.store_shard_size": 64}


def test_evaluate_recall_streams_like_jax(tmp_path, mesh):
    jcfg = jax_get_config("bert_mini_v5p16", {
        **OV, "model.dropout": 0.0, "eval.embed_stack": 1,
        "data.tokenize_workers": 1})
    tcfg = get_config("bert_mini_v5p16", OV)
    jcorpus, tcorpus = jax_build_corpus(jcfg), build_corpus(tcfg)
    jq, jp = jax_build_tokenizer(jcfg, jcorpus)
    tq, tp = build_tokenizer(tcfg, tcorpus)
    jmodel = jax_build(jcfg, vocab_size=400)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((2, 8), jnp.int32),
                         jnp.zeros((2, 24), jnp.int32))
    jemb = JaxEmbedder(jcfg, jmodel, params, jp, mesh, query_tok=jq)
    jstore = JaxStore(str(tmp_path / "jax"), dim=16, shard_size=64)
    jemb.embed_corpus(jcorpus, jstore)
    tmodel = build_two_tower(tcfg, vocab_size=400, device="cpu")
    tmodel.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    temb = BulkEmbedder(tcfg, tmodel, tp, query_tok=tq, device="cpu")
    tstore = VectorStore(str(tmp_path / "torch"), dim=16, shard_size=64)
    temb.embed_corpus(tcorpus, tstore)
    assert len(tstore.shards()) == 3          # the sweep crosses shards
    for k in (1, 10):
        want, n_want = jax_evaluate_recall(jemb, jcorpus, jstore,
                                           num_queries=120, k=k)
        got, n_got = evaluate_recall(temb, tcorpus, tstore, num_queries=120,
                                     k=k)
        assert n_got == n_want == 120
        assert got == pytest.approx(want, abs=1 / 120), k
    # the store-level helpers agree with the eval
    qv = temb.embed_texts([tcorpus.query_text(i) for i in range(120)])
    gold = np.arange(120)
    hits = hits_from_store(qv, tstore, gold, k=10, query_batch=50,
                           device="cpu")
    assert recall_from_store(qv, tstore, gold, k=10, device="cpu") == \
        hits / 120 == pytest.approx(got)
    with pytest.raises(NotImplementedError, match="IVF"):
        evaluate_recall(temb, tcorpus, tstore, index=object())


# -- mined negatives help (JAX tests/test_pipeline.py:47) -------------------------

def _eval(cfg, trainer, wd, tag):
    store = VectorStore(os.path.join(wd, "store_" + tag),
                        dim=cfg.model.out_dim, shard_size=256)
    emb = BulkEmbedder(cfg, trainer.model, trainer.page_tok,
                       query_tok=trainer.query_tok, device="cpu")
    emb.embed_corpus(trainer.corpus, store, batch_size=128)
    r, _ = evaluate_recall(emb, trainer.corpus, store, num_queries=400, k=10)
    return r, emb, store


def test_hard_negatives_beat_in_batch_only(tmp_path):
    """The JAX test at its overrides: from one partially trained snapshot
    (the branch point must be neither near-random, where mined negatives
    are same-topic near-duplicates, nor saturated), the same number of
    further steps reaches a higher Recall@10 with mined negatives than
    with in-batch negatives alone. 40 near-duplicate pages per topic and
    queries of mostly topic words: random Recall@10 is about 0.8%."""
    warm, extra = 75, 12
    cfg = get_config("cdssm_toy", {
        "data.num_pages": 1200,
        "data.num_topics": 30,
        "data.query_len": 24,
        "data.trigram_buckets": 4096,
        "model.embed_dim": 48,
        "model.conv_channels": 96,
        "model.out_dim": 48,
        "train.batch_size": 64,
        "train.steps": warm + extra,
        "train.warmup_steps": 10,
        "train.learning_rate": 2e-3,
        "train.log_every": 1000,
        "train.hard_negatives": 7,
        "eval.eval_queries": 400,
        "eval.embed_batch_size": 128,
    })
    wd = str(tmp_path)
    trainer = Trainer(cfg, workdir=wd, device="cpu")
    trainer.train(steps=warm)
    snap = trainer.state()
    snap = {"model": {k: v.clone() for k, v in snap["model"].items()},
            "optimizer": _clone(snap["optimizer"]), "step": snap["step"]}
    r_warm, emb, store = _eval(cfg, trainer, wd, "warm")
    negs = mine_hard_negatives(emb, trainer.corpus, store, num_negatives=7)

    # the table: its shape, in range, never the gold page
    assert negs.table.shape == (1200, 7)
    assert negs.table.min() >= 0 and negs.table.max() < 1200
    assert not (negs.table == np.arange(1200)[:, None]).any()

    trainer.hard_negative_lookup = None
    trainer.load_state(snap)
    trainer.train(steps=extra)
    r_in_batch, _, _ = _eval(cfg, trainer, wd, "in_batch")

    trainer.hard_negative_lookup = negs
    trainer.load_state(snap)
    trainer.train(steps=extra)
    r_mined, _, _ = _eval(cfg, trainer, wd, "mined")
    print(f"recall@10 warm {r_warm} in-batch {r_in_batch} mined {r_mined}")

    assert r_warm > 0.1, f"warmup failed to train at all: {r_warm}"
    assert r_mined > r_warm, (r_warm, r_mined)
    assert r_mined > r_in_batch, (
        f"mined negatives ({r_mined}) should beat in-batch-only "
        f"({r_in_batch}) from the same snapshot + step budget")


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree
