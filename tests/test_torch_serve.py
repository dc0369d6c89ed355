"""The port's serving slice end to end against the JAX package, on the CPU:
toy corpus -> WordPiece tokenizer -> page tower bulk embed into the fp16
vector store -> store staged whole -> query tower + exact top-k behind
SearchService.search_many, and the same service through the IVF index
(serve.index="ivf"). Same corpus, same vocab, same flax-initialized
weights (converted with params_from_flax), flash attention, float32 compute
(so the bars are the port's: fp16 store rows within 2e-3, scores within
1e-3). Small geometry: 2 layers, d=64, 4 heads, mlp 128, 300 pages."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnn_page_vectors_tpu.config import MeshConfig
from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.loader import (
    build_corpus as jax_build_corpus, build_tokenizer as jax_build_tokenizer)
from dnn_page_vectors_tpu.index.ivf import IVFIndex as JaxIndex
from dnn_page_vectors_tpu.infer.bulk_embed import BulkEmbedder as JaxEmbedder
from dnn_page_vectors_tpu.infer.serve import SearchService as JaxService
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.models.factory import build_two_tower as jax_build
from dnn_page_vectors_tpu.ops.topk import merge_topk_host as jax_merge
from dnn_page_vectors_tpu.parallel.mesh import make_mesh
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.convert import params_from_flax
from dnn_page_vectors_tpu_torch.data.loader import (
    build_corpus, build_tokenizer, iter_corpus_batches)
from dnn_page_vectors_tpu_torch.data.subword import SubwordTokenizer
from dnn_page_vectors_tpu_torch.evals.recall import recall_at_k
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import (
    VectorStore, prepare_store)
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.ops.topk import merge_topk_host

VOCAB = 600
OV = {"data.num_pages": 300, "data.vocab_size": VOCAB,
      "model.num_layers": 2, "model.model_dim": 64, "model.num_heads": 4,
      "model.mlp_dim": 128, "model.out_dim": 32,
      "model.attention": "flash", "model.dtype": "float32",
      "eval.embed_batch_size": 64, "eval.store_shard_size": 128}
JAX_OV = {**OV, "model.dropout": 0.0, "eval.embed_stack": 1,
          "data.tokenize_workers": 1}
QUERIES = [0, 7, 42, 99, 123, 150, 201, 255, 299]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    jcfg = jax_get_config("bert_mini_v5p16", JAX_OV)
    tcfg = get_config("bert_mini_v5p16", OV)
    jcorpus, tcorpus = jax_build_corpus(jcfg), build_corpus(tcfg)
    jq_tok, jp_tok = jax_build_tokenizer(jcfg, jcorpus)
    tq_tok, tp_tok = build_tokenizer(tcfg, tcorpus)
    jmodel = jax_build(jcfg, vocab_size=VOCAB)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((2, jcfg.data.query_len), jnp.int32),
                         jnp.zeros((2, jcfg.data.page_len), jnp.int32))
    mesh = make_mesh(MeshConfig(data=1))
    jemb = JaxEmbedder(jcfg, jmodel, params, jp_tok, mesh, query_tok=jq_tok)
    jstore = JaxStore(os.path.join(root, "jax_store"), dim=32,
                      shard_size=128)
    jemb.embed_corpus(jcorpus, jstore)

    tmodel = build_two_tower(tcfg, vocab_size=VOCAB, device="cpu")
    tmodel.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    temb = BulkEmbedder(tcfg, tmodel, tp_tok, query_tok=tq_tok,
                        device="cpu")
    tstore = VectorStore(os.path.join(root, "torch_store"), dim=32,
                         shard_size=128)
    temb.embed_corpus(tcorpus, tstore)
    return dict(jcfg=jcfg, tcfg=tcfg, jcorpus=jcorpus, tcorpus=tcorpus,
                jtoks=(jq_tok, jp_tok), ttoks=(tq_tok, tp_tok), jemb=jemb,
                temb=temb, jstore=jstore, tstore=tstore, root=root)


def test_corpus_and_tokens_byte_identical(world):
    jc, tc = world["jcorpus"], world["tcorpus"]
    for i in range(jc.num_pages):
        assert jc.page_text(i) == tc.page_text(i)
        assert jc.query_text(i) == tc.query_text(i)
    (jq, jp), (tq, tp) = world["jtoks"], world["ttoks"]
    assert tp.vocab == jp.vocab and tp.vocab_size == VOCAB
    pages = [tc.page_text(i) for i in range(jc.num_pages)]
    queries = [tc.query_text(i) for i in range(jc.num_pages)]
    np.testing.assert_array_equal(tp.encode_batch(pages),
                                  jp.encode_batch(pages))
    np.testing.assert_array_equal(tq.encode_batch(queries),
                                  jq.encode_batch(queries))
    # the bulk sweep pads its last batch with all-pad rows, page_id -1
    last = list(iter_corpus_batches(tc, tp, 64, start=256))[-1]
    assert (last["page_id"][44:] == -1).all() and not last["page"][44:].any()


def test_tokenizer_save_load_round_trip(world, tmp_path):
    tp = world["ttoks"][1]
    path = os.path.join(tmp_path, "tok.json")
    tp.save(path)
    back = SubwordTokenizer.load(path)
    text = world["tcorpus"].page_text(3)
    np.testing.assert_array_equal(back.encode(text), tp.encode(text))
    assert back.meta == tp.meta


def test_store_vectors_agree_and_cross_read(world):
    jstore, tstore = world["jstore"], world["tstore"]
    assert tstore.num_vectors == jstore.num_vectors == 300
    assert [s["count"] for s in tstore.shards()] == \
        [s["count"] for s in jstore.shards()]
    j_ids, j_vecs = jstore.load_all()
    t_ids, t_vecs = tstore.load_all()
    np.testing.assert_array_equal(t_ids, j_ids)
    assert t_vecs.dtype == j_vecs.dtype == np.float16
    np.testing.assert_allclose(t_vecs.astype(np.float32),
                               j_vecs.astype(np.float32), rtol=0, atol=2e-3)
    # each package opens the other's store, integrity checks included
    cross_j = JaxStore(tstore.directory)
    assert cross_j.verify() == []
    ids, vecs = cross_j.load_all()
    np.testing.assert_array_equal(ids, t_ids)
    np.testing.assert_array_equal(vecs, t_vecs)
    cross_t = VectorStore(jstore.directory)
    assert cross_t.verify() == []
    ids, vecs = cross_t.load_all()
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(vecs, j_vecs)


def test_embed_dtype_contract(world):
    temb = world["temb"]
    texts = [world["tcorpus"].query_text(i) for i in range(3)]
    assert temb.embed_texts(texts, tower="query").dtype == np.float32
    assert temb.embed_texts(texts, tower="page").dtype == np.float16
    want = world["jemb"].embed_texts(texts, tower="query")
    np.testing.assert_allclose(temb.embed_texts(texts, tower="query"), want,
                               rtol=0, atol=1e-4)


def test_search_many_matches_jax_service(world):
    jsvc = JaxService(world["jcfg"], world["jemb"], world["jcorpus"],
                      world["jstore"])
    tsvc = SearchService(world["tcfg"], world["temb"], world["tcorpus"],
                         world["tstore"])
    assert tsvc.query_batch == jsvc.query_batch == 8
    queries = [world["tcorpus"].query_text(i) for i in QUERIES]
    want = jsvc.search_many(queries, k=10)
    got = tsvc.search_many(queries, k=10)
    assert len(got) == len(want) == len(QUERIES)
    for w, g in zip(want, got):
        assert len(w) == len(g) == 10
        ws = np.array([r["score"] for r in w])
        gs = np.array([r["score"] for r in g])
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-3)
        assert list(gs) == sorted(gs, reverse=True)
        for j, (a, b) in enumerate(zip(w, g)):
            if a["page_id"] != b["page_id"]:
                # only a score tie may reorder: a neighbour within 1e-3
                near = [abs(ws[j] - ws[x]) <= 1e-3
                        for x in (j - 1, j + 1) if 0 <= x < len(ws)]
                assert any(near), (j, a, b)
            assert b["snippet"] == world["tcorpus"].page_text(
                b["page_id"])[:160]
    assert tsvc.search(queries[0], k=10) == got[0]


def test_recall_at_k_matches_exhaustive_numpy(world):
    t_ids, t_vecs = world["tstore"].load_all()
    qv = world["temb"].embed_texts(
        [world["tcorpus"].query_text(i) for i in range(300)], tower="query")
    got = recall_at_k(qv, t_ids, t_vecs, np.arange(300), k=10, chunk=64,
                      device="cpu")
    scores = qv @ t_vecs.astype(np.float32).T
    top = np.argsort(-scores, axis=1)[:, :10]
    want = float((t_ids[top] == np.arange(300)[:, None]).any(1).mean())
    assert got == pytest.approx(want, abs=2 / 300)   # ties may swap one


def test_serve_requires_exact_index(world, tmp_path):
    """serve.index="ivf" serves through the IVF index: over one store and
    one index (built by the JAX package, opened by both), search_many
    equals the JAX service's."""
    import dataclasses
    import shutil
    d = str(tmp_path / "store")
    shutil.copytree(world["tstore"].directory, d)
    jstore = JaxStore(d)
    JaxIndex.build(jstore, world["jemb"].mesh, nlist=8, iters=3, seed=0)
    jcfg = world["jcfg"].replace(serve=dataclasses.replace(
        world["jcfg"].serve, index="ivf", nprobe=3))
    cfg = get_config("bert_mini_v5p16", {**OV, "serve.index": "ivf",
                                         "serve.nprobe": 3})
    jsvc = JaxService(jcfg, world["jemb"], world["jcorpus"], jstore,
                      preload_hbm_gb=0.0)
    tsvc = SearchService(cfg, world["temb"], world["tcorpus"],
                         VectorStore(d))
    assert tsvc.index is not None and tsvc.index.nlist == 8
    queries = [world["tcorpus"].query_text(i) for i in QUERIES]
    want = jsvc.search_many(queries, k=10)
    got = tsvc.search_many(queries, k=10)
    for w, g in zip(want, got):
        ws = np.array([r["score"] for r in w])
        gs = np.array([r["score"] for r in g])
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-3)
        for j, (a, b) in enumerate(zip(w, g)):
            if a["page_id"] != b["page_id"]:
                near = [abs(ws[j] - ws[x]) <= 1e-3
                        for x in (j - 1, j + 1) if 0 <= x < len(ws)]
                assert any(near), (j, a, b)
    met = tsvc.metrics()
    assert met["ann_fallbacks"] == jsvc.ann_fallbacks == 0
    assert met["ann_lists_scanned"] == len(QUERIES) * 3
    assert met["ann_index"]["nlist"] == 8


def test_store_quarantine_and_resume(world, tmp_path):
    """A shard whose bytes no longer match its CRC record is quarantined on
    open and re-embedded by the next embed_corpus; a stale model step
    resets the store (prepare_store)."""
    import shutil
    d = os.path.join(tmp_path, "store")
    shutil.copytree(world["tstore"].directory, d)
    want_ids, want_vecs = VectorStore(d).load_all()
    vec = os.path.join(d, "shard_00001.vec.npy")
    with open(vec, "r+b") as f:            # flip one byte past the header
        f.seek(200)
        b = f.read(1)
        f.seek(200)
        f.write(bytes([b[0] ^ 0xFF]))
    store = VectorStore(d)
    assert store.completed_shards() == {0, 2}
    assert store.manifest["missing_id_ranges"] == [[128, 256]]
    assert os.path.exists(vec + ".quarantined")
    world["temb"].embed_corpus(world["tcorpus"], store)
    assert store.completed_shards() == {0, 1, 2}
    assert store.manifest["missing_id_ranges"] == []
    ids, vecs = VectorStore(d).load_all()
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(vecs, want_vecs)
    # same step (unstamped): kept; another step: reset and restamped
    kept = prepare_store(d, 32, 128, None, model_step=None)
    assert kept.num_vectors == 300
    fresh = prepare_store(d, 32, 128, None, model_step=7)
    assert fresh.num_vectors == 0 and fresh.model_step == 7
    assert JaxStore(d).model_step == 7


def test_merge_topk_host_matches_jax():
    rng = np.random.default_rng(3)
    a_s, b_s = rng.normal(size=(5, 10)), rng.normal(size=(5, 10))
    a_i = rng.integers(0, 1000, size=(5, 10))
    b_i = rng.integers(0, 1000, size=(5, 10))
    b_i[:, -2:] = -1                       # empty slots never surface
    a_s, b_s = -np.sort(-a_s, axis=1), -np.sort(-b_s, axis=1)
    got = merge_topk_host(a_s, a_i, b_s, b_i)
    want = jax_merge(a_s, a_i, b_s, b_i)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_tokenizer_cache_honours_provenance(world, tmp_path):
    """A cached vocab is reused only while its (vocab_size, corpus
    fingerprint) provenance matches; otherwise it is retrained."""
    tcfg, tcorpus = world["tcfg"], world["tcorpus"]
    _, first = build_tokenizer(tcfg, tcorpus, cache_dir=str(tmp_path))
    path = os.path.join(tmp_path, "tokenizer_wordpiece.json")
    assert os.path.exists(path)
    assert first.vocab == world["ttoks"][1].vocab
    with open(path) as f:                  # poison the cached vocab
        blob = json.load(f)
    blob["vocab"] = {k: v for k, v in list(blob["vocab"].items())[:-1]}
    with open(path, "w") as f:
        json.dump(blob, f)
    _, cached = build_tokenizer(tcfg, tcorpus, cache_dir=str(tmp_path))
    assert len(cached.vocab) == len(first.vocab) - 1   # reused as cached
    other = get_config("bert_mini_v5p16", {**OV, "data.num_pages": 299})
    _, fresh = build_tokenizer(other, build_corpus(other),
                               cache_dir=str(tmp_path))
    assert fresh.vocab_size == VOCAB
    assert fresh.meta["corpus"] != blob["meta"]["corpus"]
