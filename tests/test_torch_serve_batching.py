"""The port's serving under load (infer/serve.py) against the JAX package's
SearchService, on the CPU: config 3's towers cut to 2 layers, d=64, over
300 toy pages with flax-initialized weights converted by
``params_from_flax``, flash attention at float32. search_many equals
sequential search on the staged and the streaming paths, and both equal
the JAX service's search_many within 1e-3 (ties aside, as
tests/test_torch_serve.py holds them); a store over the preload budget is
served by the streaming path; repeats within a call are encoded once; the
micro-batcher coalesces concurrent callers and a poisoned request fails
alone; the query cache's hits, misses, LRU eviction, off switch and
model-step invalidation; the result cache (keyed as JAX keys it); warmup;
metrics and the request traces."""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import MeshConfig
from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.loader import (
    build_corpus as jax_build_corpus, build_tokenizer as jax_build_tokenizer)
from dnn_page_vectors_tpu.infer.bulk_embed import BulkEmbedder as JaxEmbedder
from dnn_page_vectors_tpu.infer.serve import SearchService as JaxService
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.models.factory import build_two_tower as jax_build
from dnn_page_vectors_tpu.parallel.mesh import make_mesh
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.convert import params_from_flax
from dnn_page_vectors_tpu_torch.data.loader import (
    build_corpus, build_tokenizer)
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower

VOCAB = 600
OV = {"data.num_pages": 300, "data.vocab_size": VOCAB,
      "model.num_layers": 2, "model.model_dim": 64, "model.num_heads": 4,
      "model.mlp_dim": 128, "model.out_dim": 32,
      "model.attention": "flash", "model.dtype": "float32",
      "eval.embed_batch_size": 64, "eval.store_shard_size": 128}
JAX_OV = {**OV, "model.dropout": 0.0, "eval.embed_stack": 1,
          "data.tokenize_workers": 1}
QUERIES = [0, 7, 42, 99, 123, 150, 201, 255, 299, 17, 64]
# a query encoded in another bucket differs in the last bits, which can
# move its score, rounded to 4 decimals, by one unit
ROUND = 1.01e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_batching")
    jcfg = jax_get_config("bert_mini_v5p16", JAX_OV)
    tcfg = get_config("bert_mini_v5p16", OV)
    jcorpus, tcorpus = jax_build_corpus(jcfg), build_corpus(tcfg)
    jq_tok, jp_tok = jax_build_tokenizer(jcfg, jcorpus)
    tq_tok, tp_tok = build_tokenizer(tcfg, tcorpus)
    jmodel = jax_build(jcfg, vocab_size=VOCAB)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((2, jcfg.data.query_len), jnp.int32),
                         jnp.zeros((2, jcfg.data.page_len), jnp.int32))
    jemb = JaxEmbedder(jcfg, jmodel, params, jp_tok,
                       make_mesh(MeshConfig(data=1)), query_tok=jq_tok)
    tmodel = build_two_tower(tcfg, vocab_size=VOCAB, device="cpu")
    tmodel.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    temb = BulkEmbedder(tcfg, tmodel, tp_tok, query_tok=tq_tok,
                        device="cpu")
    tstore = VectorStore(os.path.join(root, "store"), dim=32,
                         shard_size=128)
    temb.embed_corpus(tcorpus, tstore)
    queries = [tcorpus.query_text(i) for i in QUERIES]
    return dict(jcfg=jcfg, tcfg=tcfg, jcorpus=jcorpus, tcorpus=tcorpus,
                jemb=jemb, temb=temb, tstore=tstore, root=root,
                queries=queries)


def _svc(world, preload=4.0, **over):
    """A service over the world's store; bare keys are serve.* knobs."""
    cfg = get_config("bert_mini_v5p16", {**OV, **{
        k if "." in k else f"serve.{k}": v for k, v in over.items()}})
    return SearchService(cfg, world["temb"], world["tcorpus"],
                         world["tstore"], preload_hbm_gb=preload)


def _same(got, want, atol, tie=1e-6):
    """ids equal except where a score tie (within `tie`) may reorder;
    scores within `atol`."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        gs = np.array([r["score"] for r in g])
        ws = np.array([r["score"] for r in w])
        np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)
        for j, (a, b) in enumerate(zip(w, g)):
            if a["page_id"] != b["page_id"]:
                near = [abs(ws[j] - ws[x]) <= max(tie, atol)
                        for x in (j - 1, j + 1) if 0 <= x < len(ws)]
                assert any(near), (j, a, b)
            assert b["snippet"] == a["snippet"] or a["page_id"] != \
                b["page_id"]


def _raw_same(s1, i1, s2, i2, tol=1e-6):
    """Raw top-k: scores within `tol`, ids equal except at ties."""
    np.testing.assert_allclose(s1, s2, rtol=0, atol=tol)
    for r in range(s1.shape[0]):
        for j in np.flatnonzero(i1[r] != i2[r]):
            assert any(abs(s2[r, j] - s2[r, x]) <= tol
                       for x in (j - 1, j + 1) if 0 <= x < s2.shape[1])


def test_staged_streaming_sequential_and_jax_agree(world):
    queries = world["queries"]
    staged = _svc(world, query_cache_size=0)
    streaming = _svc(world, preload=0.0, query_cache_size=0)
    assert staged.preloaded and not streaming.preloaded
    assert staged.num_vectors == streaming.num_vectors == 300
    many = staged.search_many(queries, k=10)
    for svc in (staged, streaming):
        # the raw top-k of one call's buckets against one query at a time
        view = svc._view
        qv_many = svc._embed_queries_cached(view, queries)
        qv_seq = torch.cat([svc._embed_queries_cached(view, [q])
                            for q in queries])
        _raw_same(*svc.topk_vectors(qv_seq, k=10),
                  *svc.topk_vectors(qv_many, k=10))
        seq = [svc.search(q, k=10) for q in queries]
        _same(seq, many, atol=ROUND)
        _same(svc.search_many(queries, k=10), many, atol=ROUND)
    jsvc = JaxService(world["jcfg"], world["jemb"], world["jcorpus"],
                      JaxStore(world["tstore"].directory))
    want = jsvc.search_many(queries, k=10)
    _same(many, want, atol=1e-3)
    _same(streaming.search_many(queries, k=10), want, atol=1e-3)
    # one dispatch for the call's misses, padded to a multiple of
    # query_batch: 11 queries, 16 rows
    assert staged.query_batch == jsvc.query_batch == 8
    before, rows = staged.encodes, []
    encode = staged._encode

    def spy(enc):
        rows.append(enc.shape[0])
        return encode(enc)
    staged._encode = spy
    staged.search_many(queries, k=10)
    assert staged.encodes - before == 1 and rows == [16]
    # raw vectors through both paths
    qv = world["temb"].embed_texts(queries[:3])
    s1, i1 = staged.topk_vectors(qv, k=5)
    s2, i2 = streaming.topk_vectors(qv, k=5)
    _raw_same(s1, i1, s2, i2)
    assert i1.dtype == np.int64 and s1.dtype == np.float32
    # filtered retrieval over a store without an attribute table: every
    # word is zero, so lang==0 keeps every row and lang==1 none (the
    # filtered paths against JAX's are tests/test_torch_filtered.py's)
    assert staged.search("x", filters="lang==0") == staged.search("x")
    assert staged.search("x", filters="lang==1") == []
    with pytest.raises(ValueError, match="cannot parse predicate term"):
        staged.search("x", filters="lang=0")


def test_store_over_the_budget_streams_with_the_staged_results(world):
    """The budget is decided before staging: a store over it is answered
    shard by shard from disk, with the staged path's results."""
    need_gb = 300 * 32 * 2 / 2 ** 30
    small = _svc(world, preload=need_gb * 0.99, query_cache_size=0)
    fits = _svc(world, preload=need_gb, query_cache_size=0)
    assert not small.preloaded and small.pages is None
    assert fits.preloaded and fits.pages.shape == (300, 32)
    assert fits.pages.dtype == torch.float16
    np.testing.assert_array_equal(fits.page_ids, np.arange(300))
    _same(small.search_many(world["queries"], k=10),
          fits.search_many(world["queries"], k=10), atol=ROUND)
    assert small.metrics()["serve_preloaded"] is False
    m = small.metrics()
    assert m["serve_stage_topk_n"] == 1 and "serve_stage_merge_n" not in m


def test_duplicates_within_a_call_encode_once(world):
    svc = _svc(world, query_cache_size=0)
    seen = []
    tok = svc._tokenize

    def spy(texts):
        seen.append(list(texts))
        return tok(texts)
    svc._tokenize = spy
    q = world["queries"]
    batch = [q[0], q[1], "  " + q[0] + " ", q[2], q[1], q[0]]
    got = svc.search_many(batch, k=10)
    assert seen == [[q[0], q[1], q[2]]]       # normalized repeats folded
    assert svc.encodes == 1
    assert got[0] == got[2] == got[5] and got[1] == got[4]
    # with the cache on, repeats still count as misses, not hits
    svc2 = _svc(world)
    svc2.search_many(batch, k=10)
    assert (svc2.cache_hits, svc2.cache_misses) == (0, 6)


def test_batcher_coalesces_concurrent_callers(world):
    queries = world["queries"]
    svc = _svc(world, batch_window_ms=1000.0, max_batch=16,
               query_cache_size=0)
    want = svc.search_many(queries, k=10)
    svc.start_batcher()
    assert svc.batching
    out = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def call(i):
        barrier.wait()
        out[i] = svc.search(queries[i], k=10)
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    _same(out, want, atol=ROUND)
    sizes = svc.batch_sizes
    assert sum(sizes) == len(queries) and max(sizes) > 1
    assert svc.batch_retries == 0
    m = svc.metrics()
    assert m["serve_batches"] == len(sizes)
    assert m["serve_stage_queue_wait_n"] == len(queries)
    # each request's trace holds its queue wait and the adopted dispatch
    tr = svc.tracer.last_trace()
    assert tr["name"] == "search"
    names = [c["name"] for c in tr["children"]]
    assert names == ["queue_wait", "dispatch"]
    svc.close()
    assert not svc.batching and svc.batch_sizes == sizes


def test_poisoned_request_fails_alone(world):
    svc = _svc(world, batch_window_ms=1000.0, query_cache_size=0)
    tok = svc.embedder.query_tok

    class Poisoned:
        def __getattr__(self, name):
            return getattr(tok, name)

        def encode_batch(self, texts):
            if any("POISON" in t for t in texts):
                raise ValueError("poisoned query")
            return tok.encode_batch(texts)
    queries = world["queries"][:5]
    want = svc.search_many(queries, k=10)
    svc.embedder.query_tok = Poisoned()
    try:
        svc.start_batcher()
        futs = [svc._batcher.submit(q, 10) for q in queries[:2]]
        bad = svc._batcher.submit("POISON pill", 10)
        futs += [svc._batcher.submit(q, 10) for q in queries[2:]]
        results = [f.result(timeout=60) for f in futs]
        with pytest.raises(ValueError, match="poisoned"):
            bad.result(timeout=60)
    finally:
        svc.embedder.query_tok = tok
        svc.close()
    _same(results, want, atol=ROUND)
    assert svc.batch_sizes == [6]             # one coalesced batch
    assert svc.batch_retries == 6             # each retried alone
    assert svc.metrics()["serve_batch_retries"] == 6


def test_query_cache_hits_misses_lru_off_switch_and_model_step(world):
    q = world["queries"]
    svc = _svc(world, query_cache_size=2)
    first = svc.search(q[0], k=10)
    assert (svc.cache_hits, svc.cache_misses, svc.encodes) == (0, 1, 1)
    assert svc.search(" " + q[0] + "  ", k=10) == first   # normalized hit
    assert (svc.cache_hits, svc.cache_misses, svc.encodes) == (1, 1, 1)
    tr = svc.tracer.last_trace()
    assert tr["attrs"]["cache_hits"] == 1
    assert "encode" not in [c["name"] for c in tr["children"]]
    svc.search_many([q[1], q[2]], k=10)                # evicts q[0]
    assert svc.encodes == 2
    svc.search(q[0], k=10)
    assert (svc.cache_hits, svc.cache_misses) == (1, 4)
    assert svc.metrics()["serve_cache_hit_rate"] == 0.2
    # a restamped store changes every key: all misses
    step = world["tstore"].manifest.get("model_step")
    world["tstore"].manifest["model_step"] = 123
    try:
        svc.search(q[0], k=10)
        assert svc.cache_misses == 5
    finally:
        if step is None:
            world["tstore"].manifest.pop("model_step")
        else:
            world["tstore"].manifest["model_step"] = step
    svc.clear_cache()
    assert svc.registry.events("cache_cleared")[-1]["attrs"][
        "embed_entries"] == 2
    off = _svc(world, query_cache_size=0)
    for _ in range(3):
        off.search(q[3], k=10)
    assert (off.cache_hits, off.cache_misses, off.encodes) == (0, 0, 3)


def test_result_cache_keyed_as_jax_keys_it(world):
    q = world["queries"]
    svc = _svc(world, result_cache=True, result_cache_size=2)
    a = svc.search(q[0], k=10)
    assert (svc.result_cache_hits, svc.result_cache_misses) == (0, 1)
    b = svc.search(q[0], k=10)
    assert b == a and svc.result_cache_hits == 1
    b[0]["page_id"] = -7                       # a copy per hit
    assert svc.search(q[0], k=10) == a
    encodes = svc.encodes
    assert svc.search_many([q[0], q[0]], k=10) == [a, a]   # all hits
    assert svc.encodes == encodes
    rc = svc.metrics()["result_cache"]
    assert rc["entries"] == 1 and rc["capacity"] == 2 and rc["bytes"] > 0
    svc.search_many([q[1], q[2]], k=10)
    assert svc.metrics()["result_cache"]["entries"] == 2   # LRU bound
    # another k is another key
    svc.search(q[0], k=5)
    assert svc.result_cache_misses >= 2
    jcfg = world["jcfg"].replace(serve=world["jcfg"].serve.__class__(
        **{**world["jcfg"].serve.__dict__, "result_cache": True}))
    jsvc = JaxService(jcfg, world["jemb"], world["jcorpus"],
                      JaxStore(world["tstore"].directory))
    for text, k, nprobe in ((q[0], 10, None), ("  a  b ", 5, 3),
                            (q[1], None, None)):
        assert svc._result_cache_key(text, k, nprobe) == \
            jsvc._result_cache_key(text, k, nprobe)
    assert _svc(world)._result_cache_key(q[0], 10, None) is None


def test_warmup_and_metrics(world):
    svc = _svc(world)
    svc.warmup(k=10, timing_iters=3)
    assert svc.warm_latency_ms > 0
    # the timed searches bypass both caches; the first one filled it
    assert svc.encodes == 4 and svc.cache_misses == 1
    assert svc._cache_cap == 4096
    m = svc.metrics()
    for key in ("serve_index", "num_vectors", "serve_cache_hits",
                "serve_window_qps", "serve_window_p99_ms",
                "serve_window_queue_wait_p99_ms", "serve_batch_window_ms",
                "serve_stage_encode_s", "serve_stage_topk_s",
                "serve_stage_format_s", "serve_encodes"):
        assert key in m, key
    # the generation keys are ported (live updates); a service that never
    # refreshed reads generation 0 and no refresh
    assert (m["store_generation"], m["refreshes"], m["docs_appended"],
            m["tombstoned"]) == (0, 0, 0, 0)
    for key in ("serve_degraded", "serve_recompiles", "transport",
                "result_cache"):
        assert key not in m, key
    snap = svc.metrics_snapshot()
    assert snap["metrics"]["num_vectors"] == 300
    assert snap["counters"]["serve.requests"]["value"] == 4
    text = svc.prometheus_text()
    assert "serve_requests 4" in text and "serve_latency_ms_count 4" in text
    sig = svc.autoscale_signals()
    assert set(sig) == {"queue_wait_p99_ms", "queue_wait_samples",
                        "shed_rate", "window_s"}
    # tracing off: the same results, no traces
    quiet = _svc(world, **{"obs.enabled": False})
    assert quiet.search(world["queries"][0], k=10) == \
        svc.search(world["queries"][0], k=10)
    assert quiet.tracer.traces() == []
    slow = _svc(world, **{"obs.slow_ms": 0.0})
    slow.search_many(world["queries"][:2], k=10)
    log = slow.tracer.slow_queries()
    assert len(log) == 1 and log[0]["name"] == "search_many"
    assert [c["name"] for c in log[0]["children"]] == \
        ["tokenize", "encode", "topk", "merge", "format"]


def test_adaptive_window_moves_under_the_batcher(world):
    svc = _svc(world, batch_window_adaptive=True, batch_window_ms=1.0,
               batch_window_max_ms=8.0)
    assert svc.batch_window_ms == 1.0
    for _ in range(8):
        svc._m_queue_wait.observe(50.0)
    svc._adapt_window()
    assert svc.batch_window_ms == 2.0
    ev = svc.registry.events("window_adapt")
    assert ev[-1]["attrs"]["reason"] == "pressure"
    assert svc.registry.gauge("serve.batch_window_ms").value == 2.0
    fixed = _svc(world, batch_window_ms=3.0)
    fixed._adapt_window()
    assert fixed.batch_window_ms == 3.0
