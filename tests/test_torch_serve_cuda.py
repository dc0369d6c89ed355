"""Serving under load on the card: config 3's towers (4 layers) over a
small fp16 store, staged against streaming, the micro-batcher with
concurrent callers, and K1's launches: 4 an encode at 4 layers, one encode
for a call's cache misses, none for a cache hit, all on the tensor cores;
an append with tombstones and updates and the refresh() that stages it.
Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_serve_cuda.py
"""
import threading

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
from dnn_page_vectors_tpu_torch.data.subword import SubwordTokenizer
from dnn_page_vectors_tpu_torch.data.synth import write_synth_jsonl
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.ops import flash_attention as fa

PAGES = 5_000


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    root = tmp_path_factory.mktemp("serve_cuda")
    path = write_synth_jsonl(str(root / "c.jsonl"), PAGES, seed=6,
                             page_len=32, query_len=8)
    corpus = JsonlCorpus(path)
    vocab = SubwordTokenizer.train(corpus.all_texts(limit=1_000),
                                   vocab_size=2_000).vocab
    cfg = get_config("bert_mini_v5p16", {
        "data.corpus": f"jsonl:{path}", "data.vocab_size": 2_000,
        "data.num_pages": PAGES, "model.attention": "flash",
        "eval.embed_batch_size": 512, "eval.store_shard_size": 1_024})
    q = SubwordTokenizer(vocab, max_tokens=cfg.data.query_len)
    p = SubwordTokenizer(vocab, max_tokens=cfg.data.page_len)
    model = build_two_tower(cfg, vocab_size=p.vocab_size, device="cuda")
    emb = BulkEmbedder(cfg, model, p, query_tok=q, device="cuda")
    store = VectorStore(str(root / "store"), dim=cfg.model.out_dim,
                        shard_size=1_024)
    emb.embed_corpus(corpus, store)
    queries = corpus.query_texts(range(0, PAGES, PAGES // 40))
    return cfg, emb, corpus, store, queries


def _service(served, preload=4.0, **serve):
    cfg, emb, corpus, store, _ = served
    cfg = get_config("bert_mini_v5p16", {
        "data.corpus": cfg.data.corpus, "data.vocab_size": 2_000,
        "model.attention": "flash",
        **{f"serve.{k}": v for k, v in serve.items()}})
    return SearchService(cfg, emb, corpus, store, preload_hbm_gb=preload)


def _ties_only(got, want, tol=1e-4):
    for g, w in zip(got, want):
        ws = [r["score"] for r in w]
        np.testing.assert_allclose([r["score"] for r in g], ws, rtol=0,
                                   atol=tol)
        for j, (a, b) in enumerate(zip(w, g)):
            if a["page_id"] != b["page_id"]:
                assert any(abs(ws[j] - ws[x]) <= tol
                           for x in (j - 1, j + 1) if 0 <= x < len(ws))


@pytest.mark.cuda
def test_staged_equals_streaming_and_a_plain_topk(served):
    queries = served[4]
    staged = _service(served, query_cache_size=0)
    streaming = _service(served, preload=0.0, query_cache_size=0)
    assert staged.preloaded and staged.pages.device.type == "cuda"
    assert not streaming.preloaded
    a = staged.search_many(queries, k=10)
    b = streaming.search_many(queries, k=10)
    _ties_only(b, a)
    qv = staged.encode_queries(queries)[: len(queries)]
    want_s, want_i = torch.topk(qv @ staged.pages.float().T, 10, dim=1)
    want = [[{"page_id": int(staged.page_ids[i]), "score": round(float(s), 4)}
             for s, i in zip(srow, irow)]
            for srow, irow in zip(want_s.cpu().numpy(),
                                  want_i.cpu().numpy())]
    _ties_only(a, want)


@pytest.mark.cuda
def test_batcher_on_the_card(served):
    queries = served[4]
    svc = _service(served, batch_window_ms=50.0, query_cache_size=0)
    want = svc.search_many(queries, k=10)
    svc.start_batcher()
    out = [None] * len(queries)

    def call(i):
        out[i] = svc.search(queries[i], k=10)
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    svc.close()
    # other buckets, other last bits: a rounded score may move one unit
    _ties_only(out, want, tol=1.01e-4)
    assert max(svc.batch_sizes) > 1 and svc.batch_retries == 0


@pytest.mark.cuda
def test_k1_launches_per_encode_and_none_for_a_hit(served):
    queries = served[4][:20]
    svc = _service(served)
    svc.search_many(["warm"], k=10)
    for name in fa.COUNTERS:
        setattr(fa, name, 0)
    enc0 = svc.encodes
    svc.search_many(queries, k=10)              # 20 misses: one dispatch
    torch.cuda.synchronize()
    layers = svc.cfg.model.num_layers
    assert svc.encodes - enc0 == 1
    assert fa.launches == fa.launches_tc == layers
    svc.search_many(queries, k=10)              # all hits: nothing
    svc.search(queries[0], k=10)
    assert fa.launches == layers
    assert svc.encodes - enc0 == 1
    assert svc.cache_hits == 21
    assert all(getattr(fa, n) == 0 for n in fa.COUNTERS
               if not n.startswith("launches"))


@pytest.mark.cuda
def test_append_tombstone_and_refresh_on_the_card(served, tmp_path):
    """A base of the first 4,096 pages staged on the card; an append of the
    rest with 8 pages updated and 8 deleted; refresh() copies only the
    appended rows from the host (at 512 B a float16 row, plus 8 B a newly
    masked row), and no dead row takes a result slot: k live hits equal
    to a service opened fresh on the store, where the dead rows are not
    staged at all."""
    from dnn_page_vectors_tpu_torch.updates import append_corpus
    cfg, emb, corpus, _, queries = served
    store = VectorStore(str(tmp_path / "s"), dim=cfg.model.out_dim,
                        shard_size=1_024)
    store.ensure_model_step(0)
    emb.embed_corpus(corpus, store, stop=4_096)
    svc = _service((cfg, emb, corpus, store, queries), query_cache_size=0)
    before = svc.search_many(queries, k=10)
    dead = sorted({h[0]["page_id"] for h in before})[:8]
    upd = [i for i in range(100, 4_096, 500)][:8]
    stats = append_corpus(emb, corpus, VectorStore(store.directory),
                          tombstone=dead, update_ids=upd)
    assert stats["appended"] == PAGES - 4_096 and stats["updated"] == 8
    info = svc.refresh()
    st = info["stage"]
    rows = PAGES - 4_096 + len(upd)
    assert st["h2d_rows"] == rows and st["reused_entries"] == 4
    assert st["newly_dead_rows"] == len(set(dead) | set(upd))
    assert st["h2d_bytes"] == rows * cfg.model.out_dim * 2 + \
        st["newly_dead_rows"] * 8
    assert svc.pages.device.type == "cuda" and svc._view.alive is not None
    after = svc.search_many(queries, k=10)
    assert all(len(h) == 10 for h in after)
    gone = set(dead)
    assert not gone & {h["page_id"] for r in after for h in r}
    fresh = _service((cfg, emb, corpus, VectorStore(store.directory),
                      queries), query_cache_size=0)
    assert fresh._view.alive is None
    _ties_only(after, fresh.search_many(queries, k=10))
    # an updated page serves once, from its new row
    for r in after:
        ids = [h["page_id"] for h in r]
        assert len(ids) == len(set(ids))
    svc.close()
    fresh.close()
