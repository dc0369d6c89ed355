"""Rolling migrations on the card: config 3's towers (4 layers, flash,
bf16 on the tensor cores) over a small fp16 store, two towers of one
geometry (seeds 0 and 1) standing for the two model steps. A dual-stamp
service on the card equals its run on the CPU with the same weights; K1
launches 8 times an encode of a query that misses the cache mid-sweep (4
layers, two towers) and 4 after the completion flip; a migrated unit's
staged rows equal the store's rows after refresh(), and only the unit's
rows come from the host. Every test here needs a CUDA device and skips
without one. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_migrate_cuda.py
"""
import copy

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
from dnn_page_vectors_tpu_torch.maintenance.migrate import MigrationPlan
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
from dnn_page_vectors_tpu_torch.updates import append_corpus

PAGES = 3_000


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    root = tmp_path_factory.mktemp("migrate_cuda")
    path = write_synth_jsonl(str(root / "c.jsonl"), PAGES, seed=8,
                             page_len=32, query_len=8)
    corpus = JsonlCorpus(path)
    vocab = SubwordTokenizer.train(corpus.all_texts(limit=1_000),
                                   vocab_size=2_000).vocab
    cfg = get_config("bert_mini_v5p16", {
        "data.corpus": f"jsonl:{path}", "data.vocab_size": 2_000,
        "data.num_pages": PAGES, "model.attention": "flash",
        "eval.embed_batch_size": 512, "eval.store_shard_size": 1_024,
        "serve.query_cache_size": 0})
    q = SubwordTokenizer(vocab, max_tokens=cfg.data.query_len)
    p = SubwordTokenizer(vocab, max_tokens=cfg.data.page_len)
    models = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        models.append(build_two_tower(cfg, vocab_size=p.vocab_size,
                                      device="cpu"))
    return cfg, corpus, q, p, models, root


def _embedder(world, i, device):
    cfg, _, q, p, models, _ = world
    return BulkEmbedder(cfg, copy.deepcopy(models[i]), p, query_tok=q,
                        device=device)


def _mid_sweep_store(world, name):
    """A base of 2,048 pages and one generation of the rest at step 1,
    the base migrated to step 2 on the card."""
    cfg, corpus, *_ , root = world
    d = str(root / name)
    store = VectorStore(d, dim=cfg.model.out_dim, shard_size=1_024)
    store.ensure_model_step(1)
    old = _embedder(world, 0, "cuda")
    old.embed_corpus(corpus, store, stop=2_048)
    append_corpus(old, corpus, VectorStore(d), start=2_048, stop=PAGES)
    plan = MigrationPlan(VectorStore(d), corpus, _embedder(world, 1, "cuda"),
                         2, batch_rows=512)
    plan.begin()
    plan.migrate_unit(0)
    return d, plan


def _reset_counts():
    torch.cuda.synchronize()
    for name in fa.COUNTERS:
        setattr(fa, name, 0)


@pytest.mark.cuda
def test_dual_stamp_service_on_the_card_equals_the_cpu(world):
    cfg, corpus, *_ = world
    d, _ = _mid_sweep_store(world, "card_vs_cpu")
    queries = corpus.query_texts(range(0, PAGES, 75))
    out = []
    for device in ("cuda", "cpu"):
        svc = SearchService(cfg, _embedder(world, 0, device), corpus,
                            VectorStore(d))
        svc.begin_migration(copy.deepcopy(world[4][1]), 2)
        view = svc._view
        assert view.steps == [1, 2] and len(view.runs) == 2
        qv = svc._embed_queries_cached(view, queries)
        assert qv.device.type == device
        s, i, _ = svc._topk_view(view, qv, len(queries), 10)
        out.append((qv.cpu().numpy(), s, i))
        svc.close()
    (cq, cs, ci), (pq, ps, pi) = out
    # bf16 towers on the card and on the CPU: the query vectors and the
    # scores within 2e-2; an id only where the other's list ties it
    np.testing.assert_allclose(cq, pq, rtol=0, atol=2e-2)
    np.testing.assert_allclose(cs, ps, rtol=0, atol=2e-2)
    for r in range(len(queries)):
        for j in np.flatnonzero(~np.isin(ci[r], pi[r])):
            assert cs[r, j] <= ps[r, -1] + 2e-2, (r, j)


@pytest.mark.cuda
def test_k1_launches_twice_per_encode_mid_sweep_and_once_after(world):
    cfg, corpus, *_ = world
    layers = cfg.model.num_layers
    d, plan = _mid_sweep_store(world, "launches")
    svc = SearchService(cfg, _embedder(world, 0, "cuda"), corpus,
                        VectorStore(d))
    svc.begin_migration(copy.deepcopy(world[4][1]), 2)
    svc.search_many(["warm"], k=10)
    _reset_counts()
    svc.search_many(corpus.query_texts(range(5)), k=10)
    torch.cuda.synchronize()
    assert fa.launches == fa.launches_tc == 2 * layers
    plan.migrate_unit(1)
    assert plan.complete()["action"] == "completed"
    info = svc.refresh()
    assert info["migration_adopted_step"] == 2 and svc._towers == {}
    _reset_counts()
    svc.search_many(corpus.query_texts(range(5, 10)), k=10)
    torch.cuda.synchronize()
    assert fa.launches == fa.launches_tc == layers
    assert all(getattr(fa, n) == 0 for n in fa.COUNTERS
               if not n.startswith("launches"))
    svc.close()


@pytest.mark.cuda
def test_a_migrated_unit_is_staged_at_its_rows(world):
    cfg, corpus, *_ = world
    d, plan = _mid_sweep_store(world, "restage")
    svc = SearchService(cfg, _embedder(world, 0, "cuda"), corpus,
                        VectorStore(d))
    svc.begin_migration(copy.deepcopy(world[4][1]), 2)
    old = svc._view
    old_rows = old.pages.clone()
    plan.migrate_unit(1)                   # the generation's 952 rows
    info = svc.refresh()
    st = info["stage"]
    rows = PAGES - 2_048
    assert (st["replaced_rows"], st["h2d_rows"]) == (rows, rows)
    assert st["h2d_bytes"] == rows * cfg.model.out_dim * 2
    assert st["d2d_bytes"] == PAGES * cfg.model.out_dim * 2
    assert torch.equal(old.pages, old_rows)
    ids, vecs = VectorStore(d).load_all()
    np.testing.assert_array_equal(svc.page_ids, ids)
    assert torch.equal(svc.pages.cpu(),
                       torch.from_numpy(np.asarray(vecs, np.float16)))
    assert svc._view.runs == [(0, PAGES, 2)]
    svc.close()
