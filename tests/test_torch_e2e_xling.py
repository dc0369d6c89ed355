"""Cross-lingual retrieval through the port's mT5 slice, end to end on the
CPU: the counterpart of tests/test_e2e_xling.py (config mt5_multilingual,
shrunk to the same geometry: a 2-layer t5 tower, d=96, 600 pages in 3
languages, 200 steps).

The multilingual toy corpus writes page i in language i % L and its gold
query in language (i + 1) % L, so a query shares no word with its gold
page: Recall@10 well above chance (10/600) needs the towers to have
learned the cross-language correspondences. Here the towers use flash
attention, whose plain versions on CPU tensors are the oracles of K1, K4
and K3: the training goes through the biased backward the card runs.
"""
import numpy as np

from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.train.loop import Trainer


def test_mt5_cross_lingual_end_to_end(tmp_path):
    cfg = get_config("mt5_multilingual", {
        "data.num_pages": 600,
        "data.languages": 3,
        "data.vocab_size": 1024,
        "data.page_len": 48,
        "data.query_len": 12,
        "model.num_layers": 2,
        "model.num_heads": 4,
        "model.model_dim": 96,
        "model.mlp_dim": 192,
        "model.out_dim": 64,
        "model.dropout": 0.0,
        "model.attention": "flash",
        "train.batch_size": 64,
        "train.steps": 200,
        "train.warmup_steps": 20,
        "train.learning_rate": 2e-3,
        "train.log_every": 100,
        "eval.embed_batch_size": 128,
        "eval.store_shard_size": 256,
    })
    trainer = Trainer(cfg, workdir=str(tmp_path), device="cpu")
    corpus = trainer.corpus
    assert corpus.languages == 3
    assert all(corpus.query_language(i) != corpus.page_language(i)
               for i in range(12))

    metrics = trainer.train()
    assert np.isfinite(metrics["loss"])
    assert metrics["in_batch_acc"] > 0.5, metrics

    store = VectorStore(str(tmp_path / "store"), dim=cfg.model.out_dim,
                        shard_size=256)
    embedder = BulkEmbedder(cfg, trainer.model, trainer.page_tok,
                            query_tok=trainer.query_tok, device="cpu")
    embedder.embed_corpus(corpus, store, batch_size=128)
    assert store.num_vectors == 600

    recall, nq = evaluate_recall(embedder, corpus, store, num_queries=200,
                                 k=10)
    assert nq == 200
    # random recall@10 over 600 pages is about 1.7%
    assert recall > 0.5, f"cross-lingual recall@10={recall} over {nq} queries"
