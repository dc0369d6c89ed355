"""The JAX package's integration oracle (tests/test_e2e_cdssm_toy.py),
ported: config cdssm_toy at its overrides (600 pages, 80 steps), trained
end to end through the port's Trainer on the CPU, bulk embedded into the
port's VectorStore, and evaluated with evaluate_recall, until Recall@10
beats random (about 1.7% over 600 pages) by a wide margin."""
import numpy as np

from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.evals.recall import evaluate_recall
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.train.loop import Trainer

# tests/test_e2e_cdssm_toy.py's overrides
E2E = {
    "data.num_pages": 600,
    "data.trigram_buckets": 4096,
    "model.embed_dim": 64,
    "model.conv_channels": 128,
    "model.out_dim": 64,
    "train.batch_size": 64,
    "train.steps": 80,
    "train.warmup_steps": 10,
    "train.learning_rate": 2e-3,
    "train.log_every": 40,
    "eval.eval_queries": 200,
    "eval.embed_batch_size": 128,
}


def test_cdssm_toy_end_to_end(tmp_path):
    cfg = get_config("cdssm_toy", E2E)
    trainer = Trainer(cfg, workdir=str(tmp_path), device="cpu")
    metrics = trainer.train()
    assert np.isfinite(metrics["loss"])
    assert metrics["in_batch_acc"] > 0.5, metrics

    store = VectorStore(str(tmp_path / "store"), dim=cfg.model.out_dim,
                        shard_size=256)
    embedder = BulkEmbedder(cfg, trainer.model, trainer.page_tok,
                            query_tok=trainer.query_tok, device="cpu")
    embedder.embed_corpus(trainer.corpus, store, batch_size=128)
    assert store.num_vectors == 600

    recall, nq = evaluate_recall(embedder, trainer.corpus, store,
                                 num_queries=200, k=10)
    assert nq == 200
    assert recall > 0.5, f"recall@10={recall} over {nq} queries"
