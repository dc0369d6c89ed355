"""The mirror of the JAX package's tests/test_pipeline.py
``test_run_pipeline_end_to_end`` at its overrides, through the port's
run_pipeline on the CPU, held to that test's own bars (moved from
tests/test_torch_pipeline.py whole, so that no test file runs long under
a parallel run, pytest-xdist giving each worker whole files)."""
import os

import pytest
import torch

from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.train.loop import Trainer
from dnn_page_vectors_tpu_torch.train.pipeline import run_pipeline


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests: pytest-xdist workers
    share the host's cores, and more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_run_pipeline_end_to_end(tmp_path):
    """The JAX test at its overrides (an easy regime, so two short rounds
    converge): the rounds alternate, the store is made anew each round and
    the table is refreshed and kept for resume."""
    cfg = get_config("cdssm_toy", {
        "data.num_pages": 600,
        "data.trigram_buckets": 4096,
        "model.embed_dim": 48,
        "model.conv_channels": 96,
        "model.out_dim": 48,
        "train.batch_size": 64,
        "train.steps": 120,
        "train.warmup_steps": 10,
        "train.learning_rate": 2e-3,
        "train.log_every": 1000,
        "train.hard_negatives": 7,
        "eval.eval_queries": 300,
        "eval.embed_batch_size": 128,
    })
    trainer = Trainer(cfg, workdir=str(tmp_path), device="cpu")
    out = run_pipeline(cfg, rounds=2, trainer=trainer)
    recalls = out["recalls"]
    assert len(recalls) == 2
    assert recalls[1] >= recalls[0], recalls
    assert recalls[1] > 0.5, recalls     # random ~ 1.7%
    # the mined table was refreshed and kept for resume
    assert out["negatives"] is not None
    assert os.path.exists(os.path.join(trainer.workdir, "hard_negatives.npy"))
    # the store holds the last round's vectors (made anew, not stale)
    store = VectorStore(os.path.join(trainer.workdir, "store"),
                        dim=cfg.model.out_dim)
    assert store.num_vectors == 600
    assert store.manifest["model_step"] == 120
