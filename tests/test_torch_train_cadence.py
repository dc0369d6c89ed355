"""The port's trainer: log and checkpoint cadence, and the dropout masks
of a step after an embed (moved from tests/test_torch_train.py whole, so
that no test file runs long under a parallel run, pytest-xdist giving
each worker whole files).

Tolerance: a step after an embed against one without, dropout on:
bitwise."""
import os

import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.loader import build_tokenizer as jax_tokenizer
from dnn_page_vectors_tpu.data.toy import ToyCorpus as JaxCorpus
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.loader import build_tokenizer
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.train.checkpoint import CheckpointManager
from dnn_page_vectors_tpu_torch.train.loop import Trainer
from dnn_page_vectors_tpu_torch.utils import faults

SMALL = {"data.num_pages": 256, "data.vocab_size": 512, "data.page_len": 32,
         "data.query_len": 8, "model.num_layers": 1,
         "train.batch_size": 32, "train.log_every": 1000,
         "train.warmup_steps": 1, "train.learning_rate": 1e-3}
CORPUS = dict(num_pages=256, seed=0, page_len=6, query_len=4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests: pytest-xdist workers
    share the host's cores, and more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def tokenizers():
    jcfg = jax_get_config("bert_mini_v5p16", SMALL)
    tcfg = get_config("bert_mini_v5p16", SMALL)
    jc, tc = JaxCorpus(**CORPUS), ToyCorpus(**CORPUS)
    return (jc, jax_tokenizer(jcfg, jc)), (tc, build_tokenizer(tcfg, tc))


def _port_trainer(attention, dtype, dropout_rate=0.0, corpus=None,
                  toks=None):
    cfg = get_config("bert_mini_v5p16", {
        **SMALL, "model.attention": attention, "model.dtype": dtype,
        "model.dropout": dropout_rate})
    return Trainer(cfg, corpus=corpus or ToyCorpus(**CORPUS),
                   tokenizers=toks, device="cpu")


def test_train_logs_and_checkpoints_on_cadence(tokenizers, tmp_path):
    _, (tc, toks) = tokenizers
    cfg = get_config("bert_mini_v5p16", {**SMALL, "train.log_every": 2,
                                         "train.checkpoint_every": 2})
    tr = Trainer(cfg, corpus=tc, tokenizers=toks, device="cpu",
                 workdir=str(tmp_path / "work"))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    last = tr.train(7, ckpt_manager=ckpt)
    assert [h["step"] for h in tr.history] == [2, 4, 6, 7]
    # fault_counters joins the line once this process counted a fault
    # (an earlier test's injected one, say), as in the JAX trainer
    assert set(last) == {"loss", "in_batch_acc", "scale", "grad_norm",
                         "pages_per_sec", "pages_per_sec_per_chip", "step",
                         *(["fault_counters"] if faults.counters() else [])}
    with open(tmp_path / "work" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 4
    assert ckpt.all_steps() == [4, 6]             # max_to_keep, no final save
    assert ckpt.latest_step() == 6
    assert not [f for f in os.listdir(ckpt.directory) if f.endswith(".tmp")]


def test_a_step_after_an_embed_draws_the_same_dropout_masks(tokenizers):
    """The mining pipeline embeds with the trainer's own model, which the
    embedder puts into eval mode; the next step must still train with
    dropout: its loss equals, bit for bit, that of a trainer that never
    embedded (dropout 0.1)."""
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    _, (tc, toks) = tokenizers
    embedded = _port_trainer("dense", "float32", 0.1, tc, toks)
    straight = _port_trainer("dense", "float32", 0.1, tc, toks)
    embedded.train(1)
    straight.train(1)
    emb = BulkEmbedder(embedded.cfg, embedded.model, toks[1],
                       query_tok=toks[0], device="cpu")
    emb.embed_texts([tc.page_text(i) for i in range(8)], tower="page")
    emb.embed_texts([tc.query_text(i) for i in range(8)], tower="query")
    assert not embedded.model.training
    embedded.train(2)
    straight.train(2)
    assert embedded.model.training
    assert [h["loss"] for h in embedded.history] == \
        [h["loss"] for h in straight.history]
    # dropout was on: without it the same steps end elsewhere
    plain = _port_trainer("dense", "float32", 0.0, tc, toks)
    plain.train(3)
    assert plain.history[-1]["loss"] != straight.history[-1]["loss"]
