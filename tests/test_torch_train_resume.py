"""The port's trainer resumed from a checkpoint (moved from
tests/test_torch_train.py whole, so that no test file runs long under a
parallel run, pytest-xdist giving each worker whole files).

Tolerance: train-6 against train-3 + restore + 3 on the port, dropout
on: bitwise."""

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


def test_train_six_equals_three_restore_three(tokenizers, tmp_path):
    _, (tc, toks) = tokenizers
    straight = _port_trainer("flash", "float32", 0.1, tc, toks)
    straight.train(6)
    first = _port_trainer("flash", "float32", 0.1, tc, toks)
    first.train(3)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    first.save(ckpt)
    resumed = _port_trainer("flash", "float32", 0.1, tc, toks)
    assert resumed.restore(ckpt) == 3
    resumed.train(3)
    assert resumed.step == straight.step == 6
    for (n, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
    assert resumed.history[-1]["loss"] == straight.history[-1]["loss"]
    # dropout was on: the same run without it ends elsewhere
    plain = _port_trainer("flash", "float32", 0.0, tc, toks)
    plain.train(6)
    assert plain.history[-1]["loss"] != straight.history[-1]["loss"]
