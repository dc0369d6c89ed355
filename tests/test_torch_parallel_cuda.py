"""Training across cards over NCCL, on the card: data parallelism, ring
attention and tensor parallelism at a small width with the flash kernels,
against one card. Every test needs two CUDA devices and skips with fewer
(NCCL puts no two ranks on one device). This file imports neither jax nor
the JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Each rank is a spawned process on its own card (tests/torch_dist.py,
``backend="nccl"``), with a time limit a job and a timeout a collective.
Bars: the CPU tests' (tests/test_torch_parallel.py) for float32 towers,
parameters within rtol 5e-4 / atol 5e-5 after 3 SGD steps and losses
within 1e-3; the ring's values and gradients within 2e-5 of one rank's
(float32, tests/test_torch_ring_attention.py)."""
import os

import numpy as np
import pytest
import torch

from torch_dist import ring_rank, run_ranks, train_rank

pytestmark = pytest.mark.cuda

NAMES = {"bert": "bert_mini_v5p16", "t5": "mt5_multilingual"}


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL puts no two ranks on one "
                    "card")
    return torch.cuda.device_count()


def _tiny(encoder, **extra):
    ov = {"data.num_pages": 256, "data.vocab_size": 512,
          "model.out_dim": 64, "model.dtype": "float32",
          "model.num_layers": 2, "model.model_dim": 128,
          "model.num_heads": 2, "model.mlp_dim": 256, "model.dropout": 0.0,
          "model.attention": "flash", "train.batch_size": 64,
          "train.optimizer": "sgd", "train.warmup_steps": 1,
          "train.log_every": 1}
    ov.update(extra)
    return ov


def _setup(tmp_path, encoder, ov):
    """The cached vocab the ranks load, and the full seeded weights."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import (
        build_corpus, build_tokenizer)
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    tok = str(tmp_path / "tok")
    os.makedirs(tok, exist_ok=True)
    cfg = get_config(NAMES[encoder], ov)
    build_tokenizer(cfg, build_corpus(cfg), cache_dir=tok)
    init = str(tmp_path / "init.pt")
    torch.save(build_two_tower(cfg, cfg.data.vocab_size,
                               device="cpu").state_dict(), init)
    return tok, init


def _against_one_card(tmp_path, encoder, ov, world, steps=3):
    tok, init = _setup(tmp_path, encoder, ov)
    ranks = run_ranks(train_rank, world, NAMES[encoder], ov, None, tok, init,
                      steps, None, False, "cuda", backend="nccl",
                      timeout=300.0)
    one = {**ov, "mesh.data": 1, "mesh.model": 1, "mesh.seq": 1,
           "model.attention": "flash"}
    want = run_ranks(train_rank, 1, NAMES[encoder], one, None, tok, init,
                     steps, None, False, "cuda", backend="nccl",
                     timeout=300.0)[0]
    for r in ranks:
        for k, v in want["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=5e-4,
                                       atol=5e-5, err_msg=k)
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-3)
    return ranks


def test_nccl_data_parallel_equals_one_card(two_cards, tmp_path):
    _against_one_card(tmp_path, "bert", _tiny("bert", **{"mesh.data": 2}), 2)


def test_nccl_tensor_parallel_equals_one_card(two_cards, tmp_path):
    """t5: the heads, the gated MLP and the embedding's features split in
    two; K1 and K4 take each rank's [H / 2, L, S] bias."""
    _against_one_card(tmp_path, "t5", _tiny("t5", **{"mesh.model": 2}), 2)


def test_nccl_ring_training_equals_one_card(two_cards, tmp_path):
    ov = _tiny("bert", **{"mesh.seq": 2, "model.attention": "ring"})
    _against_one_card(tmp_path, "bert", ov, 2)


def test_nccl_ring_attention_equals_one_rank(two_cards):
    rng = np.random.default_rng(0)
    B, H, L, Dh = 2, 2, 64, 32
    q, k, v, g = (rng.normal(size=(B, H, L, Dh)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((B, L), bool)
    mask[0, -7:] = False
    mask[1] = False                       # a row with every key masked
    table = rng.normal(size=(32, H)).astype(np.float32)
    for tab in (None, table):
        ranks = run_ranks(ring_rank, 2, q, k, v, mask, tab, g, "cuda",
                          backend="nccl", timeout=300.0)
        one = ring_rank(0, 1, q, k, v, mask, tab, g, "cuda")
        for key in ("out", "dq", "dk", "dv"):
            got = np.concatenate([r[key] for r in ranks], axis=2)
            np.testing.assert_allclose(got, one[key], rtol=2e-5, atol=2e-5,
                                       err_msg=key)
        if tab is not None:
            np.testing.assert_allclose(sum(r["dtable"] for r in ranks),
                                       one["dtable"], rtol=2e-5, atol=2e-5)
