"""The mining slice on the card against the port on the CPU: the
store-streamed top-k (ops/topk.py topk_over_store) and one training step
with mined negatives (K1, K2 and K3 on the tensor cores at bf16). Every
test here needs a CUDA device and skips without one. This file imports
neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_mine_cuda.py

Tolerances: top-k scores within 1e-5 (float32 products of float16 rows,
summed in another order by cuBLAS than by the CPU), ids equal except where
two pages tie (their scores at that rank within 1e-6); the step's loss,
its unit query, page and negative vectors, and its gradient norm within
2e-2 at bf16, the bar of the towers' bf16 comparisons
(tests/test_torch_zoo.py)."""
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.mine.ann import HardNegatives
from dnn_page_vectors_tpu_torch.models.losses import (
    cosine_contrastive_loss, l2_normalize)
from dnn_page_vectors_tpu_torch.ops import flash_attention as fa
from dnn_page_vectors_tpu_torch.ops.topk import topk_over_store
from dnn_page_vectors_tpu_torch.train.loop import Trainer

BF16_TOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_topk_over_store_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(0)
    dim = 64
    store = VectorStore(str(tmp_path / "store"), dim=dim, shard_size=4096)
    lo = 0
    for i, rows in enumerate((4096, 0, 4096, 1500)):
        v = rng.normal(size=(max(rows, 1), dim)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        ids = (np.arange(lo, lo + rows) if rows else np.full(1, -1))
        store.write_shard(i, ids, v[: max(rows, 1)])
        lo += rows
    q = rng.normal(size=(300, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got_s, got_i = topk_over_store(q, store, k=50, chunk=1024,
                                   query_batch=128, device=cuda_device)
    want_s, want_i = topk_over_store(q, store, k=50, chunk=1024,
                                     query_batch=128, device="cpu")
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    differ = got_i != want_i
    assert (np.abs(got_s - want_s)[differ] <= 1e-6).all()
    assert differ.mean() < 0.01


@pytest.mark.cuda
def test_a_step_with_negatives_on_the_card_matches_the_cpu(cuda_device):
    ov = {"data.num_pages": 256, "data.vocab_size": 512,
          "data.page_len": 64, "data.query_len": 16, "model.num_layers": 2,
          "model.model_dim": 64, "model.num_heads": 4, "model.mlp_dim": 128,
          "model.out_dim": 32, "model.attention": "flash",
          "model.dtype": "bfloat16", "model.dropout": 0.0,
          "train.batch_size": 32, "train.hard_negatives": 7,
          "train.log_every": 1000, "train.warmup_steps": 1}
    cfg = get_config("bert_mini_v5p16", ov)
    corpus = ToyCorpus(num_pages=256, seed=0, page_len=20, query_len=6)
    table = ((np.arange(256)[:, None] + np.arange(1, 8) * 17) % 256
             ).astype(np.int32)
    negs = HardNegatives(table)
    cpu = Trainer(cfg, corpus=corpus, hard_negative_lookup=negs,
                  device="cpu")
    card = Trainer(cfg, corpus=corpus, hard_negative_lookup=negs,
                   tokenizers=(cpu.query_tok, cpu.page_tok),
                   device=cuda_device)
    card.model.load_state_dict(cpu.model.state_dict())
    batch = next(cpu.batches())
    assert tuple(batch["neg_page"].shape) == (32, 7, 64)

    def forward(tr, dev):
        b = {k: v.to(dev) for k, v in batch.items()}
        tr.model.zero_grad(set_to_none=True)
        q, p, neg, scale = tr.model(b["query"], b["page"], b["neg_page"])
        loss, _ = cosine_contrastive_loss(q, p, scale, neg)
        loss.backward()
        norm = torch.sqrt(sum((t.grad.float() ** 2).sum()
                              for t in tr.model.parameters()))
        vecs = [l2_normalize(x).detach().float().cpu() for x in (q, p, neg)]
        return float(loss.detach()), float(norm), vecs

    for name in fa.COUNTERS:
        setattr(fa, name, 0)
    loss, norm, vecs = forward(card, cuda_device)
    # one launch per layer per encode: queries, pages and negatives
    assert (fa.launches_tc, fa.dq_launches_tc, fa.dkv_launches_tc) == \
        (6, 6, 6)
    want_loss, want_norm, want_vecs = forward(cpu, "cpu")
    assert abs(loss - want_loss) <= BF16_TOL * max(1.0, abs(want_loss))
    assert abs(norm - want_norm) <= BF16_TOL * want_norm
    for got, want in zip(vecs, want_vecs):
        assert (got - want).abs().max().item() <= BF16_TOL
    m = card.train_step({k: v.to(cuda_device) for k, v in batch.items()})
    assert np.isfinite(float(m["loss"])) and card.step == 1
