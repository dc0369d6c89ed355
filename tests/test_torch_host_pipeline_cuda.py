"""The host data path on the card: ``prefetch_to_device``'s pinned,
non-blocking batches equal the host's arrays, and a BERT-mini bulk embed
(K1 on the tensor cores) with 4 tokenizer workers writes the store files
of one worker, byte for byte, over a jsonl corpus. Every test here needs
a CUDA device and skips without one. This file imports neither jax nor
the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_host_pipeline_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
from dnn_page_vectors_tpu_torch.data.loader import (
    TrainBatcher, prefetch_to_device)
from dnn_page_vectors_tpu_torch.data.subword import SubwordTokenizer
from dnn_page_vectors_tpu_torch.data.synth import write_synth_jsonl
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def world(tmp_path):
    path = write_synth_jsonl(str(tmp_path / "c.jsonl"), 3_000, seed=4,
                             page_len=32, query_len=8, block=1_024)
    corpus = JsonlCorpus(path)
    vocab = SubwordTokenizer.train(corpus.all_texts(limit=1_000),
                                   vocab_size=2_000).vocab
    return path, corpus, vocab


@pytest.mark.cuda
def test_prefetched_batches_equal_the_hosts(cuda_device, world):
    _, corpus, vocab = world
    q, p = (SubwordTokenizer(vocab, max_tokens=n) for n in (16, 64))
    batcher = TrainBatcher(corpus, q, p, batch_size=512, seed=2, workers=4,
                           hard_negative_lookup=lambda ids: (
                               ids[:, None] + np.arange(1, 4)) % 3_000)
    want = [b for _, b in zip(range(8), iter(batcher))]
    got = []
    for dev in prefetch_to_device(iter(want), cuda_device, depth=3):
        assert all(t.device.type == "cuda" for t in dev.values())
        # overwrite the device copies at once: a later batch's copy must
        # not land on an earlier one's memory
        got.append({k: v.clone() for k, v in dev.items()})
        for v in dev.values():
            v.zero_()
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k].cpu().numpy(), b[k],
                                          err_msg=k)


@pytest.mark.cuda
def test_bert_embed_with_workers_equals_one_worker(cuda_device, world,
                                                   tmp_path):
    path, corpus, vocab = world
    cfg = get_config("bert_mini_v5p16", {
        "data.corpus": f"jsonl:{path}", "data.vocab_size": 2_000,
        "model.attention": "flash", "eval.embed_batch_size": 256,
        "eval.store_shard_size": 1_024})
    q = SubwordTokenizer(vocab, max_tokens=cfg.data.query_len)
    p = SubwordTokenizer(vocab, max_tokens=cfg.data.page_len)
    model = build_two_tower(cfg, vocab_size=p.vocab_size, device=cuda_device)
    emb = BulkEmbedder(cfg, model, p, query_tok=q, device=cuda_device)
    files = {}
    for workers in (1, 4):
        d = str(tmp_path / f"w{workers}")
        store = VectorStore(d, dim=cfg.model.out_dim, shard_size=1_024)
        fa.launches = fa.launches_tc = 0
        emb.embed_corpus(corpus, store, workers=workers)
        assert store.num_vectors == 3_000 and len(store.shards()) == 3
        assert fa.launches == fa.launches_tc == 12 * cfg.model.num_layers
        files[workers] = {n: open(os.path.join(d, n), "rb").read()
                          for n in sorted(os.listdir(d))
                          if n.endswith(".npy")}
    assert files[1].keys() == files[4].keys() and len(files[1]) == 6
    assert files[1] == files[4]
