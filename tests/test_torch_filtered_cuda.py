"""Filtered retrieval and the hot posting set on the card against the port
on the CPU. Every test here needs a CUDA device and skips without one.
This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_filtered_cuda.py

Tolerances: the predicate's mask on the card bit for bit the host's (int32
bit tests); ADC scores bitwise equal (each row's table entries are added
in the same order on both), so the staged and gathered survivors are the
same rows; re-rank and filtered exact scores within 1e-5 (float32 sums in
other orders on the card), ids equal except where two scores tie within
1e-6; stats equal."""
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.index import attrs as A
from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore

pytestmark = pytest.mark.cuda

DIM = 64
ROWS = 6000
SHARD = 2000
PREDICATES = ("lang==1", "site in {0}", "recency>=3",
              "lang==0&site in {2,4}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _words(n=ROWS):
    ids = np.arange(n)
    return A.pack_words(lang=(ids % 2).astype(np.uint32),
                        site=(ids % 10).astype(np.uint32),
                        recency=np.where(ids % 100 == 0, 3,
                                         0).astype(np.uint32))


def _store(path, dtype="int8"):
    rng = np.random.default_rng(3)
    v = (rng.normal(size=(40, DIM))[rng.integers(0, 40, ROWS)]
         + 0.3 * rng.normal(size=(ROWS, DIM)))
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    store = VectorStore(path, dim=DIM, shard_size=SHARD, dtype=dtype)
    store.ensure_model_step(1)
    store.init_attrs()
    words = _words()
    for i in range(0, ROWS, SHARD):
        store.write_shard(i // SHARD, np.arange(i, i + SHARD),
                          v[i: i + SHARD], attrs=words[i: i + SHARD])
    return VectorStore(path)


def _qv(n, seed=5):
    q = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _same_topk(got_s, got_i, want_s, want_i):
    filled = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), filled)
    np.testing.assert_allclose(got_s[filled], want_s[filled], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_i[~filled], want_i[~filled])
    differ = (got_i != want_i) & filled
    assert (np.abs(got_s[differ] - want_s[differ]) <= 1e-6).all()


def test_matches_device_on_the_card_equals_the_host(cuda_device):
    rng = np.random.default_rng(1)
    n = 100_000
    words = A.pack_words(lang=rng.integers(0, 256, n).astype(np.uint32),
                         site=rng.integers(0, 65536, n).astype(np.uint32),
                         recency=rng.integers(0, 16, n).astype(np.uint32))
    t = A.words_tensor(words, cuda_device)
    assert t.device.type == "cuda" and t.dtype == torch.int32
    for text in PREDICATES + ("lang==255&recency>=15", "site in {65535}"):
        p = A.Predicate.parse(text)
        np.testing.assert_array_equal(p.matches_device(t).cpu().numpy(),
                                      p.matches(words))


def test_hot_set_and_filtered_ivf_on_the_card_equal_the_cpu(cuda_device,
                                                            tmp_path):
    store = _store(str(tmp_path / "s"))
    IVFIndex.build(store, nlist=32, iters=4, seed=0, pq_m=8, device="cpu")
    budget = 0.5 * ROWS * (8 + 4)
    qv = _qv(24)
    for staged in (False, True):
        card = IVFIndex.open(VectorStore(store.directory),
                             device=cuda_device)
        cpu = IVFIndex.open(VectorStore(store.directory), device="cpu")
        if staged:
            assert card.stage_hot(budget) == cpu.stage_hot(budget)
            assert card._hot["codes"].device.type == "cuda"
            assert card._hot["attrs"].device.type == "cuda"
        for text in (None,) + PREDICATES:
            pred = None if text is None else A.Predicate.parse(text)
            for nprobe in (2, 8):
                s, i, st = card.search(qv, 10, nprobe=nprobe, predicate=pred)
                cs, ci, cst = cpu.search(qv, 10, nprobe=nprobe,
                                         predicate=pred)
                _same_topk(s, i, cs, ci)
                assert st == cst, (staged, text, nprobe)
                assert ("hot_rows_scored" in st) == staged
                if pred is not None:
                    assert pred.matches(_words()[i[i >= 0]]).all()


class _Tok:
    def encode_batch(self, texts):
        out = np.zeros((len(texts), 4), np.int32)
        for r, t in enumerate(texts):
            for c, w in enumerate(t.split()[:4]):
                out[r, c] = 1 + sum(w.encode()) % 997
        return out


class _StubEmbedder:
    def __init__(self, device):
        g = torch.Generator().manual_seed(0)
        self.table = torch.randn(1000, DIM, generator=g).to(device)
        self.query_tok = _Tok()
        self.device = torch.device(device)

    def encode_queries(self, ids):
        v = self.table[ids.to(self.device).long()].sum(1)
        return v / v.norm(dim=1, keepdim=True).clamp_min(1e-6)


class _Corpus:
    def page_text(self, i):
        return f"page {int(i)}"


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_filtered_exact_on_the_card_equals_the_cpu(cuda_device, tmp_path,
                                                   dtype):
    store = _store(str(tmp_path / "s"), dtype)
    cfg = get_config("cdssm_toy", {"model.out_dim": DIM})
    card = SearchService(cfg, _StubEmbedder(cuda_device), _Corpus(), store)
    cpu = SearchService(cfg, _StubEmbedder("cpu"), _Corpus(),
                        VectorStore(store.directory))
    qv = _qv(16, seed=9)
    try:
        for text in PREDICATES:
            pred = A.Predicate.parse(text)
            s, i, scan = card._topk_view(card._view, qv, 16, 10, None,
                                         predicate=pred)
            cs, ci, cscan = cpu._topk_view(cpu._view, qv, 16, 10, None,
                                           predicate=pred)
            _same_topk(s, i, cs, ci)
            assert scan == cscan
            assert pred.matches(_words()[i[i >= 0]]).all()
            queries = ["alpha beta", "gamma"]
            for a, b in zip(card.search_many(queries, k=5, filters=text),
                            cpu.search_many(queries, k=5, filters=text)):
                assert {r["page_id"] for r in a} == \
                    {r["page_id"] for r in b}
    finally:
        card.close()
        cpu.close()
