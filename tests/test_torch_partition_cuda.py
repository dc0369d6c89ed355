"""Partitioned and replicated serving on the card against the port on the
CPU. Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_partition_cuda.py

P=2, R=2 over a seeded 6-shard store: every replica's view staged on the
card with a CUDA stream of its own, the scatter's results equal to the
same service's on the CPU (ids equal except where two scores tie within
1e-6, scores within 1e-5: float32 sums in another order on the card), the
same through an IVF-PQ index at full probe and under a refresh that
appends and tombstones while threads query (every result the old table's
or the new one's)."""
import shutil
import threading

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore

pytestmark = pytest.mark.cuda

DIM = 64
SHARD = 2000
NSHARDS = 6
ROWS = SHARD * NSHARDS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _vecs(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _store(path):
    store = VectorStore(path, dim=DIM, shard_size=SHARD)
    store.ensure_model_step(0)
    v = _vecs(ROWS, 3)
    for si in range(NSHARDS):
        lo = si * SHARD
        store.write_shard(si, np.arange(lo, lo + SHARD), v[lo: lo + SHARD])
    return path


class _Tok:
    def encode_batch(self, texts):
        out = np.zeros((len(texts), 4), np.int32)
        for r, t in enumerate(texts):
            for c, w in enumerate(t.split()[:4]):
                out[r, c] = 1 + sum(w.encode()) % 997
        return out


class _Embedder:
    """The query tower's stand-in on `device`: a fixed random table."""

    def __init__(self, device):
        g = torch.Generator().manual_seed(0)
        self.device = torch.device(device)
        self.table = torch.randn(1000, DIM, generator=g).to(self.device)
        self.table[0] = 0
        self.query_tok = _Tok()

    def encode_queries(self, ids):
        v = self.table[ids.long()].sum(1)
        return v / v.norm(dim=1, keepdim=True).clamp_min(1e-6)


class _Corpus:
    def page_text(self, i):
        return f"page {int(i)}"


def _service(d, device, **serve):
    cfg = get_config("cdssm_toy", {
        "model.out_dim": DIM, **{f"serve.{k}": v for k, v in serve.items()}})
    return SearchService(cfg, _Embedder(device), _Corpus(), VectorStore(d))


def _same_topk(got_s, got_i, want_s, want_i):
    filled = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), filled)
    np.testing.assert_allclose(got_s[filled], want_s[filled], rtol=0,
                               atol=1e-5)
    differ = (got_i != want_i) & filled
    assert (np.abs(got_s[differ] - want_s[differ]) <= 1e-6).all()


def test_partitioned_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    d = _store(str(tmp_path / "store"))
    qv = _vecs(16, 7)
    card = _service(d, cuda_device, partitions=2, replicas=2)
    cpu = _service(d, "cpu", partitions=2, replicas=2)
    one = _service(d, cuda_device)
    try:
        for reps in card.partition_set._parts:
            for rep in reps:
                assert rep.stream is not None
                assert rep.view.pages.device.type == "cuda"
        s, i = card.topk_vectors(qv, k=10)
        cs, ci = cpu.topk_vectors(qv, k=10)
        _same_topk(s, i, cs, ci)
        _same_topk(s, i, *one.topk_vectors(qv, k=10))
        # a device query matrix, as the encode hands it over
        s2, i2 = card.topk_vectors(torch.from_numpy(qv).to(cuda_device),
                                   k=10)
        np.testing.assert_array_equal(i2, i)
        texts = [f"query {j} words" for j in range(12)]
        got = card.search_many(texts, k=10)
        want = cpu.search_many(texts, k=10)
        for g, w in zip(got, want):
            _same_topk(np.array([[r["score"] for r in g]]),
                       np.array([[r["page_id"] for r in g]]),
                       np.array([[r["score"] for r in w]]),
                       np.array([[r["page_id"] for r in w]]))
        sim = card.partition_set.simulate(qv, 16, 10)
        _same_topk(sim["scores"], sim["ids"], cs, ci)
        assert sum(sim["scan_bytes"]) == ROWS * DIM * 2
    finally:
        for x in (card, cpu, one):
            x.close()


def test_partitioned_ivf_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    d = _store(str(tmp_path / "store"))
    IVFIndex.build(VectorStore(d), nlist=16, iters=4, seed=0, pq_m=8,
                   device="cpu")
    qv = _vecs(8, 9)
    knobs = {"partitions": 2, "replicas": 2, "index": "ivf", "nprobe": 4,
             "hot_postings_gb": 0.5 * ROWS * 12 / 2 ** 30}
    card = _service(d, cuda_device, **knobs)
    cpu = _service(d, "cpu", **knobs)
    try:
        for reps, creps in zip(card.partition_set._parts,
                               cpu.partition_set._parts):
            np.testing.assert_array_equal(
                reps[0].view.index._hot["lists"],
                creps[0].view.index._hot["lists"])
        for nprobe in (4, 16):
            s, i = card.topk_vectors(qv, k=10, nprobe=nprobe)
            cs, ci = cpu.topk_vectors(qv, k=10, nprobe=nprobe)
            _same_topk(s, i, cs, ci)
        assert card.ann_fallbacks == 0
    finally:
        card.close()
        cpu.close()


def test_refresh_on_the_card_never_mixes_generations(cuda_device, tmp_path):
    d = _store(str(tmp_path / "store"))
    card = _service(d, cuda_device, partitions=2, replicas=2)
    qv = _vecs(4, 11)
    old_s, old_i = card.topk_vectors(qv, k=10)
    victims = sorted(set(old_i[:, 0].tolist()))
    stop, seen, errors = threading.Event(), [], []

    def hammer():
        while not stop.is_set():
            try:
                seen.append(card.topk_vectors(qv, k=10)[1])
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        w = VectorStore(d).begin_generation(tombstones=victims)
        w.write_shard(np.arange(ROWS, ROWS + 4), qv)
        w.commit()
        info = card.refresh()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    new_s, new_i = card.topk_vectors(qv, k=10)
    np.testing.assert_array_equal(new_i[:, 0], np.arange(ROWS, ROWS + 4))
    for ids in seen:
        assert np.array_equal(ids, old_i) or np.array_equal(ids, new_i)
    assert len(info["partitions"]) == 2
    cpu = _service(d, "cpu", partitions=2, replicas=2)
    _same_topk(new_s, new_i, *cpu.topk_vectors(qv, k=10))
    cpu.close()
    card.close()
    shutil.rmtree(d)
