"""The IVF/PQ index and the int8 store on the card against the port on the
CPU. Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_index_cuda.py

Tolerances: products and sums within 1e-5 (float32 sums in other orders
on the card), assignments equal (no near-tie in these seeded rows); ADC
scores bitwise equal (each row's table entries are added in the same
order on both); the device quantize byte for byte (correctly rounded
float32 steps); two seeded builds on the card byte for byte (no float
atomics in k-means)."""
import json
import os

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu_torch.index import kmeans, pq
from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex, index_dir
from dnn_page_vectors_tpu_torch.infer.bulk_embed import (
    quantize_rows as device_quantize)
from dnn_page_vectors_tpu_torch.infer.vector_store import (
    VectorStore, quantize_rows)
from dnn_page_vectors_tpu_torch.ops.topk import (
    rerank_candidates, rerank_positions)

DIM = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _store(path, dtype, n=6000, shard=2500, seed=3):
    rng = np.random.default_rng(seed)
    vecs = _unit(rng.normal(size=(40, DIM))[rng.integers(0, 40, n)]
                 + 0.3 * rng.normal(size=(n, DIM)))
    store = VectorStore(path, dim=DIM, shard_size=shard, dtype=dtype)
    store.ensure_model_step(1)
    for i in range(0, n, shard):
        store.write_shard(i // shard, np.arange(i, min(i + shard, n)),
                          vecs[i: i + shard])
    return store, vecs


def _same_topk(got, want):
    """Scores within 1e-5, positions equal except where two scores tie
    within 1e-6."""
    gs, gi = (t.cpu().numpy() for t in got)
    ws, wi = (t.numpy() for t in want)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    differ = gi != wi
    assert (np.abs(gs[differ] - ws[differ]) <= 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("choices", [1, 4])
def test_shard_pass_on_the_card_matches_the_cpu(cuda_device, tmp_path,
                                                choices):
    store, _ = _store(str(tmp_path / "s"), "int8")
    _, rows, scl = next(store.iter_shards(raw=True))
    rows, scl = torch.from_numpy(np.array(rows)), torch.from_numpy(scl)
    cents = torch.from_numpy(_unit(np.random.default_rng(0).normal(
        size=(50, DIM))))
    want = kmeans.shard_pass(rows, scl, cents, chunk=1024, choices=choices)
    got = kmeans.shard_pass(rows.to(cuda_device), scl.to(cuda_device),
                            cents.to(cuda_device), chunk=1024,
                            choices=choices)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-5)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])


@pytest.mark.cuda
def test_adc_and_reranks_on_the_card_match_the_cpu(cuda_device):
    rng = np.random.default_rng(1)
    B, C, m, ksub, nprobe = 32, 20_000, 16, 256, 8
    q = torch.from_numpy(_unit(rng.normal(size=(B, DIM))))
    rot = torch.from_numpy(np.linalg.qr(rng.normal(size=(DIM, DIM)))[0]
                           .astype(np.float32))
    cb = torch.from_numpy(rng.normal(size=(m, ksub, DIM // m))
                          .astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, ksub, (C, m)).astype(np.uint8))
    cent = torch.from_numpy(rng.integers(-2, 64, C).astype(np.int32))
    sel = torch.from_numpy(np.stack([rng.choice(64, nprobe, replace=False)
                                     for _ in range(B)]))
    lut = pq._pq_lut(q, rot, cb)

    def d(*ts):
        return [t.to(cuda_device) for t in ts]

    torch.testing.assert_close(pq._pq_lut(*d(q, rot, cb)).cpu(), lut,
                               rtol=0, atol=1e-5)
    # the same tables on both sides: the ADC sums are added in one order
    want = pq.adc_topr(lut, codes, cent, sel, r=80, chunk=4096)
    got = pq.adc_topr(*d(lut, codes, cent, sel), r=80, chunk=4096)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    cand = torch.from_numpy(rng.integers(-127, 128, (C, DIM))
                            .astype(np.int8))
    scl = torch.from_numpy((rng.random(C) * 0.01 + 1e-3).astype(np.float16))
    for scales in (None, scl):
        rows = cand if scales is not None else cand.float().half() / 127
        w = rerank_candidates(q, rows, scales, cent, sel, 10)
        g = rerank_candidates(*d(q, rows), None if scales is None else
                              scales.to(cuda_device), *d(cent, sel), 10)
        _same_topk(g, w)
        pos = torch.from_numpy(np.stack([rng.choice(C, 80, replace=False)
                                         for _ in range(B)]))
        w = rerank_positions(q, rows, scales, pos, 10)
        g = rerank_positions(*d(q, rows), None if scales is None else
                             scales.to(cuda_device), pos.to(cuda_device), 10)
        _same_topk(g, w)


@pytest.mark.cuda
def test_device_quantize_on_the_card_equals_the_host(cuda_device):
    v = _unit(np.random.default_rng(2).normal(size=(4096, 256)))
    v[0] = 0.0
    v16 = v.astype(np.float16)
    codes, scales = device_quantize(torch.from_numpy(v16).to(cuda_device))
    h_codes, h_scales = quantize_rows(v16)
    np.testing.assert_array_equal(codes.cpu().numpy(), h_codes)
    np.testing.assert_array_equal(scales.cpu().numpy(), h_scales)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pq_m", [("float16", 0), ("int8", 16)])
def test_seeded_builds_on_the_card_are_byte_identical(cuda_device, tmp_path,
                                                      dtype, pq_m):
    """Two seeded builds on the card give the same files, and the card's
    search equals the CPU's over the same index files."""
    store, vecs = _store(str(tmp_path / "s"), dtype)
    files, mans = [], []
    for _ in range(2):
        idx = IVFIndex.build(store, nlist=64, iters=5, seed=0, pq_m=pq_m,
                             device=cuda_device)
        d = index_dir(store)
        files.append({n: open(os.path.join(d, n), "rb").read()
                      for n in sorted(os.listdir(d)) if n.endswith(".npy")})
        man = json.loads(json.dumps(idx.manifest))
        man.pop("build_seconds")
        man.get("pq", {}).pop("train_seconds", None)
        mans.append(man)
    assert files[0] == files[1] and mans[0] == mans[1]
    q = _unit(vecs[:100] + 0.05 * np.random.default_rng(5).normal(
        size=(100, DIM)))
    card = IVFIndex.open(store, device=cuda_device)
    cpu = IVFIndex.open(store, device="cpu")
    gs, gi, gst = card.search(q, k=10, nprobe=8)
    ws, wi, wst = cpu.search(q, k=10, nprobe=8)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    differ = gi != wi
    assert (np.abs(gs[differ] - ws[differ]) <= 1e-6).all()
    assert gst == wst
