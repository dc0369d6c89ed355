"""The serving fleet over the wire on the card against the port on the CPU.
Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_fleet_cuda.py

A front end at P=2 x R=1 over a seeded 6-shard store, with a
``WorkerGateway`` and 2 partition workers as threads, each its view staged
on the card: the answers over the wire equal the same front end's
in-process ones on the card byte for byte, and the CPU's (ids equal except
where two scores tie within 1e-6, scores within 1e-5: float32 sums in
another order on the card); no fallback, and every worker's view on the
card. A worker asked for no device stages on the card."""
import threading

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.infer.partition_host import (
    DeviceEmbedder, PartitionWorker, WorkerGateway)
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore

pytestmark = pytest.mark.cuda

DIM = 64
SHARD = 2000
NSHARDS = 6
ROWS = SHARD * NSHARDS
WAIT = 60.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the views stage on the card")
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


def _service(d, device, **serve):
    cfg = get_config("cdssm_toy", {
        "model.out_dim": DIM, **{f"serve.{k}": v for k, v in serve.items()}})
    return SearchService(cfg, DeviceEmbedder(device), None, VectorStore(d))


def test_fleet_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    d = _store(str(tmp_path / "store"))
    qv = _vecs(16, 7)
    cpu = _service(d, "cpu", partitions=2)
    want_s, want_i = cpu.topk_vectors(qv, k=10)
    cpu.close()
    svc = _service(d, None, partitions=2)
    inproc = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=0.25)
    svc.attach_gateway(gw)
    workers = []
    try:
        for p in range(2):
            w = PartitionWorker(svc.cfg, d, ("127.0.0.1", gw.port), p, 2)
            threading.Thread(target=w.run, daemon=True).start()
            workers.append(w)
        assert gw.wait_for_workers(2, timeout_s=WAIT)
        for w in workers:
            assert w.svc.embedder.device.type == "cuda"
            assert w.view.pages is not None
            assert w.view.pages.device.type == "cuda"
        s, i = svc.topk_vectors(qv, k=10)
        assert np.array_equal(s, inproc[0]) and np.array_equal(i, inproc[1])
        assert gw.stats()["rpcs"] == 2 and gw.stats()["rpc_fallbacks"] == 0
        np.testing.assert_allclose(s, want_s, rtol=0, atol=1e-5)
        differ = i != want_i
        assert (np.abs(s[differ] - want_s[differ]) <= 1e-6).all()
    finally:
        for w in workers:
            w.stop()
        gw.close()
        svc.close()
