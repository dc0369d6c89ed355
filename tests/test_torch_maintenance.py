"""The port's store maintenance against the JAX package's, on the CPU:
generation compaction (maintenance/compact.py) and the append lease
(maintenance/lease.py).

Compaction: the same chain (written by each package's GenerationWriter
from the same vectors) compacts to byte-identical files and an identical
main manifest in both packages, fp16 and int8 (no field carries a time;
the stats differ only in ``seconds`` and the rate); ids are kept, dead
rows dropped, the cursor pinned past a tombstoned top id, and the next
append chains past the folded epoch; each package opens the other's
compacted store. Exact search over the compacted base equals the chain's,
through ``topk_over_store`` and through a service's ``refresh()``; a
failure before the swap leaves the old chain byte for byte; a base
re-embed of a compacted store is refused; ``purge_stale`` removes only
what the manifest no longer names; ``compaction_due`` is the JAX
service's trigger.

Leases: two concurrent ``append_corpus`` writers never assign an id
twice (one appends, the other finds nothing left); a held lease fails a
zero-wait writer, an expired one is taken over (``lease_stolen``), the
old holder's renew raises LeaseLost; a port writer and a JAX writer of one
store exclude each other through the same lease file."""
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.maintenance.compact import (
    compact_store as jax_compact)
from dnn_page_vectors_tpu.maintenance.lease import (
    AppendLease as JaxLease, LeaseHeld as JaxLeaseHeld)
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.loader import (
    build_corpus, build_tokenizer)
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.maintenance import (
    AppendLease, LeaseHeld, LeaseLost, compact_store, compaction_due,
    expire_stale_lease, purge_stale)
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.ops.topk import topk_over_store
from dnn_page_vectors_tpu_torch.updates import append_corpus
from dnn_page_vectors_tpu_torch.utils import telemetry

DIM = 16
OV = {"data.num_pages": 300, "data.trigram_buckets": 512,
      "model.embed_dim": 16, "model.conv_channels": 32, "model.out_dim": 24,
      "eval.embed_batch_size": 100, "eval.store_shard_size": 100}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registry():
    telemetry.reset_default()
    yield


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _rows(rng, n):
    v = rng.standard_normal((n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _chain(cls, d, dtype):
    """60 base rows in shards of 16, then two generations: 20 new ids with
    7 and 12 re-embedded (tombstoned), then 10 new ids with the top id 79
    and 40 tombstoned."""
    rng = np.random.default_rng(5)
    store = cls(d, dim=DIM, shard_size=16, dtype=dtype)
    store.ensure_model_step(2)
    for s in range(4):
        ids = np.arange(s * 16, min(s * 16 + 16, 60), dtype=np.int64)
        store.write_shard(s, ids, _rows(rng, ids.size))
    w = store.begin_generation(tombstones=[7, 12])
    for ids in (np.arange(60, 76), np.array([76, 77, 78, 79, 7, 12])):
        w.write_shard(np.asarray(ids, np.int64), _rows(rng, len(ids)))
    w.commit()
    w = store.begin_generation(tombstones=[79, 40])
    ids = np.arange(80, 90, dtype=np.int64)
    w.write_shard(ids, _rows(rng, ids.size))
    w.commit()
    return store


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_compaction_byte_identical_to_jax_and_preserves_ids(dtype, tmp_path):
    port = _chain(VectorStore, str(tmp_path / "port"), dtype)
    jax_ = _chain(JaxStore, str(tmp_path / "jax"), dtype)
    assert _files(port.directory) == _files(jax_.directory)
    q = _rows(np.random.default_rng(9), 6)
    before = topk_over_store(q, VectorStore(port.directory), k=8,
                             device="cpu")
    stats, jstats = compact_store(port), jax_compact(jax_)
    drop = ("seconds", "compact_docs_per_s", "stale_dirs", "stale_files")
    assert {k: v for k, v in stats.items() if k not in drop} == \
        {k: v for k, v in jstats.items() if k not in drop}
    assert (stats["action"], stats["epoch"], stats["rows"],
            stats["dead_rows_dropped"], stats["shards"]) == (
        "compacted", 2, 88, 4, 6)
    assert [os.path.relpath(p, port.directory) for p in stats["stale_dirs"]] \
        == [os.path.relpath(p, jax_.directory) for p in jstats["stale_dirs"]]
    assert _files(port.directory) == _files(jax_.directory)
    man = json.load(open(os.path.join(port.directory, "manifest.json")))
    assert man["compacted_through"] == 2 and man["append_cursor"] == 90
    assert all(e["vec"].startswith("compact-0002/") for e in man["shards"])
    for s in (VectorStore(port.directory), JaxStore(port.directory),
              VectorStore(jax_.directory)):
        ids, _ = s.load_all()
        assert sorted(ids.tolist()) == sorted(set(range(90)) - {40, 79})
        assert s.generation == 2 and s.compacted_through == 2
        assert s.next_page_id() == 90          # 79's id is never re-issued
        ms = s.maintenance_stats()
        assert ms["dead_rows"] == 0 and ms["compacted_through"] == 2
    after = topk_over_store(q, VectorStore(port.directory), k=8,
                            device="cpu")
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    # the chain goes on past the folded epoch
    w = VectorStore(port.directory).begin_generation(tombstones=[0])
    assert w.gen == 3
    e = w.write_shard(np.arange(90, 94), _rows(np.random.default_rng(1), 4))
    w.commit()
    # past every index ever assigned: the chain's 0-6 and the fold's 7-12
    assert e["index"] == 13
    cold = VectorStore(port.directory)
    assert cold.generation == 3 and cold.num_vectors == 92
    assert 0 not in cold.load_all()[0]       # the fold's row 0 now dead
    assert compact_store(VectorStore(jax_.directory))["action"] == "noop"


def test_failed_compaction_keeps_the_chain_and_purge(tmp_path, monkeypatch):
    store = _chain(VectorStore, str(tmp_path / "s"), "float16")
    snap = _files(store.directory)
    real = VectorStore._write_shard_files
    calls = []

    def failing(self, subdir, *a, **kw):
        calls.append(subdir)
        if len(calls) == 3:
            raise OSError("disk went away")
        return real(self, subdir, *a, **kw)

    monkeypatch.setattr(VectorStore, "_write_shard_files", failing)
    with pytest.raises(OSError, match="disk went away"):
        compact_store(VectorStore(store.directory))
    monkeypatch.setattr(VectorStore, "_write_shard_files", real)
    now = _files(store.directory)
    # the chain is untouched; only the invisible compact dir holds debris
    assert {k: v for k, v in now.items()
            if not k.startswith("compact-")} == snap
    cold = VectorStore(store.directory)
    assert cold.compacted_through == 0 and cold.generation == 2
    stats = compact_store(cold)
    assert stats["action"] == "compacted"
    purged = purge_stale(cold, stats)
    assert purged == {"purged_dirs": 2, "purged_files": 8}
    left = sorted(os.listdir(store.directory))
    assert "gen-0001" not in left and "compact-0002" in left
    assert not any(n.startswith("shard_") for n in left)
    ids, _ = VectorStore(store.directory).load_all()
    assert len(ids) == 88
    # a base re-embed of a compacted store would double-assign: refused
    cfg = get_config("cdssm_toy", OV)
    corpus = build_corpus(cfg)
    q_tok, p_tok = build_tokenizer(cfg, corpus)
    emb = BulkEmbedder(cfg, build_two_tower(cfg, vocab_size=p_tok.vocab_size,
                                            device="cpu"),
                       p_tok, query_tok=q_tok, device="cpu")
    with pytest.raises(ValueError, match="has been compacted"):
        emb.embed_corpus(corpus, VectorStore(store.directory))


def test_compaction_due_is_the_services_trigger(tmp_path):
    store = _chain(VectorStore, str(tmp_path / "s"), "float16")
    density = store.maintenance_stats()["tombstone_density"]
    assert density == round(4 / 92, 4)     # 4 dead of 92 stored rows
    low = get_config("cdssm_toy", {
        "maintenance.compact_tombstone_density": density})
    assert compaction_due(store, low)
    assert not compaction_due(store, get_config("cdssm_toy"))   # 0.2
    compact_store(store)
    assert not compaction_due(store, low)      # nothing left to fold


# -- the service across a compaction, and leases under real appends -----------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cfg = get_config("cdssm_toy", OV)
    corpus = build_corpus(cfg)
    q_tok, p_tok = build_tokenizer(cfg, corpus)
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device="cpu")
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device="cpu")
    store = VectorStore(str(tmp_path_factory.mktemp("m") / "store"),
                        dim=24, shard_size=100)
    store.ensure_model_step(4)
    emb.embed_corpus(corpus, store)
    grown = build_corpus(get_config("cdssm_toy", {**OV,
                                                  "data.num_pages": 400}))
    return dict(cfg=cfg, emb=emb, store=store, grown=grown)


def _copy(served, tmp_path):
    d = str(tmp_path / "store")
    shutil.copytree(served["store"].directory, d)
    return d


def test_compaction_under_a_service_keeps_its_results(served, tmp_path):
    d = _copy(served, tmp_path)
    append_corpus(served["emb"], served["grown"], VectorStore(d),
                  tombstone=[3, 150, 299])
    svc = SearchService(served["cfg"], served["emb"], served["grown"],
                        VectorStore(d))
    queries = [served["grown"].query_text(i) for i in range(0, 400, 23)]
    before = svc.search_many(queries, k=10)
    stats = compact_store(VectorStore(d))
    info = svc.refresh()
    assert info["store_generation"] == 1        # monotonic across the fold
    assert info["stage"]["reused_entries"] == 0  # a new table: restaged
    assert svc.search_many(queries, k=10) == before
    met = svc.metrics()
    assert met["dead_rows"] == 0 and met["tombstone_density"] == 0.0
    purge_stale(VectorStore(d), stats)
    fresh = SearchService(served["cfg"], served["emb"], served["grown"],
                          VectorStore(d))
    assert fresh.search_many(queries, k=10) == before
    svc.close()


def test_two_writer_lease_contention_never_double_assigns(served, tmp_path):
    d = _copy(served, tmp_path)
    results, errors = [], []
    gate = threading.Barrier(2)

    def writer():
        try:
            gate.wait()
            results.append(append_corpus(served["emb"], served["grown"],
                                         VectorStore(d)))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert sorted(r["appended"] for r in results) == [0, 100]
    store = VectorStore(d)
    assert store.generation == 1 and store.num_vectors == 400
    ids, _ = store.load_all()
    live = [int(i) for i in ids if i >= 0]
    assert len(live) == len(set(live)) == 400
    assert len(telemetry.default_registry().events("lease_acquired")) >= 2
    assert not os.path.exists(os.path.join(d, "append.lease.json"))


def test_lease_fail_fast_steal_and_lost_renew(served, tmp_path):
    store = VectorStore(_copy(served, tmp_path))
    a = AppendLease(store, owner="writer-a", ttl_s=0.4, wait_s=0.0).acquire()
    assert a.held and a.stole_from is None
    with pytest.raises(LeaseHeld, match="held by writer-a"):
        AppendLease(store, owner="writer-b", ttl_s=0.4, wait_s=0.0).acquire()
    time.sleep(0.5)
    b = AppendLease(store, owner="writer-b", ttl_s=5.0, wait_s=0.0).acquire()
    assert b.held and b.stole_from == "writer-a"
    assert len(telemetry.default_registry().events("lease_stolen")) == 1
    with pytest.raises(LeaseLost):
        a.renew()
    b.renew()
    b.release()
    path = os.path.join(store.directory, "append.lease.json")
    assert not os.path.exists(path)
    c = AppendLease(store, owner="writer-c", ttl_s=1.0, wait_s=2.0)
    assert c.acquire().held
    c.release()
    # the janitor removes an expired lease, never a live one
    d = AppendLease(store, owner="writer-d", ttl_s=1.0, wait_s=0.0).acquire()
    assert not expire_stale_lease(store) and os.path.exists(path)
    time.sleep(1.1)
    assert expire_stale_lease(store) and not os.path.exists(path)
    with pytest.raises(LeaseLost):
        d.renew()


def test_port_and_jax_writers_share_one_lease(served, tmp_path):
    d = _copy(served, tmp_path)
    j = JaxLease(JaxStore(d), owner="jax-writer", ttl_s=5.0,
                 wait_s=0.0).acquire()
    with pytest.raises(LeaseHeld, match="held by jax-writer"):
        AppendLease(VectorStore(d), owner="port-writer", wait_s=0.0).acquire()
    j.release()
    p = AppendLease(VectorStore(d), owner="port-writer", ttl_s=5.0,
                    wait_s=0.0).acquire()
    with pytest.raises(JaxLeaseHeld, match="held by port-writer"):
        JaxLease(JaxStore(d), owner="jax-writer", wait_s=0.0).acquire()
    rec = json.load(open(os.path.join(d, "append.lease.json")))
    assert sorted(rec) == ["acquired", "cursor", "expires", "owner", "token"]
    assert rec["cursor"] == 300
    p.release()
