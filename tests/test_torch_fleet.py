"""Several front ends over one worker fleet, elastic membership, filtered
scatters, the fleet result cache and the tier's trial records of the port
(infer/partition_host.py, infer/serve.py, infer/server.py,
loadgen/driver.py), against the JAX package where it has the case (its
tests/test_fleet.py, tests/test_filtered.py, tests/test_result_cache.py),
on the CPU, on the tests/test_net.py store of 6 shards of 50 unit vectors
of dim 32. Workers run as threads with services of their own:

* two front ends with a gateway each share one P=2 x R=2 worker set and
  answer byte for byte as the in-process oracle; every worker holds one
  session a gateway;
* elastic: a worker joining at the tail widens the split, its drain
  narrows it back, under a hammer with no mixed split in any answer;
* ``wait_for_workers`` past its timeout reports what it waited for;
* a worker that did not negotiate FLAG_FILTERS gets no filtered request:
  the gateway serves those slices locally, byte for byte the oracle's;
  with every worker filtering, filtered answers cross the wire;
* the fleet result cache stays staleness-zero over the socket fleet; a
  sibling's cache serves a local miss (a peer hit), a local fill reaches
  the sibling, a stale push is dropped; the cache frames' negotiation;
* a tier trial record carries the JAX keys of its ``front_ends`` block
  and the balancer's tallies;
* a stress of more calling threads than cores, with a short switch
  interval, loses no count and leaves no request pending.

Every wait has its own timeout."""
import threading
import time

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.utils import faults as jax_faults
from dnn_page_vectors_tpu.utils import telemetry as jax_telemetry
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.index import attrs as A
from dnn_page_vectors_tpu_torch.infer.partition_host import (
    DeviceEmbedder, PartitionWorker, WorkerGateway)
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.server import serve_in_background
from dnn_page_vectors_tpu_torch.infer.transport import SocketSearchClient
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.loadgen import (
    BalancedClient, make_workload, run_trial)
from dnn_page_vectors_tpu_torch.utils import faults, telemetry

DIM = 32
SHARD = 50
NSHARDS = 6
ROWS = SHARD * NSHARDS
HB = 0.25
WAIT = 30.0
ARMS = ("lang==1", "site in {0}", "recency>=3")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests: pytest-xdist workers
    share the host's cores, and more threads per worker only contend (the
    workers run threads of their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    for mod in (telemetry, jax_telemetry):
        mod.reset_default()
    for mod in (faults, jax_faults):
        mod.reset()
    yield


def _vecs(seed=0, n=ROWS):
    v = np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _qv(n=3, seed=1):
    return _vecs(seed, n)


def _words(n=ROWS):
    ids = np.arange(n)
    return A.pack_words(lang=(ids % 2).astype(np.uint32),
                        site=(ids % 10).astype(np.uint32),
                        recency=np.where(ids % SHARD == 0, 3,
                                         0).astype(np.uint32))


def _write(d, attrs=False):
    store = VectorStore(d, dim=DIM, shard_size=SHARD)
    store.ensure_model_step(0)
    if attrs:
        store.init_attrs()
    vecs, words = _vecs(), _words()
    for si in range(NSHARDS):
        lo, hi = si * SHARD, (si + 1) * SHARD
        store.write_shard(si, np.arange(lo, hi, dtype=np.int64),
                          vecs[lo:hi], attrs=words[lo:hi] if attrs else None)
    return d


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("fleet") / "store"))


@pytest.fixture(scope="module")
def attr_dir(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("fleet_attrs") / "store"),
                  attrs=True)


class _Tok:
    def encode_batch(self, texts):
        out = np.zeros((len(texts), 4), np.int32)
        for r, t in enumerate(texts):
            for c, w in enumerate(t.split()[:4]):
                out[r, c] = 1 + sum(w.encode()) % 997
        return out


class _TextEmbedder:
    """The query tower's stand-in: token ids -> unit vectors through a
    fixed random table."""

    def __init__(self):
        g = torch.Generator().manual_seed(0)
        self.table = torch.randn(1000, DIM, generator=g)
        self.table[0] = 0
        self.query_tok = _Tok()
        self.device = torch.device("cpu")

    def encode_queries(self, ids):
        v = self.table[ids.long()].sum(1)
        return v / v.norm(dim=1, keepdim=True).clamp_min(1e-6)


class _Corpus:
    def page_text(self, i):
        return f"page {int(i)}"


def _cfg(**serve):
    return get_config("cdssm_toy", {
        "model.out_dim": DIM, **{f"serve.{k}": v for k, v in serve.items()}})


def _service(d, text=False, **serve):
    if text:
        return SearchService(_cfg(**serve), _TextEmbedder(), _Corpus(),
                             VectorStore(d))
    return SearchService(_cfg(**serve), DeviceEmbedder("cpu"), None,
                         VectorStore(d))


def _fleet(cfg, d, ports, parts, R, P=None, **kw):
    out = []
    for p in parts:
        for r in range(R):
            w = PartitionWorker(cfg, d, [("127.0.0.1", q) for q in ports],
                                p, P or len(parts), r, device="cpu", **kw)
            threading.Thread(target=w.run, daemon=True).start()
            out.append(w)
    return out


def _close(workers=(), gateways=(), services=(), others=()):
    for w in workers:
        w.stop()
    for x in others:
        x.close()
    for gw in gateways:
        gw.close()
    for svc in services:
        svc.close()


def _same(got, want):
    return (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1]))


def _wait(pred, timeout_s=WAIT):
    t_end = time.perf_counter() + timeout_s
    while time.perf_counter() < t_end:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# -- several front ends over one fleet ------------------------------------------

def test_two_front_ends_share_one_fleet_byte_identical(store_dir):
    over = dict(partitions=2, replicas=2, heartbeat_s=HB)
    svc0, svc1 = _service(store_dir, **over), _service(store_dir, **over)
    qvs = _qv(6, seed=7)
    oracle = [svc0.topk_vectors(qvs[i:i + 1], k=10) for i in range(6)]
    gw0, gw1 = (WorkerGateway(svc0, heartbeat_s=HB),
                WorkerGateway(svc1, heartbeat_s=HB))
    svc0.attach_gateway(gw0)
    svc1.attach_gateway(gw1)
    workers = _fleet(svc0.cfg, store_dir, [gw0.port, gw1.port], (0, 1), 2)
    try:
        assert gw0.wait_for_workers(4, timeout_s=WAIT)
        assert gw1.wait_for_workers(4, timeout_s=WAIT)
        for i in range(6):
            for svc in (svc0, svc1):
                assert _same(svc.topk_vectors(qvs[i:i + 1], k=10),
                             oracle[i])
        assert all(w.sessions == 2 for w in workers)
        for gw in (gw0, gw1):
            st = gw.stats()
            assert st["rpcs"] == 12 and st["rpc_fallbacks"] == 0
            assert sorted(gw.live_workers()) == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
        # one worker, one process id, registered on both gateways
        assert gw0.worker_pids() == gw1.worker_pids()
    finally:
        _close(workers, [gw0, gw1], [svc0, svc1])


# -- elastic membership -------------------------------------------------------------

def test_join_resplit_and_drain_under_a_hammer(store_dir):
    """A worker joining at index 1 re-splits the fleet to width 2, its
    drain back to 1; every answer under the hammer equals the oracle of
    the split it was served on, and no answer mixes splits."""
    svc = _service(store_dir, partitions=1, replicas=1, elastic=True,
                   heartbeat_s=HB)
    qvs = _qv(6, seed=3)
    oracle1 = [svc.topk_vectors(qvs[i:i + 1], k=10) for i in range(6)]
    two = _service(store_dir, partitions=2)
    oracle2 = [two.topk_vectors(qvs[i:i + 1], k=10) for i in range(6)]
    two.close()
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    cfg = _cfg(heartbeat_s=HB)
    workers = _fleet(cfg, store_dir, [gw.port], (0,), 1)
    assert gw.wait_for_workers(1, timeout_s=WAIT)
    stop = threading.Event()
    errors, mixed, served = [], [], [0]

    def hammer():
        i = 0
        while not stop.is_set():
            qi = i % 6
            i += 1
            try:
                got = svc.topk_vectors(qvs[qi:qi + 1], k=10)
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))
                continue
            served[0] += 1
            if not (_same(got, oracle1[qi]) or _same(got, oracle2[qi])):
                mixed.append(qi)

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(2)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        workers += _fleet(cfg, store_dir, [gw.port], (1,), 1, P=2)

        def at_width(n):
            table = gw.partition_set.table()
            return (len(table) == n and len(gw.live_workers()) == n
                    and gw.stale_workers(table[0][0].generation,
                                         split=n) == 0)
        assert _wait(lambda: at_width(2)), "the join re-split never landed"
        time.sleep(0.3)
        threading.Thread(target=workers[1].drain, kwargs={"wait_s": 0.3},
                         daemon=True).start()
        assert _wait(lambda: len(gw.partition_set.table()) == 1), \
            "the drain re-split never landed"
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
        _close(workers, [gw], [svc])
    assert errors == [] and mixed == [] and served[0] > 0
    triggers = [e["attrs"]["trigger"]
                for e in svc.registry.events("fleet_resplit")]
    assert "join" in triggers and "drain" in triggers
    assert svc.registry.events("worker_draining")
    assert gw.stats()["resplits"] >= 2


def test_wait_for_workers_past_its_timeout_reports_the_fleet(store_dir):
    svc = _service(store_dir, partitions=1)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    try:
        t0 = time.perf_counter()
        assert gw.wait_for_workers(1, timeout_s=0.3) is False
        assert time.perf_counter() - t0 >= 0.3
        (ev,) = svc.registry.events("gateway_wait_timeout")
        attrs = ev["attrs"]
        assert attrs["barrier"] == "workers" and attrs["wanted"] == 1
        assert attrs["waited_s"] >= 0.3 and attrs["live"] == 0
        assert attrs["registered"] == 0
        assert gw.stats()["wait_timeouts"] == 1
        # with no live worker the in-process scatter serves
        assert not gw.active()
    finally:
        _close((), [gw], [svc])


# -- filtered scatters ----------------------------------------------------------------

@pytest.mark.parametrize("filtering", [True, False],
                         ids=["negotiated", "not_negotiated"])
def test_filtered_scatter_routes_only_to_filtering_workers(attr_dir,
                                                           filtering):
    """Filtered answers equal the in-process oracle byte for byte. Workers
    that negotiated FLAG_FILTERS take them over the wire; a worker that
    did not is never sent one (its slices serve from the gateway's own
    filtered view), while unfiltered requests still reach it."""
    qv = _qv(3, seed=19)
    svc = _service(attr_dir, partitions=2, replicas=1, heartbeat_s=HB)
    oracle = {t: svc.topk_vectors(qv, k=10, filters=t) for t in ARMS}
    plain = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    cfg = _cfg(partitions=2, filters=filtering)
    workers = _fleet(cfg, attr_dir, [gw.port], (0, 1), 1)
    try:
        assert gw.wait_for_workers(2, timeout_s=WAIT)
        assert gw.stats()["workers_filtering"] == (2 if filtering else 0)
        for text in ARMS:
            assert _same(svc.topk_vectors(qv, k=10, filters=text),
                         oracle[text]), text
        answered = sum(w.answered for w in workers)
        assert answered == (2 * len(ARMS) if filtering else 0)
        assert gw.stats()["rpc_fallbacks"] == 0
        assert _same(svc.topk_vectors(qv, k=10), plain)
        assert sum(w.answered for w in workers) == answered + 2
    finally:
        _close(workers, [gw], [svc])


# -- the fleet result cache ----------------------------------------------------------

def _plant(d, qvec):
    """A generation appending one page at the query's own vector: the
    fresh answer's top-1 after a refresh."""
    store = VectorStore(d)
    pid = store.next_page_id()
    w = store.begin_generation()
    w.write_shard(np.array([pid], np.int64), qvec[None, :])
    w.commit()
    return pid


def test_result_cache_stays_staleness_zero_over_the_socket_fleet(
        store_dir, tmp_path):
    import shutil
    d = str(tmp_path / "store")
    shutil.copytree(store_dir, d)
    over = dict(partitions=2, replicas=1, result_cache=True,
                result_cache_fleet=True, heartbeat_s=HB)
    svc = _service(d, text=True, **over)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    workers = _fleet(svc.cfg, d, [gw.port], (0, 1), 1)
    srv = client = None
    try:
        assert gw.wait_for_workers(2, timeout_s=WAIT)
        srv = serve_in_background(svc)
        client = SocketSearchClient(srv.host, srv.port, result_cache=True)
        q = "socket zipf query"
        first = client.search(q, k=10)
        assert client.search(q, k=10) == first     # answered at the door
        assert svc.result_cache_hits >= 1
        assert sum(w.answered for w in workers) == 2
        key = svc._result_cache_key(q, 10, None)
        got = client.cache_lookup(q, k=10, nprobe=key[2], store_gen=key[3],
                                  index_gen=key[4])
        assert got is not None
        assert list(got[1][0][:len(first)]) == [r["page_id"] for r in first]
        assert client.cache_lookup(q, k=10, nprobe=key[2],
                                   store_gen=key[3] + 7,
                                   index_gen=key[4]) is None
        qvec = svc.encode_queries([q])[0].numpy()
        planted = _plant(d, qvec)
        svc.refresh()
        assert gw.wait_for_generation(svc._view.generation, timeout_s=WAIT)
        after = client.search(q, k=10)
        assert after[0]["page_id"] == planted      # never the stale entry
        oracle = _service(d, text=True, partitions=2)
        try:
            assert [r["page_id"] for r in after] == \
                [r["page_id"] for r in oracle.search(q, k=10)]
        finally:
            oracle.close()
        assert gw.stats()["rpc_fallbacks"] == 0
        # a stale push is dropped; a live one lands and reads back
        assert client.cache_put("stale put", k=10, nprobe=key[2],
                                store_gen=key[3], index_gen=key[4],
                                scores=np.zeros(10, np.float32),
                                ids=np.arange(10, dtype=np.int64))
        key2 = svc._result_cache_key("live put", 10, None)
        ps = np.linspace(0.9, 0.1, 10).astype(np.float32)
        pi = np.arange(10, dtype=np.int64)
        assert client.cache_put("live put", k=10, nprobe=key2[2],
                                store_gen=key2[3], index_gen=key2[4],
                                scores=ps, ids=pi)
        assert _wait(lambda: client.cache_lookup(
            "live put", k=10, nprobe=key2[2], store_gen=key2[3],
            index_gen=key2[4]) is not None)
        assert client.cache_lookup("stale put", k=10, nprobe=key[2],
                                   store_gen=key[3],
                                   index_gen=key[4]) is None
    finally:
        _close(workers, [gw], [svc],
               [x for x in (client, srv) if x is not None])


def test_a_peer_cache_serves_a_local_miss_and_fills_reach_the_peer(
        store_dir):
    over = dict(result_cache=True, result_cache_fleet=True)
    svc_a, svc_b = (_service(store_dir, text=True, **over),
                    _service(store_dir, text=True, **over))
    srv_b = serve_in_background(svc_b)
    peer = SocketSearchClient(srv_b.host, srv_b.port, result_cache=True)
    svc_a.attach_cache_peers([peer])
    try:
        q = "fleet shared query"
        want = svc_b.search(q, k=10)               # fills B's cache
        encodes = svc_a.encodes
        got = svc_a.search(q, k=10)                # A misses, B answers
        assert got == want
        assert svc_a.result_cache_hits == 1 and svc_a.encodes == encodes
        key = svc_a._result_cache_key(q, 10, None)
        assert svc_a._result_cache_get(key, count=False) == want
        q2 = "fleet pushed query"
        pushed = svc_a.search(q2, k=10)            # A's fill goes to B
        key2 = svc_b._result_cache_key(q2, 10, None)
        assert _wait(lambda: svc_b._result_cache_get(key2, count=False)
                     is not None)
        assert svc_b._result_cache_get(key2, count=False) == pushed
        # a client that did not negotiate the flag: no cache frames
        plain = SocketSearchClient(srv_b.host, srv_b.port)
        try:
            assert plain.cache_lookup(q, k=10, nprobe=0, store_gen=key[3],
                                      index_gen=key[4]) is None
            assert not plain.cache_put(q, k=10, nprobe=0, store_gen=0,
                                       index_gen=-1,
                                       scores=np.zeros(10, np.float32),
                                       ids=np.zeros(10, np.int64))
        finally:
            plain.close()
    finally:
        _close((), (), [svc_a, svc_b], [peer, srv_b])


def test_a_down_peer_opens_its_breaker(store_dir):
    svc = _service(store_dir, text=True, result_cache=True,
                   result_cache_fleet=True, breaker_failures=2,
                   breaker_open_s=60.0)

    class _Down:
        calls = 0

        def cache_lookup(self, *a, **k):
            _Down.calls += 1
            raise ConnectionRefusedError("down")

        def cache_put(self, *a, **k):
            raise ConnectionRefusedError("down")

    svc.attach_cache_peers([_Down()])
    try:
        for i in range(5):
            assert svc.search(f"query {i}", k=10)
        # two failures open it; later misses skip the peer outright
        assert _Down.calls == 1
        assert faults.counters().get("cache_peer_breaker_open") == 1
    finally:
        svc.close()


# -- the tier's trial records ---------------------------------------------------------

def test_a_tier_trial_record_carries_the_front_ends_block(store_dir):
    over = dict(partitions=2, replicas=1, heartbeat_s=HB)
    svcs = [_service(store_dir, text=True, **over) for _ in range(2)]
    gws = [WorkerGateway(s, heartbeat_s=HB) for s in svcs]
    for s, gw in zip(svcs, gws):
        s.attach_gateway(gw)
        s.start_batcher()
    workers = _fleet(svcs[0].cfg, store_dir, [g.port for g in gws],
                     (0, 1), 1)
    servers, clients = [], []
    try:
        for gw in gws:
            assert gw.wait_for_workers(2, timeout_s=WAIT)
        servers = [serve_in_background(s, front_end=i)
                   for i, s in enumerate(svcs)]
        clients = [SocketSearchClient(x.host, x.port) for x in servers]
        bal = BalancedClient(clients, policy="round_robin", seed=1)
        wl = make_workload("poisson", seed=0, distinct=16,
                           profile=((10, None, 1.0),))
        tr = run_trial(svcs[0], wl, 40.0, [f"q {i}" for i in range(16)],
                       duration_s=0.5, warmup_s=0.1, workers=4, client=bal,
                       front_ends=svcs)
        fes = tr["front_ends"]
        assert [f["front_end"] for f in fes] == [0, 1]
        assert all(set(f) == {"front_end", "qps", "p50_ms", "p99_ms",
                              "error_rate"} for f in fes)
        assert tr["achieved_qps"] == round(sum(f["qps"] for f in fes), 3)
        assert tr["p99_ms"] == max(f["p99_ms"] for f in fes)
        bal_st = tr["balance"]
        assert bal_st["policy"] == "round_robin"
        assert sum(bal_st["sent"]) == tr["requests_sent"] > 0
        assert min(bal_st["sent"]) > 0 and bal_st["errors"] == [0, 0]
        blk = tr["transport"]
        assert blk["rpcs"] > 0 and blk["rpc_fallbacks"] == 0
        assert blk["workers_live"] == 2
        assert tr["errors"] == 0
    finally:
        _close(workers, gws, svcs, clients + servers)


def test_gateway_bookkeeping_holds_under_a_thread_storm(store_dir):
    """16 threads (more than the cores) call through one gateway with the
    interpreter switching every 10 us: every answer is the oracle's, the
    RPC count is exactly one a partition a call, and nothing is left
    pending or counted as a fallback."""
    import sys
    svc = _service(store_dir, partitions=2, replicas=2, heartbeat_s=HB)
    qvs = _qv(4, seed=11)
    oracle = [svc.topk_vectors(qvs[i:i + 1], k=10) for i in range(4)]
    gw = WorkerGateway(svc, heartbeat_s=HB, hedge_quantile=0.0)
    svc.attach_gateway(gw)
    workers = _fleet(svc.cfg, store_dir, [gw.port], (0, 1), 2)
    calls, bad = 10, []
    interval = sys.getswitchinterval()
    try:
        assert gw.wait_for_workers(4, timeout_s=WAIT)
        sys.setswitchinterval(1e-5)

        def run(t):
            for c in range(calls):
                i = (t + c) % 4
                if not _same(svc.topk_vectors(qvs[i:i + 1], k=10),
                             oracle[i]):
                    bad.append(i)
        threads = [threading.Thread(target=run, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        _close(workers, [gw], [svc])
    st = gw.stats()
    assert bad == []
    assert st["rpcs"] == 16 * calls * 2
    assert st["rpcs_by_partition"] == [16 * calls, 16 * calls]
    assert st["rpc_fallbacks"] == 0 and not gw._pending
    assert sum(w.answered for w in workers) == 16 * calls * 2
