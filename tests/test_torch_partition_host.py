"""The serving fleet over the wire (infer/partition_host.py) of the port
against the JAX package on the CPU, model-free through ``topk_vectors``,
on one seeded store of 6 shards of 50 unit vectors of dim 32 that both
packages open (the tests/test_net.py idiom). Workers run as threads with
services of their own:

* the gateway's fan-out gives the in-process answers byte for byte, with
  its transport block and events;
* interop: a port ``WorkerGateway`` with JAX ``PartitionWorker``s, and a
  JAX gateway with port workers, at P=2 x R=2, compressed and raw, answer
  byte for byte as both packages' in-process ``topk_vectors``;
* parity: at P in {1, 2} x R in {1, 2} the port's gateway and workers
  equal the in-process ``PartitionSet`` (the single view at 1 x 1); with
  tombstones; with a PQ partition and an exact one mixed;
* dead workers: one stopped under a hammer gives no mixed result and sheds
  by liveness; a torn answer falls back to the local view;
* hedging fires by count at a slow primary, answers unchanged;
* ``T_REFRESH`` reaches workers with no restart; a worker's drain
  finishes its request in flight and its sibling takes new ones; the
  socket front end's graceful close finishes a request in flight over
  the fleet and sheds a fresh one with reason "draining";
* chaos: a torn connection re-dials and rejoins, answers unchanged; the
  breaker ladder on a fake clock follows JAX's states; seeded wire faults
  never change an answer; a rejoiner that missed a generation is gated
  until it acks.

No wall-clock bar is tighter than 3x the delay it measures."""
import dataclasses
import shutil
import socket
import threading
import time

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.infer import partition_host as jph
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.utils import faults as jax_faults
from dnn_page_vectors_tpu.utils import telemetry as jax_telemetry
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.infer import transport
from dnn_page_vectors_tpu_torch.infer.partition_host import (
    DeviceEmbedder, PartitionWorker, WorkerGateway)
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.utils import faults, telemetry

DIM = 32
SHARD = 50
NSHARDS = 6
ROWS = SHARD * NSHARDS
HB = 0.25                      # heartbeat seconds
WAIT = 30.0                    # every barrier's own timeout


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
    for mod in (faults, jax_faults):
        mod.reset()


def _vecs(seed=0, n=ROWS):
    v = np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _qv(n=3, seed=1):
    return _vecs(seed, n)


def _write_store(d, nshards=NSHARDS, seed=0):
    store = VectorStore(d, dim=DIM, shard_size=SHARD)
    store.ensure_model_step(0)
    vecs = _vecs(seed, nshards * SHARD)
    for si in range(nshards):
        lo, hi = si * SHARD, (si + 1) * SHARD
        store.write_shard(si, np.arange(lo, hi, dtype=np.int64),
                          vecs[lo:hi])
    return d


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    return _write_store(str(tmp_path_factory.mktemp("fleet") / "store"))


@pytest.fixture(scope="module")
def mesh():
    from dnn_page_vectors_tpu.config import MeshConfig
    from dnn_page_vectors_tpu.parallel.mesh import make_mesh
    return make_mesh(MeshConfig(data=1))


def _cfg(**serve):
    return get_config("cdssm_toy", {
        "model.out_dim": DIM, **{f"serve.{k}": v for k, v in serve.items()}})


def _service(d, **serve):
    return SearchService(_cfg(**serve), DeviceEmbedder("cpu"), None,
                         VectorStore(d))


def _jax_service(d, mesh, **serve):
    from dnn_page_vectors_tpu.infer.serve import SearchService as JaxService
    cfg = jax_get_config("cdssm_toy", {"model.out_dim": DIM})
    if serve:
        cfg = cfg.replace(serve=dataclasses.replace(cfg.serve, **serve))
    return JaxService(cfg, jph.MeshEmbedder(mesh), None, JaxStore(d),
                      preload_hbm_gb=4.0)


def _worker(cfg, d, ports, p, P, r, **kw):
    w = PartitionWorker(cfg, d, [("127.0.0.1", q) for q in ports], p, P, r,
                        device="cpu", **kw)
    threading.Thread(target=w.run, daemon=True).start()
    return w


def _fleet(cfg, d, ports, P, R, **kw):
    return [_worker(cfg, d, ports, p, P, r, **kw)
            for p in range(P) for r in range(R)]


def _close(workers=(), gateways=(), services=()):
    for w in workers:
        w.stop()
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


# -- the fan-out ----------------------------------------------------------------

def test_gateway_fanout_byte_identical_and_transport_metrics(store_dir):
    svc = _service(store_dir, partitions=2)
    qv = _qv(3)
    base = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    workers = _fleet(svc.cfg, store_dir, [gw.port], 2, 1)
    try:
        assert gw.wait_for_workers(2, timeout_s=WAIT)
        assert _same(svc.topk_vectors(qv, k=10), base)
        st = gw.stats()
        assert st["rpcs"] == 2 and st["rpc_fallbacks"] == 0
        assert st["workers_live"] == 2 and st["workers_compressing"] == 2
        met = svc.metrics()["transport"]
        assert met["wire_bytes"] > 0 and met["workers_live"] == 2
        assert met["rpcs"] == 2
        reg = svc.registry.events("worker_registered")
        assert sorted((e["attrs"]["partition"], e["attrs"]["replica"])
                      for e in reg) == [(0, 0), (1, 0)]
        assert all(e["attrs"]["generation"] == 0 for e in reg)
        # a scatter is encoded once: one RPC a partition, whatever R is
        assert [w.answered for w in workers] == [1, 1]
    finally:
        _close(workers, [gw], [svc])


# -- interop with the JAX package ---------------------------------------------

@pytest.mark.parametrize("compress", [True, False],
                         ids=["compressed", "raw"])
@pytest.mark.parametrize("gateway", ["port", "jax"])
def test_interop_with_jax_gateways_and_workers(store_dir, mesh, gateway,
                                               compress):
    """A port gateway serves JAX workers and a JAX gateway port workers,
    P=2 x R=2: the answers equal both packages' in-process ones byte for
    byte, with no fallback, compressed or raw."""
    qv = _qv(4, seed=2)
    svc = _service(store_dir, partitions=2, replicas=2,
                   wire_compress=compress)
    jsvc = _jax_service(store_dir, mesh, partitions=2, replicas=2,
                        wire_compress=compress)
    want = svc.topk_vectors(qv, k=10)
    jwant = jsvc.topk_vectors(qv, k=10)
    assert _same(want, jwant)
    workers = []
    if gateway == "port":
        front, gw = svc, WorkerGateway(svc, heartbeat_s=HB)
        for p in range(2):
            for r in range(2):
                w = jph.PartitionWorker(jsvc.cfg, store_dir,
                                        ("127.0.0.1", gw.port), partition=p,
                                        partitions=2, replica=r, mesh=mesh)
                threading.Thread(target=w.run, daemon=True).start()
                workers.append(w)
    else:
        front, gw = jsvc, jph.WorkerGateway(jsvc, heartbeat_s=HB)
        workers = _fleet(svc.cfg, store_dir, [gw.port], 2, 2)
    front.attach_gateway(gw)
    try:
        assert gw.wait_for_workers(4, timeout_s=WAIT)
        for _ in range(2):        # the second block rides an interned REF
            got = front.topk_vectors(qv, k=10)
            assert _same(got, want) and _same(got, jwant)
        st = gw.stats()
        assert st["rpcs"] == 4 and st["rpc_fallbacks"] == 0
        assert st["workers_compressing"] == (4 if compress else 0)
        if compress:
            assert front.wire_raw_bytes > front.wire_bytes
    finally:
        _close(workers, [gw], [svc, jsvc])


# -- parity with the in-process scatter -----------------------------------------

@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("partitions", [1, 2])
def test_fleet_equals_the_inprocess_partition_set(store_dir, partitions,
                                                  replicas):
    qv = _qv(5, seed=3)
    svc = _service(store_dir, partitions=partitions, replicas=replicas)
    want = svc.topk_vectors(qv, k=10)
    one = _service(store_dir)
    assert _same(one.topk_vectors(qv, k=10), want)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    workers = _fleet(svc.cfg, store_dir, [gw.port], partitions, replicas)
    try:
        assert gw.wait_for_workers(partitions * replicas, timeout_s=WAIT)
        if partitions * replicas == 1:
            # a single-view service fans out through the gateway's own set
            assert svc.partition_set is None
            assert gw.partition_set.partitions == 1
        assert _same(svc.topk_vectors(qv, k=10), want)
        assert gw.stats()["rpcs"] == partitions
        assert gw.stats()["rpc_fallbacks"] == 0
    finally:
        _close(workers, [gw], [svc, one])


def test_fleet_with_tombstones_equals_the_single_view(store_dir, tmp_path):
    d = str(tmp_path / "store")
    shutil.copytree(store_dir, d)
    dead = [3, 42, 123, 250, 299]
    VectorStore(d).begin_generation(tombstones=dead).commit()
    qv = np.concatenate([_vecs()[dead], _qv(3, seed=4)])
    one = _service(d)
    want = one.topk_vectors(qv, k=10)
    svc = _service(d, partitions=3, replicas=1)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    workers = _fleet(svc.cfg, d, [gw.port], 3, 1)
    try:
        assert gw.wait_for_workers(3, timeout_s=WAIT)
        got = svc.topk_vectors(qv, k=10)
        assert _same(got, want)
        assert not set(got[1].ravel().tolist()) & set(dead)
        assert gw.stats()["rpc_fallbacks"] == 0
        assert all(w.view.generation == 1 for w in workers)
    finally:
        _close(workers, [gw], [svc, one])


def test_fleet_pq_and_exact_partitions_mixed(store_dir, mesh, tmp_path):
    """Full probe with a full re-rank makes ADC exact; a worker whose
    index is gone serves its slice by the exact path while the other stays
    on ADC; a dead worker's slice serves from the front end's view: the
    answers stay the exact single view's (JAX tests/test_partition.py)."""
    from dnn_page_vectors_tpu.index.ivf import IVFIndex as JaxIndex
    d = str(tmp_path / "store")
    shutil.copytree(store_dir, d)
    JaxIndex.build(JaxStore(d), mesh, nlist=8, iters=5, seed=0, pq_m=8)
    qv = _qv(6, seed=5)
    exact = _service(d)
    want = exact.topk_vectors(qv, k=10)
    knobs = {"partitions": 2, "index": "ivf", "nprobe": 10_000,
             "pq_rerank": ROWS}
    svc = _service(d, **knobs)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    workers = _fleet(svc.cfg, d, [gw.port], 2, 1)
    try:
        assert gw.wait_for_workers(2, timeout_s=WAIT)
        assert all(w.view.index is not None for w in workers)
        got = svc.topk_vectors(qv, k=10)
        assert np.array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        workers[1].view.index = None        # partition 1 serves exact
        got = svc.topk_vectors(qv, k=10)
        assert np.array_equal(got[1], want[1])
        assert workers[1].svc.ann_fallbacks == len(qv)
        assert gw.stats()["rpc_fallbacks"] == 0
        workers[0].stop()                   # partition 0 folds locally
        assert _wait(lambda: not gw.worker_alive(0, 0))
        got = svc.topk_vectors(qv, k=10)
        assert np.array_equal(got[1], want[1])
    finally:
        _close(workers, [gw], [svc, exact])


# -- dead and torn workers --------------------------------------------------------

def test_stopped_worker_under_a_hammer_gives_no_mixed_result(store_dir):
    svc = _service(store_dir, partitions=1, replicas=2)
    qv = _qv(2)
    base = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    workers = _fleet(svc.cfg, store_dir, [gw.port], 1, 2,
                     heartbeat_s=HB)
    errors, mismatches, results = [], [], [0]
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                got = svc.topk_vectors(qv, k=10)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return
            results[0] += 1
            if not _same(got, base):
                mismatches.append(got)

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    try:
        assert gw.wait_for_workers(2, timeout_s=WAIT)
        for t in threads:
            t.start()
        time.sleep(0.3)
        workers[0].stop()                      # the primary's worker dies
        assert _wait(lambda: not gw.worker_alive(0, 0), 3 * HB)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join()
        assert not errors and not mismatches and results[0] > 0
        assert svc.registry.events("worker_lost")
        svc.topk_vectors(qv, k=10)
        sheds = svc.registry.events("replica_shed")
        assert sheds and sheds[-1]["attrs"]["reason"] == "liveness"
        assert sheds[-1]["attrs"]["to_replica"] == 1
    finally:
        stop.set()
        _close(workers, [gw], [svc])


def test_torn_answer_falls_back_to_the_local_view(store_dir):
    svc = _service(store_dir, partitions=1)
    qv = _qv(2)
    base = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=HB, rpc_timeout_s=5.0)
    svc.attach_gateway(gw)
    done = threading.Event()

    def evil_worker():
        sock = socket.create_connection(("127.0.0.1", gw.port))
        transport.write_frame(sock, transport.T_REGISTER,
                              transport.encode_register(0, 0, 4242))
        assert transport.read_frame(sock) is not None   # the VQUERY
        # a RESULT header promising bytes that never come
        sock.sendall(transport.HEADER.pack(transport.MAGIC,
                                           transport.T_RESULT, 4096))
        sock.sendall(b"\x00" * 16)
        sock.close()
        done.set()

    t = threading.Thread(target=evil_worker, daemon=True)
    t.start()
    try:
        assert gw.wait_for_workers(1, timeout_s=WAIT)
        assert _same(svc.topk_vectors(qv, k=10), base)
        assert done.wait(WAIT)
        lost = svc.registry.events("worker_lost")
        assert lost and "torn" in lost[-1]["attrs"]["reason"]
        assert gw.stats()["rpc_fallbacks"] == 1
        assert _same(svc.topk_vectors(qv, k=10), base)   # wholly local
    finally:
        _close((), [gw], [svc])


# -- hedging ---------------------------------------------------------------------

def test_hedge_fires_to_the_sibling_at_a_slow_primary(store_dir):
    svc = _service(store_dir, partitions=1, replicas=2, hedge_quantile=0.5)
    qv = _qv(2)
    base = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    workers = _fleet(svc.cfg, store_dir, [gw.port], 1, 2)
    try:
        assert gw.wait_for_workers(2, timeout_s=WAIT)
        for _ in range(10):                  # the latency history warms
            assert _same(svc.topk_vectors(qv, k=10), base)
        assert gw._hedge_delay_s(0) is not None
        warm = svc.hedge_fires
        slow_s = 1.0
        workers[0].slow_ms = slow_s * 1000.0
        t0 = time.perf_counter()
        got = svc.topk_vectors(qv, k=10)
        dt = time.perf_counter() - t0
        assert _same(got, base)
        assert svc.hedge_fires == warm + 1
        assert dt < slow_s / 3, f"the hedge took {dt:.3f} s"
        ev = svc.registry.events("hedge_fired")[-1]["attrs"]
        assert (ev["partition"], ev["from_replica"], ev["to_replica"]) == \
            (0, 0, 1)
        assert svc.metrics()["transport"]["hedge_fires"] == warm + 1
    finally:
        _close(workers, [gw], [svc])


# -- T_REFRESH and drain -------------------------------------------------------------

def _grow(d, seed):
    """A generation of one appended shard behind the fleet's back."""
    grow = VectorStore(d)
    writer = grow.begin_generation()
    start = grow.next_page_id()
    writer.write_shard(np.arange(start, start + SHARD, dtype=np.int64),
                       _vecs(seed, SHARD))
    writer.commit()


@pytest.mark.parametrize("P", [1, 2])
def test_refresh_reaches_workers_without_a_restart(tmp_path, P):
    d = _write_store(str(tmp_path / "store"), nshards=4, seed=3)
    svc = _service(d, partitions=P)
    qv = _qv(2)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    workers = _fleet(svc.cfg, d, [gw.port], P, 1)
    try:
        assert gw.wait_for_workers(P, timeout_s=WAIT)
        svc.topk_vectors(qv, k=10)
        rpcs0 = gw.stats()["rpcs"]
        _grow(d, seed=9)
        info = svc.refresh()
        assert info["workers_refresh"]["workers_told"] == P
        gen = svc._view.generation
        assert gw.wait_for_generation(gen, timeout_s=WAIT)
        assert gw.stale_workers(gen) == 0
        got = svc.topk_vectors(qv, k=10)
        assert gw.stats()["rpcs"] > rpcs0
        assert gw.stats()["rpc_fallbacks"] == 0
        oracle = _service(d, partitions=P)   # a restarted worker's view
        try:
            assert _same(got, oracle.topk_vectors(qv, k=10))
        finally:
            oracle.close()
        assert all(w.sessions == 1 for w in workers)      # no restart
        evs = svc.registry.events("worker_refreshed")
        assert len(evs) == P and all(e["attrs"]["generation"] == gen
                                     for e in evs)
    finally:
        _close(workers, [gw], [svc])


def test_drain_finishes_the_request_in_flight_and_sheds_new_ones(
        store_dir):
    """A worker's drain: T_DRAIN stops new work at once (its sibling takes
    the partition), the answer in flight still comes from it, then BYE."""
    svc = _service(store_dir, partitions=1, replicas=2, hedge_quantile=0.0)
    qv = _qv(2)
    base = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    workers = _fleet(svc.cfg, store_dir, [gw.port], 1, 2)
    try:
        assert gw.wait_for_workers(2, timeout_s=WAIT)
        primary = workers[0]
        primary.slow_ms = 300.0
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "got", svc.topk_vectors(qv, k=10)))
        t.start()
        assert _wait(lambda: gw.stats()["rpcs"] == 1)
        drainer = threading.Thread(target=primary.drain,
                                   kwargs={"wait_s": 1.0})
        drainer.start()
        assert _wait(lambda: gw.stats()["workers_draining"] == 1)
        # new work goes to the sibling while the primary drains
        assert _same(svc.topk_vectors(qv, k=10), base)
        assert workers[1].answered == 1
        t.join(WAIT)
        drainer.join(WAIT)
        assert _same(out["got"], base)
        assert primary.answered == 1            # it answered in flight
        assert gw.stats()["rpc_fallbacks"] == 0
        assert svc.registry.events("worker_draining")
        assert _wait(lambda: not gw.worker_alive(0, 0))
        lost = svc.registry.events("worker_lost")[-1]["attrs"]
        assert lost["reason"] == "deregistered"
    finally:
        _close(workers, [gw], [svc])


def test_server_drain_finishes_a_request_in_flight_over_the_fleet(
        store_dir):
    """The socket front end's graceful close over a fleet (JAX
    tests/test_net.py:864): a request in flight to a slow worker finishes
    and answers normally; a fresh one on an open connection is shed with
    reason "draining", counted in serve.deadline_shed, never an error."""
    from dnn_page_vectors_tpu_torch.infer.server import serve_in_background
    from dnn_page_vectors_tpu_torch.infer.transport import (
        DeadlineExceeded, SocketSearchClient)
    svc = _service(store_dir, partitions=1, hedge_quantile=0.0)
    qv = _qv(2)
    base = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    (w,) = _fleet(svc.cfg, store_dir, [gw.port], 1, 1)
    srv = serve_in_background(svc)
    c1 = SocketSearchClient(srv.host, srv.port)
    c2 = SocketSearchClient(srv.host, srv.port)
    out = {}
    try:
        assert gw.wait_for_workers(1, timeout_s=WAIT)
        c2.topk_vectors(qv, k=10)              # c2's connection is open
        w.slow_ms = 500.0
        t = threading.Thread(target=lambda: out.setdefault(
            "got", c1.topk_vectors(qv, k=10)))
        t.start()
        assert _wait(lambda: gw.stats()["rpcs"] == 2)   # c1's is sent
        closer = threading.Thread(target=lambda: srv.close(drain_s=10.0))
        closer.start()
        assert _wait(lambda: srv._draining)
        with pytest.raises(DeadlineExceeded, match="draining"):
            c2.topk_vectors(qv, k=10)
        t.join(WAIT)
        closer.join(WAIT)
        assert not t.is_alive() and not closer.is_alive()
        s, i, _ = out["got"]
        assert np.array_equal(s, base[0]) and np.array_equal(i, base[1])
        assert svc.deadline_sheds >= 1 and svc._m_errors.value == 0
        assert gw.stats()["rpc_fallbacks"] == 0 and w.answered == 2
        ev = svc.registry.events("deadline_shed")
        assert ev and ev[-1]["attrs"]["reason"] == "draining"
    finally:
        c1.close()
        c2.close()
        srv.close()
        _close([w], [gw], [svc])


# -- chaos ------------------------------------------------------------------------

def test_reconnect_after_a_torn_connection_is_byte_identical(store_dir):
    svc = _service(store_dir, partitions=1, heartbeat_s=HB)
    qv = _qv(2)
    base = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    (w,) = _fleet(svc.cfg, store_dir, [gw.port], 1, 1)
    errors, mismatches = [], []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                got = svc.topk_vectors(qv, k=10)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return
            if not _same(got, base):
                mismatches.append(got)

    th = threading.Thread(target=hammer)
    try:
        assert gw.wait_for_workers(1, timeout_s=WAIT)
        th.start()
        time.sleep(0.2)
        t_kill = time.perf_counter()
        w.kill_connection()
        assert _wait(lambda: svc.registry.events("worker_rejoined")
                     and gw.worker_alive(0, 0))
        recovery = time.perf_counter() - t_kill
        time.sleep(0.2)
        stop.set()
        th.join()
        assert not errors and not mismatches
        assert recovery <= 3 * 2.0 + 3 * HB     # the backoff cap, 3x
        assert w.sessions >= 2
        rpcs0 = gw.stats()["rpcs"]
        svc.topk_vectors(qv, k=10)
        assert gw.stats()["rpcs"] > rpcs0       # it carries traffic again
        assert faults.counters().get("worker_reconnect", 0) >= 1
    finally:
        stop.set()
        _close([w], [gw], [svc])


def test_breaker_ladder_follows_jax_on_a_fake_clock():
    """closed -> K failures -> open -> half-open probe -> doubled backoff
    -> closed, with the callbacks, step for step as JAX's breaker."""
    def run(mod):
        t = [0.0]
        opened, closed = [], []
        br = mod.CircuitBreaker(failures=3, open_s=1.0, max_open_s=4.0,
                                clock=lambda: t[0],
                                on_open=opened.append,
                                on_close=closed.append)
        trace = []

        def step(what, at=None):
            if at is not None:
                t[0] = at
            out = getattr(br, what)() if what else None
            trace.append((what, out, br.state, br.trips))

        step("allow")
        for op in ("record_failure", "record_failure", "allow",
                   "record_success", "record_failure", "record_failure",
                   "record_failure", "allow"):
            step(op)
        step("allow", 0.99)
        step("allow", 1.0)
        step("allow")
        step("record_failure")
        step("allow", 2.5)
        step("allow", 3.0)
        step("record_success")
        step("allow")
        for _ in range(3):
            step("record_failure")
        step("allow", 4.0)
        for _ in range(2):       # a half-open failure caps the ramp at 4 s
            step("record_failure")
            step("allow", t[0] + 3.9)
            step("allow", t[0] + 0.2)
        return trace, len(opened), len(closed)

    got = run(faults)
    assert got == run(jax_faults)
    trace, n_open, n_close = got
    states = [s for _, _, s, _ in trace]
    assert states[0] == "closed" and "half_open" in states
    assert n_open >= 3 and n_close == 1


def test_seeded_wire_faults_never_change_an_answer(store_dir):
    svc = _service(store_dir, partitions=1, heartbeat_s=HB)
    qv = _qv(2)
    base = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    (w,) = _fleet(svc.cfg, store_dir, [gw.port], 1, 1)
    try:
        assert gw.wait_for_workers(1, timeout_s=WAIT)
        svc.topk_vectors(qv, k=10)
        faults.install(faults.FaultPlan.parse(
            "wire_send:frame_trunc:8,wire_send:frame_dup:20,"
            "wire_recv:frame_delay:6,wire_send:conn_drop:34", seed=1))
        plan = faults.active()
        t_end = time.perf_counter() + WAIT
        calls = 0
        # at least 50 calls, and on until every scheduled fault has fired
        # (a torn connection re-dials meanwhile; its calls serve locally)
        while calls < 50 or (any(plan.pending(op) for op in
                                 ("wire_send", "wire_recv"))
                             and time.perf_counter() < t_end):
            assert _same(svc.topk_vectors(qv, k=10), base)
            calls += 1
            time.sleep(0.005)
        fired = {k: v for k, v in faults.counters().items()
                 if k.startswith("injected_")}
        assert sum(fired.values()) == 4, fired
        assert gw.stats()["rpc_fallbacks"] >= 1
    finally:
        faults.reset()
        _close([w], [gw], [svc])


def test_a_lagging_rejoiner_is_gated_until_it_acks(tmp_path):
    d = _write_store(str(tmp_path / "store"), nshards=4, seed=3)
    svc = _service(d, partitions=1, heartbeat_s=HB)
    qv = _qv(2)
    old = svc.topk_vectors(qv, k=10)
    gw = WorkerGateway(svc, heartbeat_s=HB)
    svc.attach_gateway(gw)
    (w,) = _fleet(svc.cfg, d, [gw.port], 1, 1)
    blends, errors, new = [], [], {}
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                got = svc.topk_vectors(qv, k=10)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return
            if not (_same(got, old) or ("v" in new and _same(got,
                                                             new["v"]))):
                blends.append(got)

    th = threading.Thread(target=hammer)
    try:
        assert gw.wait_for_workers(1, timeout_s=WAIT)
        old_gen = svc._view.generation
        # hold the re-dial back so the refresh lands while it is away
        w.reconnect_base_s = w.reconnect_max_s = 0.6
        w.kill_connection()
        assert _wait(lambda: not gw.worker_alive(0, 0))
        _grow(d, seed=9)
        svc.refresh()                       # told to no live worker
        gen = svc._view.generation
        oracle = _service(d)
        new["v"] = oracle.topk_vectors(qv, k=10)
        oracle.close()
        th.start()

        def acked():
            ref = svc.registry.events("worker_refreshed")
            return (ref and ref[-1]["attrs"]["generation"] == gen
                    and gw.worker_alive(0, 0))
        assert _wait(acked)
        time.sleep(0.2)
        stop.set()
        th.join()
        assert not errors and not blends
        assert svc.registry.events("worker_registered")[-1]["attrs"][
            "generation"] == old_gen
        assert svc.registry.events("worker_rejoined")
        rpcs0 = gw.stats()["rpcs"]
        assert _same(svc.topk_vectors(qv, k=10), new["v"])
        assert gw.stats()["rpcs"] > rpcs0
    finally:
        stop.set()
        _close([w], [gw], [svc])
