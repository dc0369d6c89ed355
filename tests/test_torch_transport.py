"""The port's wire protocol (infer/transport.py) and socket front end
(infer/server.py) against the JAX package's, on the CPU: every frame the
port encodes, the fleet's (REGISTER, HEARTBEAT, BYE, REFRESH, DRAIN,
CACHE_LOOKUP, CACHE_PUT) included, is byte for byte the JAX encoder's,
and each package decodes the other's; truncated, garbage and oversize
frames are rejected as JAX rejects them, and every frame type JAX accepts
is accepted; the wire fault hooks act on a socket as JAX's do; a loopback SearchServer returns the in-process results (to
the port's client and to the JAX package's); an expired deadline gets
T_SHED and takes no bucket slot, the micro-batch door sheds a request
that expires in the queue, and the queue-wait p99 budget sheds. The
service is model-free: a stub query tower hashes the token ids onto unit
vectors, over a synthetic fp16 store."""
import socket
import struct
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.infer import transport as jt
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.infer import transport as tt
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.server import (
    parse_listen, serve_in_background)
from dnn_page_vectors_tpu_torch.infer.transport import (
    DeadlineExceeded, FrameError, RemoteError, SocketSearchClient)
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore

DIM = 32
SHARD = 50
NSHARDS = 6


# -- codecs -------------------------------------------------------------------

def _frames(mod):
    """(name, bytes) of every single-service frame, from module `mod`."""
    rng = np.random.default_rng(0)
    qv = rng.standard_normal((3, DIM)).astype(np.float32)
    s = rng.standard_normal((2, 5)).astype(np.float32)
    i = rng.integers(-1, 10 ** 12, size=(2, 5))
    i[1, 3:] = -1
    block = qv.tobytes()
    return [
        ("query", mod.pack_frame(mod.T_QUERY, mod.encode_query(
            7, ["alpha beta", "", "é ü"], k=10, nprobe=4,
            deadline_ms=12.5))),
        ("query_filtered", mod.encode_query(8, ["x"], filters="lang==0")),
        ("vquery", mod.pack_frame(mod.T_VQUERY, mod.encode_vquery(
            9, qv, k=5, deadline_ms=1.0))),
        ("vquery_put", mod.encode_vquery_put(10, 3, block, 3, DIM, k=5)),
        ("vquery_ref", mod.encode_vquery_ref(11, 3, 3, DIM, k=5,
                                             nprobe=2)),
        ("result", mod.pack_frame(mod.T_RESULT, mod.encode_result(
            12, s, i, scan_bytes=4096))),
        ("result_c", mod.pack_frame(mod.T_RESULT_C, mod.encode_result_c(
            13, s, i, scan_bytes=4096))),
        ("shed", mod.pack_frame(mod.T_SHED, mod.encode_shed(
            14, mod.SHED_DEADLINE, "late"))),
        ("error", mod.pack_frame(mod.T_ERROR, mod.encode_error(15, "boom"))),
        ("hello", mod.pack_frame(mod.T_HELLO, mod.encode_hello(
            mod.FLAG_WIRE_COMPRESS | mod.FLAG_FILTERS))),
        ("raw_bytes", struct.pack("!q", mod.result_raw_bytes(4, 10))),
        ("register", mod.pack_frame(mod.T_REGISTER, mod.encode_register(
            3, 1, 4242, flags=mod.FLAG_WIRE_COMPRESS | mod.FLAG_FILTERS,
            generation=7))),
        ("register_legacy_fields", mod.encode_register(0, 0, 1)),
        ("heartbeat", mod.pack_frame(mod.T_HEARTBEAT)),
        ("bye", mod.pack_frame(mod.T_BYE)),
        ("drain", mod.pack_frame(mod.T_DRAIN)),
        ("refresh", mod.pack_frame(mod.T_REFRESH, mod.encode_refresh(9))),
        ("refresh_split", mod.pack_frame(mod.T_REFRESH, mod.encode_refresh(
            9, 4))),
        ("cache_lookup", mod.pack_frame(mod.T_CACHE_LOOKUP,
                                        mod.encode_cache_lookup(
                                            16, "alpha  béta", k=10,
                                            nprobe=4,
                                            store_gen=(5 << 32) | 3,
                                            index_gen=-1))),
        ("cache_put", mod.pack_frame(mod.T_CACHE_PUT, mod.encode_cache_put(
            17, "alpha", k=5, nprobe=0, store_gen=2, index_gen=6,
            scores=s[1], ids=i[1]))),
        ("cache_miss", mod.encode_shed(18, mod.SHED_CACHE_MISS,
                                       "cache_miss")),
    ]


def test_every_frame_equals_jax_bytes():
    mine, want = _frames(tt), _frames(jt)
    assert [n for n, _ in mine] == [n for n, _ in want]
    for (name, a), (_, b) in zip(mine, want):
        assert a == b, name
    for const in ("MAGIC", "MAX_FRAME", "T_QUERY", "T_VQUERY", "T_RESULT",
                  "T_SHED", "T_ERROR", "T_RESULT_C", "T_VQUERY_PUT",
                  "T_VQUERY_REF", "T_HELLO", "FLAG_WIRE_COMPRESS",
                  "FLAG_RESULT_CACHE", "FLAG_FILTERS", "WIRE_SLOTS",
                  "SHED_DEADLINE", "SHED_QUEUE", "SHED_DRAINING",
                  "T_REGISTER", "T_HEARTBEAT", "T_BYE", "T_REFRESH",
                  "T_CACHE_LOOKUP", "T_CACHE_PUT", "T_DRAIN",
                  "SHED_CACHE_MISS"):
        assert getattr(tt, const) == getattr(jt, const), const
    assert tt._TYPES == jt._TYPES


def test_each_package_decodes_the_others_frames():
    rng = np.random.default_rng(1)
    qv = rng.standard_normal((4, DIM)).astype(np.float32)
    s = rng.standard_normal((4, 10)).astype(np.float32)
    i = rng.integers(0, 10 ** 6, size=(4, 10))
    for enc, dec in ((jt, tt), (tt, jt)):
        q = dec.decode_query(enc.encode_query(3, ["a b", "c"], k=7,
                                              deadline_ms=2.0,
                                              filters="site in {1}"))
        assert (q.req_id, q.k, q.deadline_ms, q.queries, q.filters) == \
            (3, 7, 2.0, ("a b", "c"), "site in {1}")
        v = dec.decode_vquery(enc.encode_vquery(4, qv, k=3, nprobe=8))
        assert np.array_equal(v.qv, qv) and (v.k, v.nprobe) == (3, 8)
        slots = {}
        put = dec.decode_vquery_any(dec.T_VQUERY_PUT, enc.encode_vquery_put(
            5, 2, qv.tobytes(), 4, DIM, k=3), slots)
        ref = dec.decode_vquery_any(dec.T_VQUERY_REF, enc.encode_vquery_ref(
            6, 2, 4, DIM, k=3), slots)
        assert np.array_equal(put.qv, qv) and np.array_equal(ref.qv, qv)
        for fn, ftype in (("encode_result", dec.T_RESULT),
                          ("encode_result_c", dec.T_RESULT_C)):
            rid, rs, ri, scan = dec.decode_result_any(
                ftype, getattr(enc, fn)(9, s, i, scan_bytes=77))
            assert (rid, scan) == (9, 77)
            assert np.array_equal(rs, s) and np.array_equal(ri, i)
        assert dec.decode_shed(enc.encode_shed(1, 2, "x")) == (1, 2, "x")
        assert dec.decode_error(enc.encode_error(1, "y")) == (1, "y")
        assert dec.decode_hello(enc.encode_hello(5)) == 5
        assert dec.decode_register(enc.encode_register(
            2, 1, 99, flags=3, generation=11)) == (2, 1, 99, 3, 11)
        assert dec.decode_register(enc._REGISTER_HEAD.pack(2, 1, 99)) == \
            (2, 1, 99, 0, 0)
        assert dec.decode_refresh(enc.encode_refresh(12)) == (12, 0)
        assert dec.decode_refresh(enc.encode_refresh(12, 3)) == (12, 3)
        key = dec.decode_cache_lookup(enc.encode_cache_lookup(
            8, "q ü", k=10, nprobe=2, store_gen=(1 << 40) | 4,
            index_gen=-1))
        assert (key.req_id, key.query, key.k, key.nprobe, key.store_gen,
                key.index_gen) == (8, "q ü", 10, 2, (1 << 40) | 4, -1)
        key, ps, pi = dec.decode_cache_put(enc.encode_cache_put(
            9, "q", k=10, nprobe=0, store_gen=1, index_gen=2, scores=s[0],
            ids=i[0]))
        assert (key.req_id, key.query, key.k) == (9, "q", 10)
        assert np.array_equal(ps, s[0]) and np.array_equal(pi, i[0])


def _rejects(fn, payload) -> bool:
    try:
        fn(payload)
    except Exception as e:  # noqa: BLE001 — which class is compared below
        return type(e).__name__
    return None


def test_truncation_garbage_and_oversize_rejected_as_jax():
    rng = np.random.default_rng(2)
    qv = rng.standard_normal((3, DIM)).astype(np.float32)
    s = rng.standard_normal((3, 10)).astype(np.float32)
    i = rng.integers(-1, 10 ** 9, size=(3, 10))
    cases = [
        ("decode_query", jt.encode_query(1, ["hello", "wörld"], k=3,
                                         filters="lang==1")),
        ("decode_vquery", jt.encode_vquery(2, qv)),
        ("decode_result", jt.encode_result(3, s, i)),
        ("decode_result_c", jt.encode_result_c(3, s, i)),
        ("decode_shed", jt.encode_shed(4, 1, "late")),
        ("decode_error", jt.encode_error(5, "boom")),
        ("decode_hello", jt.encode_hello(1)),
        ("decode_register", jt.encode_register(1, 2, 3, flags=1,
                                               generation=4)),
        ("decode_refresh", jt.encode_refresh(5, 2)),
        ("decode_cache_lookup", jt.encode_cache_lookup(
            6, "héllo", k=10, nprobe=0, store_gen=1, index_gen=-1)),
        ("decode_cache_put", jt.encode_cache_put(
            7, "q", k=10, nprobe=0, store_gen=1, index_gen=2, scores=s[0],
            ids=i[0])),
    ]
    checked = 0
    for fn, payload in cases:
        variants = [payload[:n] for n in range(len(payload))]
        variants += [payload + b"\x00", payload + b"\xff\xff\xff"]
        for _ in range(40):
            b = bytearray(payload)
            for pos in rng.integers(0, len(b), size=3):
                b[pos] = int(rng.integers(0, 256))
            variants.append(bytes(b))
        for v in variants:
            got = _rejects(getattr(tt, fn), v)
            want = _rejects(getattr(jt, fn), v)
            assert got == want, (fn, v)
            checked += 1
    assert checked > 500
    # headers: bad magic, unknown type, oversize length — before any read
    for hdr in (struct.pack("!IBI", 0xDEADBEEF, tt.T_QUERY, 4),
                struct.pack("!IBI", tt.MAGIC, 99, 4),
                struct.pack("!IBI", tt.MAGIC, tt.T_QUERY, tt.MAX_FRAME + 1)):
        for mod in (tt, jt):
            with pytest.raises(mod.FrameError):
                mod._check_header(hdr)
    # every frame type JAX accepts, the fleet's included, is accepted, and
    # any other is rejected as JAX rejects it
    for ftype in range(256):
        hdr = struct.pack("!IBI", tt.MAGIC, ftype, 0)
        assert _rejects(tt._check_header, hdr) == \
            _rejects(jt._check_header, hdr), ftype
        if ftype in jt._TYPES:
            assert tt._check_header(hdr) == (ftype, 0)
    # varint: unterminated continuation, truncated mid-varint
    body = jt.encode_result_c(1, s[:1, :2], np.array([[5, 2 ** 40]]))
    for v in (body[:-1], body[:-3] + b"\xff" * 11):
        assert _rejects(tt.decode_result_c, v) == \
            _rejects(jt.decode_result_c, v) == "FrameError"


def test_read_frame_truncation_vs_clean_eof():
    a, b = socket.socketpair()
    try:
        tt.write_frame(a, tt.T_ERROR, tt.encode_error(1, "x"))
        assert tt.read_frame(b) == (tt.T_ERROR, tt.encode_error(1, "x"))
        a.sendall(tt.HEADER.pack(tt.MAGIC, tt.T_QUERY, 50) + b"short")
        a.close()
        with pytest.raises(FrameError, match="truncated"):
            tt.read_frame(b)
    finally:
        b.close()
    a, b = socket.socketpair()
    a.close()
    assert tt.read_frame(b) is None          # clean EOF at a boundary
    b.close()


@pytest.mark.parametrize("plan", [
    "wire_send:frame_dup:1", "wire_send:frame_trunc:1",
    "wire_send:conn_drop:1", "wire_send:frame_delay:1",
    "wire_recv:conn_drop:1", "wire_recv:frame_delay:1"])
def test_wire_fault_hooks_act_as_jax(plan):
    """The same seeded plan on the same frames: what the receiving end
    reads, whether the call raises (InjectedFault, an OSError, tearing the
    stream) and the injected counters, for both packages."""
    from dnn_page_vectors_tpu.utils import faults as jf
    from dnn_page_vectors_tpu_torch.utils import faults as tf

    def run(mod, fmod):
        fmod.reset()
        fmod.install(fmod.FaultPlan.parse(plan, seed=3))
        a, b = socket.socketpair()
        out = []
        try:
            for j in range(3):
                try:
                    if plan.startswith("wire_send") and j == 1:
                        mod.FrameSender(a).send(mod.T_ERROR,
                                                mod.encode_error(j, "x"))
                    else:
                        mod.write_frame(a, mod.T_ERROR,
                                        mod.encode_error(j, "x"))
                    out.append("sent")
                except OSError as e:
                    out.append(type(e).__name__)
                    break
            a.shutdown(socket.SHUT_WR) if out[-1] == "sent" else None
            while True:
                try:
                    frame = mod.read_frame(b)
                except (OSError, mod.FrameError) as e:
                    out.append(type(e).__name__)
                    break
                if frame is None:
                    out.append("eof")
                    break
                out.append(mod.decode_error(frame[1]))
        finally:
            for x in (a, b):
                try:
                    x.close()
                except OSError:
                    pass
        counts = {k: v for k, v in fmod.counters().items()
                  if k.startswith("injected_")}
        fmod.reset()
        return out, counts

    got, want = run(tt, tf), run(jt, jf)
    assert got == want
    assert sum(got[1].values()) == 1
    table = tt.InternTable(cap=2)
    assert table.slot_for(b"x") == (0, True)
    assert table.slot_for(b"x") == (0, False)
    assert table.slot_for(b"y") == (1, True)
    assert table.slot_for(b"z") == (0, True)  # the ring evicts x
    assert table.slot_for(b"x") == (1, True)


# -- a model-free service over a synthetic store ------------------------------

class _Tok:
    def encode_batch(self, texts):
        out = np.zeros((len(texts), 4), np.int32)
        for r, t in enumerate(texts):
            for c, w in enumerate(t.split()[:4]):
                out[r, c] = 1 + sum(w.encode()) % 997
        return out


class _StubEmbedder:
    """The query tower's stand-in: token ids -> unit vectors through a
    fixed random table (all-pad rows give zero vectors)."""

    def __init__(self):
        g = torch.Generator().manual_seed(0)
        self.table = torch.randn(1000, DIM, generator=g)
        self.table[0] = 0
        self.query_tok = _Tok()
        self.device = torch.device("cpu")
        self.calls = 0

    def encode_queries(self, ids):
        self.calls += 1
        v = self.table[ids.long()].sum(1)
        return v / v.norm(dim=1, keepdim=True).clamp_min(1e-6)


class _Corpus:
    def page_text(self, i):
        return f"page {i}"


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("net") / "store")
    rng = np.random.default_rng(0)
    st = VectorStore(d, dim=DIM, shard_size=SHARD)
    for si in range(NSHARDS):
        v = rng.standard_normal((SHARD, DIM)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        st.write_shard(si, np.arange(si * SHARD, (si + 1) * SHARD), v)
    return VectorStore(d)


def _service(store, **over):
    cfg = get_config("cdssm_toy", {"model.out_dim": DIM, **over})
    return SearchService(cfg, _StubEmbedder(), _Corpus(), store)


def test_loopback_server_returns_the_inprocess_results(store):
    svc = _service(store)
    svc.start_batcher()
    srv = serve_in_background(svc)
    clients = [SocketSearchClient(srv.host, srv.port),
               SocketSearchClient(srv.host, srv.port, compress=False),
               jt.SocketSearchClient(srv.host, srv.port)]
    try:
        assert parse_listen("127.0.0.1:0") == ("127.0.0.1", 0)
        assert parse_listen(":8080") == ("127.0.0.1", 8080)
        rng = np.random.default_rng(3)
        qv = rng.standard_normal((3, DIM)).astype(np.float32)
        base_s, base_i = svc.topk_vectors(qv, k=10)
        queries = ["alpha beta", "gamma", "delta epsilon zeta"]
        local = svc.search_many(queries, k=10)
        for client in clients:
            for _ in range(2):            # the second block is a REF
                s, i, _ = client.topk_vectors(qv, k=10)
                assert np.array_equal(s, base_s) and np.array_equal(i, base_i)
            ws, wi, _ = client.search_raw(queries, k=10)
            for qi, res in enumerate(local):
                assert [r["page_id"] for r in res] == \
                    [int(x) for x in wi[qi] if x >= 0]
                assert [r["score"] for r in res] == \
                    [round(float(x), 4) for x, p in zip(ws[qi], wi[qi])
                     if p >= 0]
            one = client.search(queries[1], k=10)     # through the batcher
            assert [(r["page_id"], round(r["score"], 4)) for r in one] == \
                [(r["page_id"], r["score"]) for r in local[1]]
        m = svc.metrics()["transport"]
        assert m["wire_bytes"] > 0
        assert m["wire_raw_bytes"] > m["wire_bytes"]   # compressed + interned
        # the server confirms FLAG_FILTERS: a filtered query is served,
        # through each client, as in process (the store has no attribute
        # table, so lang==0 keeps every row and lang==1 none)
        flt = jt.SocketSearchClient(srv.host, srv.port)
        for client in (clients[0], flt):
            assert client.search("x", filters="lang==0") == \
                client.search("x")
            assert client.search("x", filters="lang==1") == []
            s3, i3, _ = client.topk_vectors(qv, k=10, filters="lang==0")
            assert np.array_equal(i3, base_i)
        flt.close()
        # a malformed predicate in a frame gets one T_ERROR, and nothing
        # is served
        served = svc._m_requests.value
        raw = socket.create_connection((srv.host, srv.port), timeout=5)
        tt.write_frame(raw, tt.T_QUERY, tt.encode_query(
            77, ["x"], k=5, filters="lang==999"))
        ftype, body = tt.read_frame(raw)
        assert ftype == tt.T_ERROR and "FilterError" in tt.decode_error(
            body)[1]
        raw.close()
        assert svc._m_requests.value == served
        # garbage -> one ERROR frame, then the connection closes; the
        # server keeps serving
        raw = socket.create_connection((srv.host, srv.port), timeout=5)
        raw.sendall(b"GET / HTTP/1.1\r\n\r\n")
        frame = tt.read_frame(raw)
        assert frame is not None and frame[0] == tt.T_ERROR
        assert tt.read_frame(raw) is None
        raw.close()
        raw = socket.create_connection((srv.host, srv.port), timeout=5)
        raw.sendall(tt.HEADER.pack(tt.MAGIC, tt.T_QUERY, 100) + b"short")
        raw.close()
        s2, i2, _ = clients[0].topk_vectors(qv, k=10)
        assert np.array_equal(i2, base_i)
        assert svc.batch_retries == 0
    finally:
        for c in clients:
            c.close()
        srv.close()
        svc.close()


def test_expired_deadline_gets_shed_and_takes_no_slot(store):
    svc = _service(store)
    fake = {"t": 100.0}

    def clock():                          # every read moves time 1 s on
        fake["t"] += 1.0
        return fake["t"]
    svc._clock = clock
    svc.start_batcher()
    srv = serve_in_background(svc)
    client = SocketSearchClient(srv.host, srv.port)
    try:
        client.search("warm", k=10)       # no deadline: admitted
        slots, encodes = len(svc.batch_sizes), svc.encodes
        with pytest.raises(DeadlineExceeded, match="expired"):
            client.search("late", k=10, deadline_ms=5.0)
        assert len(svc.batch_sizes) == slots       # no bucket slot
        assert svc.encodes == encodes              # nothing encoded
        assert svc.deadline_sheds == 1
        assert svc._m_errors.value == 0            # a shed is not an error
        assert svc.metrics()["transport"]["deadline_sheds"] == 1
        ev = [e for e in svc.registry.events() if e["event"] ==
              "deadline_shed"]
        assert ev[-1]["attrs"]["reason"] == "expired"
        # in process, with a deadline anchored earlier
        dl = svc.default_deadline(5.0)
        with pytest.raises(DeadlineExceeded):
            svc.search("gamma", k=10, deadline=dl)
        assert svc.deadline_sheds == 2 and svc._batcher._q.qsize() == 0
    finally:
        client.close()
        srv.close()
        svc.close()


def test_door_sheds_a_request_that_expires_in_the_queue(store):
    svc = _service(store)
    fake = {"t": 50.0}
    svc._clock = lambda: fake["t"]
    svc.start_batcher()
    b = svc._batcher
    try:
        fut: Future = Future()
        item = ("q", (10, None, None), fut, 0.0, None,
                svc.default_deadline(5.0))
        fake["t"] += 1.0                  # expires while queued
        n = len(b.batch_sizes)
        b._dispatch([item])
        assert len(b.batch_sizes) == n
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=5)
        ev = [e for e in svc.registry.events()
              if e["event"] == "deadline_shed"]
        assert ev[-1]["attrs"]["reason"] == "expired_in_queue"
        dead, live = Future(), Future()
        b._dispatch([("d", (10, None, None), dead, 0.0, None,
                      fake["t"] - 0.001),
                     ("l", (10, None, None), live, 0.0, None, None)])
        assert live.result(timeout=30)
        with pytest.raises(DeadlineExceeded):
            dead.result(timeout=5)
        assert b.batch_sizes[-1] == 1     # only the live one dispatched
    finally:
        svc.close()


def test_queue_wait_p99_budget_sheds(store):
    svc = _service(store)
    try:
        # without the batcher there is no queue to budget against
        for _ in range(8):
            svc._m_queue_wait.observe(500.0)
        assert svc.search("q", k=10, deadline_ms=10.0)
        svc.start_batcher()
        with pytest.raises(DeadlineExceeded):
            svc.search("q", k=10, deadline_ms=10.0)
        ev = [e for e in svc.registry.events()
              if e["event"] == "deadline_shed"]
        assert ev[-1]["attrs"]["reason"] == "slo_budget"
        assert ev[-1]["attrs"]["queue_wait_p99_ms"] >= 10.0
        assert svc.search("q", k=10, deadline_ms=5000.0)
        assert svc.autoscale_signals()["queue_wait_p99_ms"] >= 500.0
    finally:
        svc.close()


def test_client_raises_on_remote_error_and_closed_server(store):
    svc = _service(store)
    srv = serve_in_background(svc)
    client = SocketSearchClient(srv.host, srv.port)
    try:
        with pytest.raises(RemoteError, match="shapes"):
            client.topk_vectors(np.zeros((1, DIM + 1), np.float32), k=3)
        assert client.topk_vectors(np.ones((1, DIM), np.float32), k=3)[1] \
            .shape == (1, 3)
    finally:
        client.close()
        srv.close()
        svc.close()


def test_client_connections_stay_bounded_by_live_threads(store):
    """A load trial's pool threads end after the trial; the client closes
    their connections when a new thread dials, so open sockets stay
    bounded by the live threads across many trials."""
    import threading
    svc = _service(store)
    srv = serve_in_background(svc)
    client = SocketSearchClient(srv.host, srv.port)
    qv = np.ones((1, DIM), np.float32)
    try:
        for _ in range(5):
            ts = [threading.Thread(target=client.topk_vectors, args=(qv,))
                  for _ in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
        client.topk_vectors(qv)            # this thread dials: a sweep
        assert len(client._conns) <= 1 + 4
        assert all(t.is_alive() for t, _ in client._conns)
    finally:
        client.close()
        srv.close()
        svc.close()
    assert client._conns == []


def test_concurrent_callers_lose_no_count(store):
    """More threads than cores on one service, direct and batched, with a
    short switch interval: every lookup lands in the cache counters and
    every request in serve.requests."""
    import sys
    import threading
    svc = _service(store, **{"serve.query_cache_size": 8})
    words = [f"w{i} x{i % 3}" for i in range(24)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def direct(t):
            for i in range(20):
                svc.search(words[(t + i) % len(words)], k=5)
        threads = [threading.Thread(target=direct, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        svc.start_batcher()
        threads = [threading.Thread(target=direct, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        svc.close()
    assert svc._m_requests.value == 2 * 16 * 20
    assert svc.cache_hits + svc.cache_misses == 2 * 16 * 20
    assert sum(svc.batch_sizes) == 16 * 20 and svc.batch_retries == 0
    assert len(svc._cache) <= 8
