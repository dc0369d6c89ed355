"""The asyncio socket front end over one SearchService: the port's copy of
the single-service part of the JAX package's infer/server.py.

A client connection sends `T_QUERY` (text) or `T_VQUERY` (raw query
vectors; `T_VQUERY_PUT` / `T_VQUERY_REF` when interned) frames and gets
back `T_RESULT` / `T_RESULT_C` (scores, ids, scan bytes), `T_SHED` (the
request was deliberately rejected at admission), or `T_ERROR`. Connection
handling runs on the host event loop; the device path is the service's.

Admission happens AT THE SOCKET, before a request can touch the
micro-batcher (`SearchService._admit`): a deadline that already expired,
or one the windowed queue-wait p99 says cannot be met, is answered with
`T_SHED` at once. It never takes queue capacity or a bucket slot, and it
counts in `serve.deadline_shed`, never in `serve.errors`. Requests that
admit carry their absolute deadline into the batcher, where the
micro-batch door sheds any that expire while queued.

Protocol robustness: a garbage header, an unknown frame type, or an
oversize length is REJECTED — one best-effort `T_ERROR` frame, then the
connection closes. Truncation mid-frame closes the connection.

Filtered queries: a QUERY or VQUERY frame may carry a predicate
(index/attrs.py); the server confirms FLAG_FILTERS in its HELLO when
``serve.filters`` is on and then serves them like the service does. With
it off, a filtered frame is answered with one `T_ERROR` and nothing is
admitted, as is a malformed predicate.

Tracing: every request runs under a root span opened at the socket
(`socket` span, protocol and query count attrs). The dispatch hops to an
executor thread with an explicit `tracer.use` hand-off, so the
micro-batcher's queue_wait and dispatch subtree hang under the socket
root.

A partitioned service (``serve.partitions`` / ``serve.replicas``,
infer/partition.py) serves here as it does in process: the front end
calls the service, and the service scatters each bucket to its partition
replicas, or over the wire to its partition workers once a
``WorkerGateway`` is attached (infer/partition_host.py).

The fleet result cache: with ``serve.result_cache`` and
``serve.result_cache_fleet`` the server confirms FLAG_RESULT_CACHE, and a
sibling front end's ``T_CACHE_LOOKUP`` is answered from the service's
generation-keyed cache (a hit as a RESULT frame, a miss as T_SHED with
SHED_CACHE_MISS; the probe admits and computes nothing), its
``T_CACHE_PUT`` filled into it with no answer (a stale one is dropped).

`front_end` is the server's index in a tier of several front ends over
one worker fleet (``cli loadtest --front-ends N``): its thread names and
the load generator's records carry it.
"""
from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from dnn_page_vectors_tpu_torch.infer import transport
from dnn_page_vectors_tpu_torch.index.attrs import (
    FilterError, compile_filters)
from dnn_page_vectors_tpu_torch.infer.transport import (
    DeadlineExceeded, FrameError, FLAG_FILTERS, FLAG_RESULT_CACHE,
    FLAG_WIRE_COMPRESS, T_CACHE_LOOKUP, T_CACHE_PUT, T_HELLO, T_QUERY,
    T_RESULT, T_RESULT_C, T_SHED, T_ERROR, T_VQUERY, T_VQUERY_PUT,
    T_VQUERY_REF)


def parse_listen(listen: str) -> Tuple[str, int]:
    """'host:port' -> (host, port); port 0 = ephemeral."""
    host, _, port = str(listen).rpartition(":")
    return host or "127.0.0.1", int(port or 0)


def _results_to_arrays(results: List[List[dict]], k: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Formatted per-query result lists -> fixed [n, k] score/id arrays
    (-1-id padding past each query's real hit count)."""
    n = len(results)
    scores = np.zeros((n, k), np.float32)
    ids = np.full((n, k), -1, np.int64)
    for qi, res in enumerate(results):
        for slot, hit in enumerate(res[:k]):
            scores[qi, slot] = hit["score"]
            ids[qi, slot] = hit["page_id"]
    return scores, ids


class SearchServer:
    """Asyncio front end over one `SearchService`. Run it on the caller's
    loop (`await start()`) or host it on a background thread
    (`start_background()` — the cli/loadgen shape; `close()` stops it)."""

    def __init__(self, svc, host: Optional[str] = None,
                 port: Optional[int] = None, executor_workers: int = 32,
                 front_end: int = 0):
        cfg_host, cfg_port = parse_listen(svc.cfg.serve.listen)
        self.svc = svc
        self.front_end = int(front_end)
        self.host = host if host is not None else cfg_host
        self.port = port if port is not None else cfg_port
        # serve.wire_compress gates what this end ADVERTISES: with it off
        # every connection negotiates down to the raw frames
        self._compress = bool(svc.cfg.serve.wire_compress)
        # serve.filters gates FLAG_FILTERS and whether a filtered frame is
        # served at all
        self._filters = bool(svc.cfg.serve.filters)
        # FLAG_RESULT_CACHE is confirmed only when the service runs the
        # fleet result cache
        self._rcache = bool(svc._rcache_fleet)
        self._executor = ThreadPoolExecutor(
            max_workers=executor_workers,
            thread_name_prefix=f"serve-socket-fe{self.front_end}")
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        # graceful-drain state, touched only on the event loop: close()
        # flips _draining, in-flight dispatches finish, fresh requests
        # shed with reason "draining" instead of dying mid-frame
        self._draining = False
        self._inflight = 0

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "SearchServer":
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.host, self.port = self._server.sockets[0].getsockname()[:2]
        return self

    def start_background(self) -> "SearchServer":
        """Host the server on its own event-loop thread; returns once the
        listener is bound (self.port carries the ephemeral port)."""
        started = threading.Event()
        failed: List[BaseException] = []

        def _run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            try:
                server = loop.run_until_complete(asyncio.start_server(
                    self._handle, self.host, self.port))
            except BaseException as e:  # noqa: BLE001 — surface bind errors
                failed.append(e)
                started.set()
                loop.close()
                return
            self._server = server
            self.host, self.port = server.sockets[0].getsockname()[:2]
            started.set()
            try:
                loop.run_forever()
            finally:
                server.close()
                loop.run_until_complete(server.wait_closed())
                loop.close()

        self._thread = threading.Thread(
            target=_run, daemon=True,
            name=f"serve-socket-loop-fe{self.front_end}")
        self._thread.start()
        started.wait()
        if failed:
            raise failed[0]
        return self

    def close(self, drain_s: float = 5.0) -> None:
        """Graceful shutdown: stop accepting, DRAIN in-flight requests —
        dispatches already on the executor finish and answer normally,
        fresh frames arriving on open connections shed with reason
        "draining" — then cancel the idle per-connection readers. A
        close never drops a socket mid-frame on a request the service
        already accepted; `drain_s` bounds how long a slow in-flight
        dispatch can hold the shutdown."""
        loop = self._loop
        if loop is not None and self._thread is not None:
            async def _shutdown() -> None:
                # stop accepting; flip draining BEFORE waiting so frames
                # that race the close get a clean SHED answer
                self._draining = True
                if self._server is not None:
                    self._server.close()
                t_end = loop.time() + max(drain_s, 0.0)
                while self._inflight > 0 and loop.time() < t_end:
                    await asyncio.sleep(0.005)
                # idle handler tasks (parked on client reads) cancel
                # last — a close must not leak destroyed-pending tasks
                tasks = [t for t in asyncio.all_tasks()
                         if t is not asyncio.current_task()]
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                # only now: wait_closed() waits for every connection to
                # close (Python 3.12), which the cancelled handlers do
                if self._server is not None:
                    await self._server.wait_closed()

            try:
                asyncio.run_coroutine_threadsafe(
                    _shutdown(), loop).result(timeout=drain_s + 10.0)
            except Exception:  # noqa: BLE001 — stop the loop regardless
                pass
            loop.call_soon_threadsafe(loop.stop)
            self._thread.join(timeout=10.0)
            self._thread = None
        self._executor.shutdown(wait=False)

    # -- per-connection handler -------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        svc = self.svc
        flags = 0           # negotiated capabilities (T_HELLO handshake)
        slots = None        # per-connection intern table (slot -> block)
        try:
            while True:
                frame = await transport.read_frame_async(reader)
                if frame is None:
                    break
                ftype, payload = frame
                actual = transport.HEADER.size + len(payload)
                svc._m_wire_bytes.inc(actual)
                svc._m_wire_raw.inc(actual)
                if ftype == T_HELLO:
                    want = transport.decode_hello(payload)
                    flags = want & ((FLAG_WIRE_COMPRESS if self._compress
                                     else 0)
                                    | (FLAG_RESULT_CACHE if self._rcache
                                       else 0)
                                    | (FLAG_FILTERS if self._filters else 0))
                    if flags & FLAG_WIRE_COMPRESS and slots is None:
                        slots = {}
                    await self._write(writer, T_HELLO,
                                      transport.encode_hello(flags))
                    continue
                if ftype == T_CACHE_LOOKUP and flags & FLAG_RESULT_CACHE:
                    # a probe: a hit answers from the cache (no admission,
                    # no bucket slot), a miss with SHED_CACHE_MISS
                    ck = transport.decode_cache_lookup(payload)
                    got = svc._result_cache_wire_get(ck)
                    if got is None:
                        await self._write(writer, T_SHED,
                                          transport.encode_shed(
                                              ck.req_id,
                                              transport.SHED_CACHE_MISS,
                                              "cache_miss"))
                    elif flags & FLAG_WIRE_COMPRESS:
                        await self._write(
                            writer, T_RESULT_C,
                            transport.encode_result_c(ck.req_id, got[0],
                                                      got[1]),
                            raw_len=transport.result_raw_bytes(
                                *got[0].shape))
                    else:
                        await self._write(writer, T_RESULT,
                                          transport.encode_result(
                                              ck.req_id, got[0], got[1]))
                    continue
                if ftype == T_CACHE_PUT and flags & FLAG_RESULT_CACHE:
                    # a fill with no answer frame; the service drops one of
                    # other generations
                    ck, pscores, pids = transport.decode_cache_put(payload)
                    svc._result_cache_wire_put(ck, pscores, pids)
                    continue
                if ftype in (T_QUERY, T_VQUERY, T_VQUERY_PUT, T_VQUERY_REF):
                    if self._draining:
                        # graceful drain: the request is readable (so
                        # the peer is not left mid-frame) but the
                        # service is going away — shed, don't serve
                        # every request head leads with the u64 req id
                        rid = (transport._ERROR_HEAD.unpack_from(payload)[0]
                               if len(payload) >= 8 else 0)
                        svc._shed_deadline("draining", None)
                        await self._write(writer, T_SHED,
                                          transport.encode_shed(
                                              rid, transport.SHED_DRAINING,
                                              "draining"))
                        continue
                    if ftype == T_QUERY:
                        req = transport.decode_query(payload)
                        await self._answer(writer, req, vectors=False,
                                           flags=flags)
                    else:
                        req = transport.decode_vquery_any(ftype, payload,
                                                          slots)
                        if ftype == T_VQUERY_REF:
                            # raw-equivalent accounting: this frame
                            # REPLACED a full query block on the wire
                            svc._m_wire_raw.inc(req.qv.nbytes
                                                - transport._SLOT.size)
                        await self._answer(writer, req, vectors=True,
                                           flags=flags)
                else:
                    await self._write(writer, T_ERROR, transport.encode_error(
                        0, f"unexpected frame type {ftype} on a client "
                           "connection"))
                    break
        except FrameError as e:
            # the reject path the fuzz tests pin: one best-effort error
            # frame, then the connection CLOSES — never a hung peer
            try:
                await self._write(writer, T_ERROR,
                                  transport.encode_error(0, str(e)))
            except (ConnectionError, OSError):
                pass
        except asyncio.CancelledError:
            pass                  # server shutdown cancels idle handlers
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (asyncio.CancelledError, ConnectionError, OSError):
                pass

    async def _write(self, writer: asyncio.StreamWriter, ftype: int,
                     payload: bytes, raw_len: Optional[int] = None) -> None:
        frame = transport.pack_frame(ftype, payload)
        writer.write(frame)
        self.svc._m_wire_bytes.inc(len(frame))
        self.svc._m_wire_raw.inc(len(frame) if raw_len is None else raw_len)
        await writer.drain()

    async def _answer(self, writer: asyncio.StreamWriter, req,
                      vectors: bool, flags: int = 0) -> None:
        svc = self.svc
        n = req.qv.shape[0] if vectors else len(req.queries)
        k = req.k or svc.cfg.eval.recall_k
        nprobe = req.nprobe or None
        loop = asyncio.get_running_loop()
        # the span tree starts AT THE SOCKET: the executor hop below
        # re-activates this root on the dispatch thread, so the batcher's
        # captured context (queue_wait + the shared dispatch subtree)
        # hangs under it
        with svc.tracer.trace("socket",
                              protocol="vquery" if vectors else "query",
                              n_queries=n, k=k) as root:
            deadline = svc.default_deadline(
                req.deadline_ms if req.deadline_ms > 0 else None)
            # in-flight covers the ANSWER write too: a graceful drain
            # waits until the response frame left, never mid-write
            self._inflight += 1
            try:
                try:
                    scores, ids, scan = await loop.run_in_executor(
                        self._executor,
                        lambda: self._dispatch_blocking(root, req, vectors,
                                                        n, k, nprobe,
                                                        deadline))
                except DeadlineExceeded as e:
                    await self._write(writer, T_SHED, transport.encode_shed(
                        req.req_id, transport.SHED_DEADLINE, str(e)))
                    return
                except Exception as e:  # noqa: BLE001 — per-request
                    # isolation
                    await self._write(writer, T_ERROR,
                                      transport.encode_error(
                                          req.req_id,
                                          f"{type(e).__name__}: {e}"))
                    return
                if flags & FLAG_WIRE_COMPRESS:
                    await self._write(
                        writer, T_RESULT_C,
                        transport.encode_result_c(req.req_id, scores, ids,
                                                  scan_bytes=scan),
                        raw_len=transport.result_raw_bytes(*scores.shape))
                else:
                    await self._write(writer, T_RESULT,
                                      transport.encode_result(
                                          req.req_id, scores, ids,
                                          scan_bytes=scan))
            finally:
                self._inflight -= 1

    def _dispatch_blocking(self, root, req, vectors: bool, n: int, k: int,
                           nprobe: Optional[int],
                           deadline: Optional[float]):
        """The blocking half, on an executor thread: admission, then the
        batcher (single text query) or a direct dispatch; records the
        request into the windowed serving instruments exactly once."""
        svc = self.svc
        with svc.tracer.use(root):
            # the frame's predicate compiled once (its canonical form); a
            # malformed one, or any with serve.filters off, raises here:
            # one T_ERROR answer, nothing admitted
            if req.filters and not self._filters:
                raise FilterError("this server does not serve filtered "
                                  "queries (serve.filters is off)")
            pred = compile_filters(req.filters)
            # result-cache probe before admission: a repeated text query
            # answers before _admit can shed it or a bucket slot is taken
            if not vectors and n == 1:
                rkey = svc._result_cache_key(req.queries[0], req.k or None,
                                             nprobe, filters=pred)
                if rkey is not None:
                    t0 = time.perf_counter()
                    hits = svc._result_cache_get(rkey, count=False)
                    if hits is None:
                        hits = svc._peer_lookup(rkey)
                    if hits is not None:
                        svc._m_rcache_hits.inc()
                        svc._m_requests.inc()
                        svc._m_latency.observe(
                            (time.perf_counter() - t0) * 1000.0)
                        scores, ids = _results_to_arrays([hits], k)
                        return scores, ids, 0
                    svc._m_rcache_misses.inc()
            # admission control at the door (raises DeadlineExceeded;
            # already counted + evented by _admit)
            svc._admit(deadline)
            t0 = time.perf_counter()
            try:
                if vectors:
                    out = svc.topk_vectors(req.qv, k=k, nprobe=nprobe,
                                           deadline=deadline, filters=pred)
                    scores, ids = out[0], out[1]
                    scan = int(out[2]) if len(out) > 2 else 0
                elif svc._batcher is not None and n == 1:
                    res = [svc._batcher.submit(
                        req.queries[0], req.k or None, nprobe,
                        deadline=deadline,
                        filters=None if pred is None
                        else pred.text).result()]
                    scores, ids = _results_to_arrays(res, k)
                    scan = 0
                else:
                    res = svc.search_many(list(req.queries),
                                          k=req.k or None, nprobe=nprobe,
                                          filters=pred, _record=False,
                                          deadline=deadline)
                    scores, ids = _results_to_arrays(res, k)
                    scan = 0
            except DeadlineExceeded:
                # shed at the micro-batch door: counted there, not an
                # error
                raise
            except BaseException:
                svc._m_errors.inc(n)
                raise
            svc._m_requests.inc(n)
            svc._m_latency.observe((time.perf_counter() - t0) * 1000.0, n=n)
            return scores, ids, scan


def serve_in_background(svc, host: Optional[str] = None,
                        port: Optional[int] = None,
                        front_end: int = 0) -> SearchServer:
    """One-call server hosting for the CLI, the load generator and the
    tests: binds (serve.listen unless overridden), runs the loop on a
    daemon thread, returns the handle (`.host` / `.port` / `.close()`).
    `front_end` is its index in a tier of several front ends."""
    return SearchServer(svc, host=host, port=port,
                        front_end=front_end).start_background()
