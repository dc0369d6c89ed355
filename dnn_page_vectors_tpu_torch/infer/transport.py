"""The serving wire protocol: the port's copy of the JAX package's
infer/transport.py, byte for byte the same frames, so a JAX peer and a
port peer read each other.

One length-prefixed binary framing for every socket of the serving fleet:
the client edge of the socket front end (`infer/server.py`: text or
vector queries in, scores and page ids out) and the partition RPC hop
(`infer/partition_host.py`: query vectors fanned out to partition
workers). Binary because the hot payloads are arrays: raw little-endian array
bytes round-trip exactly, so socket results equal the in-process ones
bit for bit.

Frame layout (9-byte header, network byte order):

    +--------+--------+----------------+=================+
    | magic  | type   | payload length |  payload bytes  |
    | u32    | u8     | u32            |  (type-specific)|
    +--------+--------+----------------+=================+

`magic` (0x44505631, "DPV1") carries the protocol version; a reader that
sees anything else is talking to the wrong peer (or a corrupted stream)
and REJECTS: it closes the connection rather than resynchronize.
`payload length` is bounded by MAX_FRAME (64 MiB): an oversize length is
rejected BEFORE any payload read, so a garbage header can never park a
connection in a multi-gigabyte recv. Truncation (EOF mid-frame) raises
`FrameError`.

Message types (the numbers are the JAX package's):

    T_QUERY      client -> front end: text queries + k/nprobe/deadline
    T_VQUERY     client -> front end: an fp32 query block + k/nprobe/deadline
    T_RESULT     scores [n, k] f32 + page ids [n, k] i64 + scan bytes
    T_SHED       admission rejection (deadline) — NOT an error
    T_ERROR      server-side failure, message attached
    T_RESULT_C   a RESULT whose id block is zigzag-delta+varint encoded per
                 row; scores stay raw f32 (lossless)
    T_VQUERY_PUT a VQUERY that also interns its query block into a
                 sender-chosen per-connection slot
    T_VQUERY_REF a VQUERY referencing a previously PUT slot
    T_HELLO      capability exchange: the client advertises flags, the
                 server answers with the agreed intersection
    T_REGISTER   partition worker hello: (partition, replica, pid
                 [, flags, store generation])
    T_HEARTBEAT  worker liveness tick (empty payload)
    T_BYE        clean deregistration (empty payload)
    T_REFRESH    control: re-open the store and rebuild the view (the
                 target store generation, and in the extended form the
                 partition-split width of an elastic re-split); the worker
                 acks with its own T_REFRESH of what it now serves
    T_DRAIN      a worker announces it is draining (empty payload)
    T_CACHE_LOOKUP  a result-cache probe by the generation-qualified key; a
                 hit answers T_RESULT / T_RESULT_C, a miss T_SHED with
                 SHED_CACHE_MISS
    T_CACHE_PUT  one computed result row shared into a peer's cache; no
                 response frame (the receiver drops a stale entry)

Negotiation: capability flags are advertised by the connecting peer (a
worker in its REGISTER, a client in a leading T_HELLO) and confirmed by
the accepting side with a T_HELLO carrying the agreed intersection.
Nobody sends a compressed, interned, cache or filtered frame a peer did
not advertise, so raw and compressing peers interoperate.

Wire faults: ``read_frame``, ``write_frame`` and ``FrameSender.send``
consult the active fault plan (utils/faults.py) under an op name
(``wire_send``, ``wire_recv``, ``cache_peer_send``); a delay stalls the
frame, a dup sends it twice, a truncation or a drop tears the stream and
raises ``InjectedFault`` (an OSError), so the callers' recovery paths run
unchanged. With no plan installed the check is a dict lookup.

Deadlines travel as RELATIVE remaining milliseconds: the two ends of a
socket do not share a clock, and a relative budget re-anchors on the
receiver's monotonic clock at receipt.

T_QUERY and every T_VQUERY variant accept one OPTIONAL trailing field, a
u16 length + the canonical filter predicate text; an unfiltered frame
carries none. The codecs read and write it as the JAX package does. A
peer sends it only after the other end confirmed FLAG_FILTERS in the
HELLO exchange (the client raises otherwise rather than let an
unfiltered answer pass for a filtered one).
"""
from __future__ import annotations

import asyncio
import itertools
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dnn_page_vectors_tpu_torch.utils import faults
from dnn_page_vectors_tpu_torch.utils.faults import InjectedFault

MAGIC = 0x44505631            # "DPV1": protocol id + version in one word
MAX_FRAME = 64 * 2 ** 20      # reject oversize lengths before any recv

HEADER = struct.Struct("!IBI")            # magic, type, payload length

T_QUERY = 1
T_VQUERY = 2
T_RESULT = 3
T_SHED = 4
T_ERROR = 5
T_REGISTER = 6
T_HEARTBEAT = 7
T_BYE = 8
T_RESULT_C = 9                # compressed RESULT (varint id block)
T_VQUERY_PUT = 10             # VQUERY + intern block into a cache slot
T_VQUERY_REF = 11             # VQUERY referencing an interned slot
T_HELLO = 12                  # capability exchange (flags byte)
T_REFRESH = 13                # view-refresh control / generation ack
T_CACHE_LOOKUP = 14           # result-cache probe (key -> RESULT / miss)
T_CACHE_PUT = 15              # result-cache share (key + one result row)
T_DRAIN = 16                  # worker drain announcement (empty payload)

_TYPES = {T_QUERY, T_VQUERY, T_RESULT, T_SHED, T_ERROR, T_REGISTER,
          T_HEARTBEAT, T_BYE, T_RESULT_C, T_VQUERY_PUT, T_VQUERY_REF,
          T_HELLO, T_REFRESH, T_CACHE_LOOKUP, T_CACHE_PUT, T_DRAIN}

# capability flags (REGISTER / HELLO negotiation)
FLAG_WIRE_COMPRESS = 0x01     # peer speaks T_RESULT_C + T_VQUERY_PUT/REF
FLAG_RESULT_CACHE = 0x02      # peer speaks the fleet result-cache frames
FLAG_FILTERS = 0x04           # peer accepts the QUERY/VQUERY filter field

# per-connection intern table size: a protocol constant, so the sender's
# slot assignment (a ring over these slots) and the receiver's passive
# slot store can never disagree about capacity
WIRE_SLOTS = 64

# shed reason codes (T_SHED payload)
SHED_DEADLINE = 1             # deadline expired / cannot be met
SHED_QUEUE = 2                # admission queue budget exceeded
SHED_DRAINING = 3             # front end shutting down (graceful drain)
SHED_CACHE_MISS = 4           # T_CACHE_LOOKUP probe missed (not an error)

_QUERY_HEAD = struct.Struct("!QdiiH")     # req id, deadline ms, k, nprobe, nq
_VQUERY_HEAD = struct.Struct("!QdiiHH")   # ... + n, dim
_RESULT_HEAD = struct.Struct("!QQHH")     # req id, scan bytes, n, k
_SHED_HEAD = struct.Struct("!QB")         # req id, reason code
_ERROR_HEAD = struct.Struct("!Q")         # req id
_SLOT = struct.Struct("!H")               # intern slot id
_HELLO_HEAD = struct.Struct("!B")         # capability flags
_REGISTER_HEAD = struct.Struct("!IIQ")    # partition, replica, pid (legacy)
_REGISTER_HEAD2 = struct.Struct("!IIQBQ")  # ... + flags, store generation
_REFRESH_HEAD = struct.Struct("!Q")       # store generation (legacy)
_REFRESH_HEAD2 = struct.Struct("!QI")     # ... + partition-split width
# result-cache key head: req id, k, nprobe, store generation (the model
# stamp in its high 32 bits, as the service keys it), index generation
# (-1: the view serves without an index), text length
_CACHE_HEAD = struct.Struct("!QiiQqH")

_REQ_IDS = itertools.count(1)


def next_request_id() -> int:
    return next(_REQ_IDS)


class FrameError(ValueError):
    """The stream is not speaking this protocol (bad magic/type), the
    frame is oversize, or it was truncated mid-read. The only safe
    response is to reject: answer nothing further and close."""


class DeadlineExceeded(RuntimeError):
    """A request was shed at admission (or at the micro-batch door)
    because its deadline had expired or could not be met. A shed is a
    deliberate availability decision, not a server error — it counts in
    `serve.deadline_shed`, never in `serve.errors`."""


class RemoteError(RuntimeError):
    """The remote end answered T_ERROR: the failure happened there."""


# ---------------------------------------------------------------------------
# payload codecs (pure functions of bytes — the fuzz-test surface)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QueryRequest:
    req_id: int
    deadline_ms: float            # remaining budget; <= 0 means none
    k: int                        # 0 means the server default
    nprobe: int                   # 0 means the server default
    queries: Tuple[str, ...]
    filters: Optional[str] = None  # canonical predicate text; None = all


@dataclass(frozen=True)
class VectorRequest:
    req_id: int
    deadline_ms: float
    k: int
    nprobe: int
    qv: np.ndarray                # [n, dim] float32
    filters: Optional[str] = None  # canonical predicate text; None = all


def _filters_field(filters: Optional[str]) -> bytes:
    """The optional trailing predicate field: u16 length + canonical
    text. None encodes as NO bytes at all — an unfiltered frame is
    byte-identical to the pre-filters protocol."""
    if filters is None:
        return b""
    raw = filters.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise ValueError("filter text exceeds 65535 utf-8 bytes")
    return struct.pack("!H", len(raw)) + raw


def _take_filters(payload: bytes, off: int,
                  what: str) -> Tuple[Optional[str], int]:
    """Parse the optional trailing predicate field at `off`: absent
    (frame ends exactly there) -> (None, off); present -> (text, end).
    Truncation inside the field REJECTS — a frame either carries the
    whole field or none of it."""
    if off == len(payload):
        return None, off
    if off + 2 > len(payload):
        raise FrameError(f"{what} truncated inside the filter length")
    (ln,) = struct.unpack_from("!H", payload, off)
    off += 2
    if off + ln > len(payload):
        raise FrameError(f"{what} truncated inside the filter text")
    try:
        text = payload[off: off + ln].decode("utf-8")
    except UnicodeDecodeError as e:
        raise FrameError(f"{what} filter text is not utf-8: {e}") from None
    return text, off + ln


def encode_query(req_id: int, queries: Sequence[str], k: int = 0,
                 nprobe: int = 0, deadline_ms: float = 0.0,
                 filters: Optional[str] = None) -> bytes:
    if not 0 < len(queries) <= 0xFFFF:
        raise ValueError(f"1..65535 queries per frame, got {len(queries)}")
    parts = [_QUERY_HEAD.pack(req_id, float(deadline_ms), int(k),
                              int(nprobe), len(queries))]
    for q in queries:
        raw = q.encode("utf-8")
        if len(raw) > 0xFFFF:
            raise ValueError("query text exceeds 65535 utf-8 bytes")
        parts.append(struct.pack("!H", len(raw)))
        parts.append(raw)
    parts.append(_filters_field(filters))
    return b"".join(parts)


def decode_query(payload: bytes) -> QueryRequest:
    if len(payload) < _QUERY_HEAD.size:
        raise FrameError("query frame shorter than its fixed header")
    req_id, deadline_ms, k, nprobe, nq = _QUERY_HEAD.unpack_from(payload)
    off = _QUERY_HEAD.size
    queries: List[str] = []
    for _ in range(nq):
        if off + 2 > len(payload):
            raise FrameError("query frame truncated inside a length prefix")
        (ln,) = struct.unpack_from("!H", payload, off)
        off += 2
        if off + ln > len(payload):
            raise FrameError("query frame truncated inside a query string")
        try:
            queries.append(payload[off: off + ln].decode("utf-8"))
        except UnicodeDecodeError as e:
            raise FrameError(f"query text is not utf-8: {e}") from None
        off += ln
    filters, off = _take_filters(payload, off, "query frame")
    if off != len(payload):
        raise FrameError(f"{len(payload) - off} trailing bytes after the "
                         "last query")
    return QueryRequest(req_id, deadline_ms, k, nprobe, tuple(queries),
                        filters)


def encode_vquery(req_id: int, qv: np.ndarray, k: int = 0, nprobe: int = 0,
                  deadline_ms: float = 0.0,
                  filters: Optional[str] = None) -> bytes:
    qv = np.ascontiguousarray(qv, dtype="<f4")
    if qv.ndim != 2 or not 0 < qv.shape[0] <= 0xFFFF \
            or not 0 < qv.shape[1] <= 0xFFFF:
        raise ValueError(f"query block must be [1..65535, 1..65535], "
                         f"got {qv.shape}")
    return (_VQUERY_HEAD.pack(req_id, float(deadline_ms), int(k),
                              int(nprobe), qv.shape[0], qv.shape[1])
            + qv.tobytes() + _filters_field(filters))


def _block_to_qv(block, n: int, dim: int, what: str) -> np.ndarray:
    """A raw little-endian f32 block -> [n, dim] array WITHOUT copying:
    np.frombuffer aliases the (immutable) payload bytes, so the decode
    does not duplicate a block it immediately re-slices. The result is
    read-only; every consumer copies at its own boundary
    (device staging, np.concatenate padding)."""
    want = n * dim * 4
    if len(block) != want:
        raise FrameError(f"{what} carries {len(block)} bytes for a "
                         f"[{n}, {dim}] f32 matrix ({want} expected)")
    if n == 0 or dim == 0:
        raise FrameError(f"{what} is empty")
    return np.frombuffer(block, dtype="<f4").reshape(n, dim)


def decode_vquery(payload: bytes) -> VectorRequest:
    if len(payload) < _VQUERY_HEAD.size:
        raise FrameError("vquery frame shorter than its fixed header")
    req_id, deadline_ms, k, nprobe, n, dim = _VQUERY_HEAD.unpack_from(payload)
    cut = _VQUERY_HEAD.size + n * dim * 4
    if len(payload) < cut:
        raise FrameError(f"vquery block carries "
                         f"{len(payload) - _VQUERY_HEAD.size} bytes for a "
                         f"[{n}, {dim}] f32 matrix ({n * dim * 4} expected)")
    qv = _block_to_qv(memoryview(payload)[_VQUERY_HEAD.size: cut], n, dim,
                      "vquery block")
    filters, off = _take_filters(payload, cut, "vquery frame")
    if off != len(payload):
        raise FrameError(f"{len(payload) - off} trailing bytes after a "
                         "vquery filter field")
    return VectorRequest(req_id, deadline_ms, k, nprobe, qv, filters)


def encode_vquery_put(req_id: int, slot: int, block: bytes, n: int,
                      dim: int, k: int = 0, nprobe: int = 0,
                      deadline_ms: float = 0.0,
                      filters: Optional[str] = None) -> bytes:
    """A VQUERY that also interns its (already encoded) query block into
    the receiver's per-connection cache slot `slot`. The filter field
    (present only when `filters` is not None) is PER REQUEST — it rides
    after the block and is never interned with it."""
    return (_VQUERY_HEAD.pack(req_id, float(deadline_ms), int(k),
                              int(nprobe), n, dim)
            + _SLOT.pack(slot) + block + _filters_field(filters))


def encode_vquery_ref(req_id: int, slot: int, n: int, dim: int,
                      k: int = 0, nprobe: int = 0,
                      deadline_ms: float = 0.0,
                      filters: Optional[str] = None) -> bytes:
    """A VQUERY whose block was interned earlier on this connection: the
    per-request head plus a 2-byte slot id instead of n*dim*4 raw f32."""
    return (_VQUERY_HEAD.pack(req_id, float(deadline_ms), int(k),
                              int(nprobe), n, dim) + _SLOT.pack(slot)
            + _filters_field(filters))


def decode_vquery_any(ftype: int, payload: bytes,
                      slots: Optional[Dict[int, bytes]] = None
                      ) -> VectorRequest:
    """Decode T_VQUERY / T_VQUERY_PUT / T_VQUERY_REF. `slots` is the
    receiver's per-connection intern table: PUT stores its block there
    (a stable bytes copy — the slot outlives this frame), REF resolves
    against it. A REF to a slot never PUT on this connection is a
    protocol violation -> FrameError (the sender controls slot reuse, so
    the two tables can only disagree if the peer is broken)."""
    if ftype == T_VQUERY:
        return decode_vquery(payload)
    if len(payload) < _VQUERY_HEAD.size + _SLOT.size:
        raise FrameError("interned vquery frame shorter than its header")
    req_id, deadline_ms, k, nprobe, n, dim = _VQUERY_HEAD.unpack_from(payload)
    (slot,) = _SLOT.unpack_from(payload, _VQUERY_HEAD.size)
    if slot >= WIRE_SLOTS:
        raise FrameError(f"intern slot {slot} out of range "
                         f"(WIRE_SLOTS {WIRE_SLOTS})")
    if slots is None:
        raise FrameError("interned vquery on a connection that never "
                         "negotiated compression")
    off = _VQUERY_HEAD.size + _SLOT.size
    if ftype == T_VQUERY_PUT:
        cut = off + n * dim * 4
        if len(payload) < cut:
            raise FrameError(f"interned vquery block carries "
                             f"{len(payload) - off} bytes for a "
                             f"[{n}, {dim}] f32 matrix "
                             f"({n * dim * 4} expected)")
        block = bytes(memoryview(payload)[off: cut])
        qv = _block_to_qv(block, n, dim, "interned vquery block")
        filters, end = _take_filters(payload, cut, "interned vquery frame")
        if end != len(payload):
            raise FrameError(f"{len(payload) - end} trailing bytes after "
                             "an interned vquery filter field")
        slots[slot] = block
        return VectorRequest(req_id, deadline_ms, k, nprobe, qv, filters)
    if ftype != T_VQUERY_REF:
        # the explicit REF branch (not a fall-through): a future vquery
        # variant routed here by mistake must REJECT, not silently parse
        # as a slot reference
        raise FrameError(f"frame type {ftype} is not a vquery")
    filters, end = _take_filters(payload, off, "vquery slot reference")
    if end != len(payload):
        raise FrameError(f"{len(payload) - end} trailing bytes after a "
                         "vquery slot reference")
    block = slots.get(slot)
    if block is None:
        raise FrameError(f"vquery references empty intern slot {slot}")
    qv = _block_to_qv(block, n, dim, "interned vquery block")
    return VectorRequest(req_id, deadline_ms, k, nprobe, qv, filters)


def encode_result(req_id: int, scores: np.ndarray, ids: np.ndarray,
                  scan_bytes: int = 0) -> bytes:
    scores = np.ascontiguousarray(scores, dtype="<f4")
    ids = np.ascontiguousarray(ids, dtype="<i8")
    if scores.shape != ids.shape or scores.ndim != 2:
        raise ValueError(f"scores {scores.shape} / ids {ids.shape} must be "
                         "matching [n, k]")
    n, k = scores.shape
    return (_RESULT_HEAD.pack(req_id, int(scan_bytes), n, k)
            + scores.tobytes() + ids.tobytes())


def decode_result(payload: bytes
                  ) -> Tuple[int, np.ndarray, np.ndarray, int]:
    """-> (req_id, scores [n, k] f32, ids [n, k] i64, scan_bytes).
    Zero-copy: both arrays alias the (immutable) payload bytes via
    np.frombuffer at an offset — no slice copy, no astype copy."""
    if len(payload) < _RESULT_HEAD.size:
        raise FrameError("result frame shorter than its fixed header")
    req_id, scan_bytes, n, k = _RESULT_HEAD.unpack_from(payload)
    body_len = len(payload) - _RESULT_HEAD.size
    want = n * k * (4 + 8)
    if body_len != want:
        raise FrameError(f"result block carries {body_len} bytes for "
                         f"[{n}, {k}] scores+ids ({want} expected)")
    scores = np.frombuffer(payload, dtype="<f4", count=n * k,
                           offset=_RESULT_HEAD.size).reshape(n, k)
    ids = np.frombuffer(payload, dtype="<i8", count=n * k,
                        offset=_RESULT_HEAD.size + n * k * 4).reshape(n, k)
    return req_id, scores, ids, int(scan_bytes)


# -- varints (the compressed RESULT id block) -------------------------------
#
# LEB128 with a 10-byte cap (enough for any 64-bit zigzag delta — even
# the worst case, -1 next to 2^63-1, fits 65 bits = 10 septets). The cap
# is what makes adversarial continuation bytes REJECT instead of parsing
# unboundedly.

_VARINT_MAX_BYTES = 10


def _append_uvarint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _read_uvarint(payload, off: int) -> Tuple[int, int]:
    """-> (value, next offset); FrameError on truncation mid-varint or a
    continuation run past the 10-byte cap."""
    v = 0
    shift = 0
    end = len(payload)
    for i in range(_VARINT_MAX_BYTES):
        if off >= end:
            raise FrameError("stream truncated inside a varint")
        b = payload[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, off
        shift += 7
    raise FrameError(f"varint longer than {_VARINT_MAX_BYTES} bytes "
                     "(unterminated continuation run)")


_I64_MIN, _I64_MAX = -(2 ** 63), 2 ** 63 - 1


def _encode_ids_compressed(ids: np.ndarray) -> bytearray:
    """[n, k] int64 page ids -> per-row zigzag-delta varint block. Rows
    restart their delta chain (prev = 0), so one row's ids stay
    independently decodable and a result row full of -1 padding costs
    one byte per slot. Top-k ids are draws from a bounded id space, so
    deltas carry ~log2(store rows) bits instead of 64 — the ~3x cut."""
    out = bytearray()
    for row in ids:
        prev = 0
        for v in row:
            d = int(v) - prev
            prev = int(v)
            # zigzag over plain python ints: 2d for d >= 0, -2d-1 below
            _append_uvarint(out, d << 1 if d >= 0 else (d << 1) ^ -1)
    return out


def _decode_ids_compressed(payload, off: int, n: int, k: int) -> np.ndarray:
    ids = np.empty((n, k), np.int64)
    for r in range(n):
        prev = 0
        row = ids[r]
        for c in range(k):
            zz, off = _read_uvarint(payload, off)
            d = (zz >> 1) ^ -(zz & 1)
            prev += d
            if not _I64_MIN <= prev <= _I64_MAX:
                raise FrameError(f"compressed id delta overflows int64 "
                                 f"(row {r}, col {c})")
            row[c] = prev
    if off != len(payload):
        raise FrameError(f"{len(payload) - off} trailing bytes after the "
                         "compressed id block")
    return ids


def encode_result_c(req_id: int, scores: np.ndarray, ids: np.ndarray,
                    scan_bytes: int = 0) -> bytes:
    """The compressed RESULT payload: same fixed head, raw little-endian
    f32 scores (lossless — the byte-identity pins hold unchanged), then
    the zigzag-delta varint id block."""
    scores = np.ascontiguousarray(scores, dtype="<f4")
    ids = np.ascontiguousarray(ids, dtype="<i8")
    if scores.shape != ids.shape or scores.ndim != 2:
        raise ValueError(f"scores {scores.shape} / ids {ids.shape} must be "
                         "matching [n, k]")
    n, k = scores.shape
    return (_RESULT_HEAD.pack(req_id, int(scan_bytes), n, k)
            + scores.tobytes() + bytes(_encode_ids_compressed(ids)))


def decode_result_c(payload: bytes
                    ) -> Tuple[int, np.ndarray, np.ndarray, int]:
    """-> (req_id, scores [n, k] f32, ids [n, k] i64, scan_bytes); the
    scores alias the payload (zero-copy), the ids materialize out of the
    varint block. Truncation anywhere — inside the score block, mid-
    varint, or short of n*k ids — and trailing bytes all REJECT."""
    if len(payload) < _RESULT_HEAD.size:
        raise FrameError("result frame shorter than its fixed header")
    req_id, scan_bytes, n, k = _RESULT_HEAD.unpack_from(payload)
    cut = _RESULT_HEAD.size + n * k * 4
    if len(payload) < cut:
        raise FrameError(f"compressed result truncated inside the score "
                         f"block ({len(payload) - _RESULT_HEAD.size}/"
                         f"{n * k * 4} bytes)")
    scores = np.frombuffer(payload, dtype="<f4", count=n * k,
                           offset=_RESULT_HEAD.size).reshape(n, k)
    ids = _decode_ids_compressed(payload, cut, n, k)
    return req_id, scores, ids, int(scan_bytes)


def decode_result_any(ftype: int, payload: bytes
                      ) -> Tuple[int, np.ndarray, np.ndarray, int]:
    """Raw or compressed RESULT, by frame type — receivers accept both
    unconditionally (negotiation only governs what a peer SENDS)."""
    if ftype == T_RESULT_C:
        return decode_result_c(payload)
    return decode_result(payload)


def result_raw_bytes(n: int, k: int) -> int:
    """What a [n, k] RESULT costs as a raw frame (header included) — the
    raw-equivalent side of the wire-compression accounting."""
    return HEADER.size + _RESULT_HEAD.size + n * k * (4 + 8)


def encode_shed(req_id: int, code: int, reason: str) -> bytes:
    return _SHED_HEAD.pack(req_id, code) + reason.encode("utf-8")[:512]


def decode_shed(payload: bytes) -> Tuple[int, int, str]:
    if len(payload) < _SHED_HEAD.size:
        raise FrameError("shed frame shorter than its fixed header")
    req_id, code = _SHED_HEAD.unpack_from(payload)
    return req_id, code, payload[_SHED_HEAD.size:].decode(
        "utf-8", errors="replace")


def encode_error(req_id: int, message: str) -> bytes:
    return _ERROR_HEAD.pack(req_id) + message.encode("utf-8")[:2048]


def decode_error(payload: bytes) -> Tuple[int, str]:
    if len(payload) < _ERROR_HEAD.size:
        raise FrameError("error frame shorter than its fixed header")
    (req_id,) = _ERROR_HEAD.unpack_from(payload)
    return req_id, payload[_ERROR_HEAD.size:].decode(
        "utf-8", errors="replace")


def encode_hello(flags: int) -> bytes:
    return _HELLO_HEAD.pack(flags & 0xFF)


def decode_hello(payload: bytes) -> int:
    if len(payload) != _HELLO_HEAD.size:
        raise FrameError("hello frame has the wrong size")
    return _HELLO_HEAD.unpack(payload)[0]


def encode_register(partition: int, replica: int, pid: int,
                    flags: int = 0, generation: int = 0) -> bytes:
    """Worker hello. `flags` advertises capabilities (used only once the
    gateway confirms them in a T_HELLO); `generation` is the store
    generation the worker's view serves: the gateway routes around a
    worker whose generation lags the front end's until a T_REFRESH ack
    catches it up."""
    return _REGISTER_HEAD2.pack(partition, replica, pid, flags, generation)


def decode_register(payload: bytes) -> Tuple[int, int, int, int, int]:
    """-> (partition, replica, pid, flags, generation). Accepts the legacy
    16-byte form (flags 0, generation 0) beside the extended one."""
    if len(payload) == _REGISTER_HEAD.size:
        partition, replica, pid = _REGISTER_HEAD.unpack(payload)
        return partition, replica, pid, 0, 0
    if len(payload) != _REGISTER_HEAD2.size:
        raise FrameError("register frame has the wrong size")
    return _REGISTER_HEAD2.unpack(payload)


def encode_refresh(generation: int, partitions: int = 0) -> bytes:
    """Refresh control / ack. `partitions` > 0 ships the extended form
    with the fleet's partition-split width (an elastic re-split); 0 keeps
    the legacy 8-byte frame."""
    if partitions > 0:
        return _REFRESH_HEAD2.pack(int(generation), int(partitions))
    return _REFRESH_HEAD.pack(int(generation))


def decode_refresh(payload: bytes) -> Tuple[int, int]:
    """-> (generation, partitions); the legacy 8-byte form reports
    partitions 0 (keep the current split)."""
    if len(payload) == _REFRESH_HEAD.size:
        return _REFRESH_HEAD.unpack(payload)[0], 0
    if len(payload) == _REFRESH_HEAD2.size:
        gen, parts = _REFRESH_HEAD2.unpack(payload)
        return gen, parts
    raise FrameError("refresh frame has the wrong size")


# -- the fleet result cache ---------------------------------------------------

@dataclass(frozen=True)
class CacheKey:
    """The generation-qualified result-cache key as it travels the wire:
    the service's key tuple, so a LOOKUP on one front end addresses the
    entry a PUT from another created."""
    req_id: int
    k: int
    nprobe: int               # 0 = the server default
    store_gen: int
    index_gen: int            # -1 = the view serves without an index
    query: str                # whitespace-normalized text


def _encode_cache_key(req_id: int, query: str, k: int, nprobe: int,
                      store_gen: int, index_gen: int) -> bytes:
    raw = query.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise ValueError("cache-key query text exceeds 65535 utf-8 bytes")
    return _CACHE_HEAD.pack(req_id, int(k), int(nprobe), int(store_gen),
                            int(index_gen), len(raw)) + raw


def _decode_cache_key(payload: bytes, what: str) -> Tuple[CacheKey, int]:
    """-> (key, offset past the key); FrameError on truncation."""
    if len(payload) < _CACHE_HEAD.size:
        raise FrameError(f"{what} frame shorter than its fixed header")
    req_id, k, nprobe, sgen, igen, ln = _CACHE_HEAD.unpack_from(payload)
    off = _CACHE_HEAD.size
    if off + ln > len(payload):
        raise FrameError(f"{what} frame truncated inside the query text")
    try:
        query = payload[off: off + ln].decode("utf-8")
    except UnicodeDecodeError as e:
        raise FrameError(f"{what} query text is not utf-8: {e}") from None
    return CacheKey(req_id, k, nprobe, sgen, igen, query), off + ln


def encode_cache_lookup(req_id: int, query: str, k: int, nprobe: int,
                        store_gen: int, index_gen: int) -> bytes:
    return _encode_cache_key(req_id, query, k, nprobe, store_gen, index_gen)


def decode_cache_lookup(payload: bytes) -> CacheKey:
    key, off = _decode_cache_key(payload, "cache lookup")
    if off != len(payload):
        raise FrameError(f"{len(payload) - off} trailing bytes after a "
                         "cache-lookup key")
    return key


def encode_cache_put(req_id: int, query: str, k: int, nprobe: int,
                     store_gen: int, index_gen: int, scores: np.ndarray,
                     ids: np.ndarray) -> bytes:
    """One computed result row for the key: scores [k] f32 + ids [k] i64,
    -1-id padded past the real hit count (a RESULT frame's convention)."""
    scores = np.ascontiguousarray(scores, dtype="<f4").reshape(-1)
    ids = np.ascontiguousarray(ids, dtype="<i8").reshape(-1)
    if scores.shape[0] != k or ids.shape[0] != k:
        raise ValueError(f"cache-put row must be [{k}] scores + [{k}] ids, "
                         f"got {scores.shape[0]}/{ids.shape[0]}")
    return (_encode_cache_key(req_id, query, k, nprobe, store_gen,
                              index_gen) + scores.tobytes() + ids.tobytes())


def decode_cache_put(payload: bytes
                     ) -> Tuple[CacheKey, np.ndarray, np.ndarray]:
    """-> (key, scores [k] f32, ids [k] i64); the arrays alias the payload.
    Truncated or trailing bytes are rejected."""
    key, off = _decode_cache_key(payload, "cache put")
    if key.k <= 0:
        raise FrameError(f"cache-put k {key.k} must be positive")
    want = key.k * (4 + 8)
    if len(payload) - off != want:
        raise FrameError(f"cache-put row carries {len(payload) - off} "
                         f"bytes for k={key.k} ({want} expected)")
    scores = np.frombuffer(payload, dtype="<f4", count=key.k, offset=off)
    ids = np.frombuffer(payload, dtype="<i8", count=key.k,
                        offset=off + key.k * 4)
    return key, scores, ids


# ---------------------------------------------------------------------------
# framing over sync sockets (the client library)
# ---------------------------------------------------------------------------

def _check_header(hdr: bytes) -> Tuple[int, int]:
    magic, ftype, length = HEADER.unpack(hdr)
    if magic != MAGIC:
        raise FrameError(f"bad magic 0x{magic:08x} (not a DPV1 peer)")
    if ftype not in _TYPES:
        raise FrameError(f"unknown frame type {ftype}")
    if length > MAX_FRAME:
        raise FrameError(f"frame length {length} exceeds MAX_FRAME "
                         f"{MAX_FRAME}")
    return ftype, length


def pack_frame(ftype: int, payload: bytes = b"") -> bytes:
    return HEADER.pack(MAGIC, ftype, len(payload)) + payload


def read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF BEFORE the first byte,
    FrameError on EOF mid-read (a torn frame)."""
    if n == 0:
        return b""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            if got == 0:
                return None
            raise FrameError(f"stream truncated: EOF after {got}/{n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _close_quietly(sock: socket.socket) -> None:
    # shutdown before close: close() alone does not release a socket while
    # another thread is blocked in recv() on it, so no FIN would reach
    # either side; shutdown() wakes the reader and tears the stream now
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _wire_fault_send(sock: socket.socket, view, op: str) -> bool:
    """Consult the active fault plan before a framed send. Returns True
    when the fault itself sent the frame (frame_dup); the kinds that tear
    the stream close the socket and raise InjectedFault, an OSError, so
    the callers' recovery paths run unchanged."""
    plan = faults.active()
    spec = plan.wire(op)
    if spec is None:
        return False
    kind = spec.kind
    if kind in ("delay", "frame_delay"):
        time.sleep(plan.wire_delay_s())
        return False                      # stalled; the frame still ships
    if kind == "frame_dup":
        sock.sendall(view)
        sock.sendall(view)                # the receiver sees a retransmit
        return True
    if kind == "frame_trunc":
        try:
            sock.sendall(view[:max(1, len(view) // 2)])
        except OSError:
            pass
        _close_quietly(sock)
        raise InjectedFault(f"injected fault: {op} frame_trunc")
    # conn_drop / io_error: the stream dies before any byte of this frame
    _close_quietly(sock)
    raise InjectedFault(f"injected fault: {op} {kind}")


def _wire_fault_recv(sock: socket.socket, op: str) -> None:
    """The receive side, fired as a framed read starts: a delay stalls the
    reader; every other kind tears the stream under it (a receiver cannot
    truncate or duplicate what its peer sends)."""
    plan = faults.active()
    spec = plan.wire(op)
    if spec is None:
        return
    if spec.kind in ("delay", "frame_delay"):
        time.sleep(plan.wire_delay_s())
        return
    _close_quietly(sock)
    raise InjectedFault(f"injected fault: {op} {spec.kind}")


def read_frame(sock: socket.socket,
               op: str = "wire_recv") -> Optional[Tuple[int, bytes]]:
    """-> (type, payload), or None on clean EOF at a frame boundary.
    Garbage/oversize headers and truncation raise FrameError."""
    _wire_fault_recv(sock, op)
    hdr = read_exact(sock, HEADER.size)
    if hdr is None:
        return None
    ftype, length = _check_header(hdr)
    payload = read_exact(sock, length)
    if payload is None:
        raise FrameError("stream truncated between header and payload")
    return ftype, payload


def write_frame(sock: socket.socket, ftype: int, payload: bytes = b"",
                counter=None, op: str = "wire_send") -> int:
    """Send one frame; returns the wire bytes written (header included).
    `counter` (a telemetry Counter) accumulates them."""
    frame = pack_frame(ftype, payload)
    if not _wire_fault_send(sock, frame, op):
        sock.sendall(frame)
    if counter is not None:
        counter.inc(len(frame))
    return len(frame)


def _byte_view(part) -> memoryview:
    """Any bytes-like (incl. a contiguous np array) -> a flat byte view
    with a correct len() — no tobytes() copy on the encode path."""
    if isinstance(part, np.ndarray):
        return memoryview(np.ascontiguousarray(part)).cast("B")
    return memoryview(part)


class FrameSender:
    """Per-connection reused encode buffer: the frame — header plus
    payload parts — is assembled in ONE resident bytearray and shipped
    with ONE coalesced sendall, so the hot send path does not allocate
    and concatenate per frame. NOT thread-safe — every caller already
    serializes its connection writes (the worker's and the gateway's send
    locks, the client's thread-local connection)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        # owned by the connection's single writer (see class docstring)
        self._buf = bytearray(8192)

    def send(self, ftype: int, *parts, counter=None, raw_counter=None,
             raw_len: Optional[int] = None, op: str = "wire_send") -> int:
        """Assemble + send one frame; returns wire bytes written.
        `raw_len` is the raw-equivalent frame size for the compression
        accounting (default: the actual size); `op` names the fault
        injection point this send fires."""
        views = [_byte_view(p) for p in parts]
        total = HEADER.size + sum(len(v) for v in views)
        buf = self._buf
        if len(buf) < total:
            buf = self._buf = bytearray(total)
        HEADER.pack_into(buf, 0, MAGIC, ftype, total - HEADER.size)
        off = HEADER.size
        for v in views:
            buf[off: off + len(v)] = v
            off += len(v)
        frame = memoryview(buf)[:total]
        if not _wire_fault_send(self.sock, frame, op):
            self.sock.sendall(frame)
        if counter is not None:
            counter.inc(total)
        if raw_counter is not None:
            raw_counter.inc(total if raw_len is None else raw_len)
        return total


class InternTable:
    """SENDER side of the per-connection query-block interning: block
    bytes -> slot id, with a deterministic ring over WIRE_SLOTS slots.
    The sender alone decides slot reuse (the receiver's table is a
    passive slot -> bytes store that PUT overwrites), so eviction can
    never desynchronize the two ends. NOT thread-safe — owned by the
    connection's writer."""

    def __init__(self, cap: int = WIRE_SLOTS):
        self._cap = int(cap)
        self._by_key: Dict[bytes, int] = {}
        self._keys: List[Optional[bytes]] = [None] * self._cap
        self._next = 0

    def slot_for(self, key: bytes) -> Tuple[int, bool]:
        """-> (slot, fresh): fresh means the block must ride this frame
        (a PUT); a stale slot's previous occupant is forgotten here the
        same instant the receiver's PUT overwrites it there."""
        slot = self._by_key.get(key)
        if slot is not None:
            return slot, False
        slot = self._next
        self._next = (self._next + 1) % self._cap
        old = self._keys[slot]
        if old is not None:
            del self._by_key[old]
        self._keys[slot] = key
        self._by_key[key] = slot
        return slot, True


# ---------------------------------------------------------------------------
# framing over asyncio streams (the front-end server)
# ---------------------------------------------------------------------------

async def read_frame_async(reader: asyncio.StreamReader,
                           op: str = "wire_recv"
                           ) -> Optional[Tuple[int, bytes]]:
    """Asyncio twin of read_frame: (type, payload), None on clean EOF,
    FrameError on garbage/oversize/truncation. An injected wire fault
    surfaces as a FrameError (the server's torn-frame path closes the
    connection)."""
    spec = faults.active().wire(op)
    if spec is not None:
        if spec.kind in ("delay", "frame_delay"):
            await asyncio.sleep(faults.active().wire_delay_s())
        else:
            raise FrameError(f"injected fault: {op} {spec.kind}")
    try:
        hdr = await reader.readexactly(HEADER.size)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise FrameError(
            f"stream truncated inside a header ({len(e.partial)}/"
            f"{HEADER.size} bytes)") from None
    ftype, length = _check_header(hdr)
    try:
        payload = await reader.readexactly(length)
    except asyncio.IncompleteReadError as e:
        raise FrameError(f"stream truncated: EOF after {len(e.partial)}/"
                         f"{length} payload bytes") from None
    return ftype, payload


# ---------------------------------------------------------------------------
# the client library (loadgen socket mode, cli loadtest --transport socket)
# ---------------------------------------------------------------------------

class SocketSearchClient:
    """Blocking client for the front-end protocol. Thread-safe the way
    the loadgen driver is threaded: each calling thread gets its own
    connection (thread-local), so concurrent trial workers never
    interleave frames on one socket. `search()` mirrors
    `SearchService.search`'s signature, so `loadgen/driver.py:run_trial`
    can point its issue loop at a client unchanged.

    With `compress` (the default) each fresh connection leads with a
    T_HELLO advertising FLAG_WIRE_COMPRESS; the server answers with the
    agreed intersection. On a compressing connection, repeated query
    blocks intern into per-connection slots (PUT once, 2-byte REF after)
    and results arrive as T_RESULT_C — both lossless. A server that does
    not answer the HELLO is remembered and the client reconnects raw.

    With `result_cache` the HELLO also advertises FLAG_RESULT_CACHE; once
    the server confirms, `cache_lookup()` probes its result cache and
    `cache_put()` shares a computed row into it (the fleet result cache
    between front ends). Against a server that does not confirm the flag
    both are no-ops.

    With `filters` (the default) the HELLO also advertises FLAG_FILTERS: a
    `filters=` predicate rides the frame's optional trailing field once
    the server confirmed it; against a server that did not, a filtered
    call raises RemoteError."""

    def __init__(self, host: str, port: int, deadline_ms: float = 0.0,
                 timeout_s: float = 30.0, compress: bool = True,
                 result_cache: bool = False, filters: bool = True):
        self.host = host
        self.port = int(port)
        self.deadline_ms = float(deadline_ms)
        self.timeout_s = float(timeout_s)
        self.compress = bool(compress)
        self.result_cache = bool(result_cache)
        self.filters = bool(filters)
        self._local = threading.local()
        self._lock = threading.Lock()
        # (owning thread, socket) of every open connection
        self._conns: List[Tuple[threading.Thread, socket.socket]] = []
        self._legacy_server = False             # guarded-by: _lock

    def _dial(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _conn(self):
        """-> (sock, sender, flags, intern): this thread's connection
        state, dialing + negotiating on first use."""
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            return (sock, self._local.sender, self._local.flags,
                    self._local.intern)
        sock = self._dial()
        sender = FrameSender(sock)
        flags = 0
        want = ((FLAG_WIRE_COMPRESS if self.compress else 0)
                | (FLAG_RESULT_CACHE if self.result_cache else 0)
                | (FLAG_FILTERS if self.filters else 0))
        with self._lock:
            attempt_hello = bool(want) and not self._legacy_server
        if attempt_hello:
            try:
                sender.send(T_HELLO, encode_hello(want))
                frame = read_frame(sock)
            except (OSError, FrameError):
                frame = None
            if frame is not None and frame[0] == T_HELLO:
                flags = decode_hello(frame[1])
            else:
                # a server that errors or closes on T_HELLO: remember and
                # redial raw so every later connection skips the handshake
                with self._lock:
                    self._legacy_server = True
                try:
                    sock.close()
                except OSError:
                    pass
                sock = self._dial()
                sender = FrameSender(sock)
        self._local.sock = sock
        self._local.sender = sender
        self._local.flags = flags
        self._local.intern = InternTable()
        # a thread that ended leaves its connection behind (a load trial's
        # pool threads): close those here, so open sockets stay bounded by
        # the live threads
        with self._lock:
            dead = [c for t, c in self._conns if not t.is_alive()]
            self._conns = [(t, c) for t, c in self._conns if t.is_alive()]
            self._conns.append((threading.current_thread(), sock))
        for c in dead:
            try:
                c.close()
            except OSError:
                pass
        return sock, sender, flags, self._local.intern

    def _roundtrip(self, ftype: int, parts: Tuple, req_id: int,
                   op: str = "wire_send"
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
        sock, sender, _, _ = self._conn()
        try:
            sender.send(ftype, *parts, op=op)
            frame = read_frame(sock)
        except (OSError, FrameError):
            # a broken connection must not poison the thread's next call
            self._drop_local()
            raise
        if frame is None:
            self._drop_local()
            raise RemoteError("server closed the connection mid-request")
        rtype, body = frame
        if rtype in (T_RESULT, T_RESULT_C):
            rid, scores, ids, scan = decode_result_any(rtype, body)
            if rid != req_id:
                self._drop_local()
                raise RemoteError(f"response for request {rid} arrived on "
                                  f"request {req_id}'s connection")
            return scores, ids, scan
        if rtype == T_SHED:
            _, code, reason = decode_shed(body)
            raise DeadlineExceeded(reason or f"shed (code {code})")
        if rtype == T_ERROR:
            _, msg = decode_error(body)
            raise RemoteError(msg)
        self._drop_local()
        raise FrameError(f"unexpected frame type {rtype} in response")

    def _drop_local(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            self._local.sock = None
            self._local.sender = None
            self._local.flags = 0
            self._local.intern = None
            try:
                sock.close()
            except OSError:
                pass

    def _filters_text(self, filters) -> Optional[str]:
        """A filters argument (None, predicate text or a Predicate) -> the
        text to send, or None. A predicate for a server that never
        confirmed FLAG_FILTERS raises here: an unfiltered frame would be
        answered with unfiltered results."""
        text = getattr(filters, "text", filters)
        if text is None or text == "":
            return None
        _, _, flags, _ = self._conn()
        if not flags & FLAG_FILTERS:
            raise RemoteError("server did not negotiate filtered queries "
                              "(FLAG_FILTERS)")
        return str(text)

    def search(self, query: str, k: Optional[int] = None,
               nprobe: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               filters=None) -> List[Dict]:
        """One text query over the wire -> the [{page_id, score}] list a
        local `SearchService.search` returns, without the snippets (they
        stay server-side; the wire carries scores and ids)."""
        scores, ids, _ = self.search_raw([query], k=k, nprobe=nprobe,
                                         deadline_ms=deadline_ms,
                                         filters=filters)
        return [{"page_id": int(i), "score": float(s)}
                for s, i in zip(scores[0], ids[0]) if i >= 0]

    def search_raw(self, queries: Sequence[str], k: Optional[int] = None,
                   nprobe: Optional[int] = None,
                   deadline_ms: Optional[float] = None,
                   filters=None) -> Tuple[np.ndarray, np.ndarray, int]:
        req_id = next_request_id()
        dl = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        payload = encode_query(req_id, list(queries), k=k or 0,
                               nprobe=nprobe or 0, deadline_ms=dl,
                               filters=self._filters_text(filters))
        return self._roundtrip(T_QUERY, (payload,), req_id)

    def topk_vectors(self, qv: np.ndarray, k: Optional[int] = None,
                     nprobe: Optional[int] = None,
                     deadline_ms: Optional[float] = None,
                     filters=None) -> Tuple[np.ndarray, np.ndarray, int]:
        """Raw vector retrieval over the wire (the model-free twin of
        `SearchService.topk_vectors`): (scores, ids, scan_bytes). On a
        compressing connection the query block interns: a repeated block
        ships once and costs a 2-byte slot reference after; the filter
        field rides each request, never the interned block."""
        req_id = next_request_id()
        dl = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        ftext = self._filters_text(filters)
        block = np.ascontiguousarray(qv, dtype="<f4")
        if block.ndim != 2 or not 0 < block.shape[0] <= 0xFFFF \
                or not 0 < block.shape[1] <= 0xFFFF:
            raise ValueError(f"query block must be [1..65535, 1..65535], "
                             f"got {block.shape}")
        n, dim = block.shape
        _, _, flags, intern = self._conn()
        if flags & FLAG_WIRE_COMPRESS:
            key = block.tobytes()
            slot, fresh = intern.slot_for(key)
            head = _VQUERY_HEAD.pack(req_id, dl, int(k or 0),
                                     int(nprobe or 0), n, dim)
            tail = _filters_field(ftext)
            if fresh:
                return self._roundtrip(T_VQUERY_PUT,
                                       (head, _SLOT.pack(slot), key, tail),
                                       req_id)
            return self._roundtrip(T_VQUERY_REF,
                                   (head, _SLOT.pack(slot), tail), req_id)
        payload = encode_vquery(req_id, block, k=k or 0, nprobe=nprobe or 0,
                                deadline_ms=dl, filters=ftext)
        return self._roundtrip(T_VQUERY, (payload,), req_id)

    # -- the fleet result cache ------------------------------------------
    def cache_lookup(self, query: str, k: int, nprobe: int,
                     store_gen: int, index_gen: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Probe the server's result cache for the generation-qualified
        key: (scores [1, k], ids [1, k]) on a hit, None on a miss or on a
        connection that never negotiated FLAG_RESULT_CACHE. A probe never
        admits, queues or computes anything on the server."""
        _, _, flags, _ = self._conn()
        if not flags & FLAG_RESULT_CACHE:
            return None
        req_id = next_request_id()
        payload = encode_cache_lookup(req_id, query, k=k, nprobe=nprobe,
                                      store_gen=store_gen,
                                      index_gen=index_gen)
        try:
            scores, ids, _ = self._roundtrip(T_CACHE_LOOKUP, (payload,),
                                             req_id, op="cache_peer_send")
        except DeadlineExceeded:
            return None           # SHED_CACHE_MISS: a miss, not a shed
        return scores, ids

    def cache_put(self, query: str, k: int, nprobe: int, store_gen: int,
                  index_gen: int, scores: np.ndarray,
                  ids: np.ndarray) -> bool:
        """Share one computed [k] result row into the server's cache. No
        response frame rides back (the server checks the generations and
        drops a stale entry), so the call costs one send. True when the
        frame left; False when the flag was never negotiated or the
        connection broke."""
        _, sender, flags, _ = self._conn()
        if not flags & FLAG_RESULT_CACHE:
            return False
        payload = encode_cache_put(next_request_id(), query, k=k,
                                   nprobe=nprobe, store_gen=store_gen,
                                   index_gen=index_gen, scores=scores,
                                   ids=ids)
        try:
            sender.send(T_CACHE_PUT, payload, op="cache_peer_send")
        except OSError:
            self._drop_local()
            return False
        return True

    def close(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, []
        for _, sock in conns:
            try:
                sock.close()
            except OSError:
                pass
