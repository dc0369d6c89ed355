"""Per-writer append leases on a store's id cursor, the port's copy of the
JAX package's maintenance/lease.py (same files, same record, so a port
writer and a JAX writer of one store exclude each other).

Two appends that both read the cursor (``next_page_id``) would open the
same generation and assign the same ids. The lease makes the cursor a
leased resource:

  * the lease record is one JSON file beside the store manifest
    (``append.lease.json``: token, owner, acquired, expires, cursor),
    written through the store's atomic dump;
  * its check-then-write is serialized by a short-lived lock file
    (``append.lease.json.lock``, created with O_CREAT | O_EXCL), so two
    acquirers never interleave their read and claim; a lock file older
    than ``_LOCK_STALE_S`` is a crashed acquirer's and is broken;
  * a lease expires after its ttl (``updates.writer_lease_s``): the next
    acquirer takes an expired lease over (``lease_stolen`` event), since
    the dead writer's uncommitted generation was never visible;
  * a second live writer polls until ``updates.lease_wait_s`` runs out,
    then raises LeaseHeld (0: at once).

``append_corpus`` (updates/append.py) holds a lease from its cursor read
to its commit and renews it after every shard. Expiry reads the wall
clock: the lease coordinates processes, and its file is coordination
state, not part of the store's bytes.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

from dnn_page_vectors_tpu_torch.utils import faults, telemetry

LEASE_NAME = "append.lease.json"
# a lock file (held for one read and write) older than this is a crashed
# acquirer's and is broken
_LOCK_STALE_S = 5.0
_POLL_S = 0.05

_TOKEN_LOCK = threading.Lock()
_TOKEN_SEQ = 0


def _next_token(owner: str) -> str:
    """A lease token unique in this process: owner, pid and a sequence."""
    global _TOKEN_SEQ
    with _TOKEN_LOCK:
        _TOKEN_SEQ += 1
        return f"{owner}:{os.getpid()}:{_TOKEN_SEQ}"


class LeaseHeld(RuntimeError):
    """Another live writer holds the append lease and the wait ran out."""


class LeaseLost(RuntimeError):
    """This writer's lease expired and another took it over mid-append:
    the append must abort, since it no longer owns the cursor."""


class AppendLease:
    """One writer's claim on a store's append cursor (a context manager).

    >>> with AppendLease(store, ttl_s=30.0, wait_s=5.0):
    ...     cursor = store.next_page_id()   # no other leased writer
    """

    def __init__(self, store, owner: Optional[str] = None,
                 ttl_s: float = 30.0, wait_s: float = 5.0, registry=None):
        self.store = store
        self.path = os.path.join(store.directory, LEASE_NAME)
        self.owner = owner or f"pid-{os.getpid()}"
        self.token = _next_token(self.owner)
        self.ttl_s = max(0.1, float(ttl_s))
        self.wait_s = max(0.0, float(wait_s))
        self.registry = registry or telemetry.default_registry()
        self.held = False
        self.stole_from: Optional[str] = None

    @contextlib.contextmanager
    def _flock(self):
        """The lock file around one lease-file read and write."""
        lock = self.path + ".lock"
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                try:
                    if time.time() - os.path.getmtime(lock) > _LOCK_STALE_S:
                        os.remove(lock)
                        self.registry.counter("lease.lock_broken").inc()
                        faults.count("lease_lock_broken")
                        continue
                except OSError:
                    continue
                time.sleep(_POLL_S)
        try:
            yield
        finally:
            os.close(fd)
            try:
                os.remove(lock)
            except OSError:
                pass

    def _read(self) -> Optional[Dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write(self, now: float) -> None:
        self.store._atomic_dump({
            "token": self.token, "owner": self.owner,
            "acquired": round(now, 3),
            "expires": round(now + self.ttl_s, 3),
            "cursor": self.store.next_page_id(),
        }, self.path, op="lease")

    def acquire(self) -> "AppendLease":
        """Take the cursor: a free or expired lease at once (an expired one
        counts as stolen), a live foreign one after polling, or LeaseHeld
        when `wait_s` runs out."""
        deadline = time.monotonic() + self.wait_s
        while True:
            with self._flock():
                cur = self._read()
                now = time.time()
                expired = cur is not None and float(
                    cur.get("expires", 0)) <= now
                if cur is None or expired or cur.get("token") == self.token:
                    self.stole_from = (cur.get("owner")
                                       if cur is not None and expired
                                       else None)
                    self._write(now)
                    self.held = True
                    self.registry.counter("lease.acquired").inc()
                    faults.count("lease_acquired")
                    self.registry.event("lease_acquired", {
                        "owner": self.owner,
                        "stolen_from": self.stole_from})
                    if self.stole_from is not None:
                        self.registry.counter("lease.stolen").inc()
                        faults.count("lease_stolen")
                        self.registry.event("lease_stolen", {
                            "owner": self.owner, "from": self.stole_from})
                    return self
                holder = cur.get("owner", "?")
            if time.monotonic() >= deadline:
                raise LeaseHeld(
                    f"append lease on {self.store.directory} is held by "
                    f"{holder} (expires in "
                    f"{float(cur.get('expires', 0)) - now:.1f}s); "
                    "queue longer (updates.lease_wait_s) or retry")
            time.sleep(_POLL_S)

    def renew(self) -> None:
        """Extend the ttl mid-append (after each shard). Raises LeaseLost
        when another writer took the lease over."""
        if not self.held:
            raise RuntimeError("renew() before acquire()")
        with self._flock():
            cur = self._read()
            if cur is None or cur.get("token") != self.token:
                self.held = False
                raise LeaseLost(
                    f"append lease on {self.store.directory} was taken by "
                    f"{(cur or {}).get('owner', '?')}: this writer's ttl "
                    "expired mid-append; raise updates.writer_lease_s")
            self._write(time.time())

    def release(self) -> None:
        """Drop the lease (idempotent; never removes a foreign lease)."""
        if not self.held:
            return
        with self._flock():
            cur = self._read()
            if cur is not None and cur.get("token") == self.token:
                try:
                    os.remove(self.path)
                except OSError:
                    pass
        self.held = False

    def __enter__(self) -> "AppendLease":
        return self.acquire() if not self.held else self

    def __exit__(self, *exc) -> None:
        self.release()


def expire_stale_lease(store, registry=None) -> bool:
    """Remove an expired lease file, so the next acquirer starts clean
    instead of taking it over; True when one was removed."""
    lease = AppendLease(store, owner="janitor", registry=registry)
    with lease._flock():
        cur = lease._read()
        if cur is None or float(cur.get("expires", 0)) > time.time():
            return False
        try:
            os.remove(lease.path)
        except OSError:
            return False
    lease.registry.counter("lease.expired").inc()
    faults.count("lease_expired")
    return True
