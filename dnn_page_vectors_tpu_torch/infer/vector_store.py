"""Vector store: fp16 shards + id files under one directory, the on-disk
format of the JAX package's infer/vector_store.py, so each package reads the
other's store.

Layout:
  manifest.json          {"dim", "dtype", "shard_size", "model_step",
                          "shards": [{"index", "count", "vec", "ids",
                                      "bytes": {...}, "crc": {...}}]}
  shard_00000.vec.npy    [n, dim] float16 L2-normalized page vectors
  shard_00000.ids.npy    [n] int64 page ids (batch padding never stored)

Shards are the resume unit: a completed shard is recorded in the manifest
after its files are written and fsynced, so a restarted job skips exactly
the finished ones. Each entry records the byte size and CRC32 of its files;
``verify()`` re-checks them on open and quarantines (renames aside and
drops) any shard whose bytes no longer match, so resume re-embeds it.

Readers take the whole store (``load_all``) or a shard at a time
(``iter_shards``, optionally read ahead on a thread: ``read_ahead``).

This is the fp16 base-store subset. int8 stores, append generations,
per-row attributes and per-writer manifests are later slices: a store that
uses any of them is refused with NotImplementedError rather than read in
part.
"""
from __future__ import annotations

import glob
import json
import os
import queue as queue_mod
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def read_ahead(it, depth: int = 1):
    """Drain the iterator `it` on a background reader thread, at most
    `depth` items ahead of the consumer, so the next shard's disk read
    overlaps the consumer's device work on the current one (the streaming
    top-k sweep, ops/topk.py ``topk_over_store``). The queue is bounded: a
    slow consumer holds the reader back, and host memory stays O(depth)
    items. The reader's first exception is raised at the consumer as
    itself, after the items before it; a consumer that stops early (break,
    close, an error) stops the reader and joins it."""
    q: "queue_mod.Queue[object]" = queue_mod.Queue(maxsize=max(1, depth))
    done = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _read():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 -- re-raised consumer-side
            err.append(e)
        finally:
            _put(done)

    t = threading.Thread(target=_read, daemon=True, name="shard-reader")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            yield item
    finally:
        stop.set()
        t.join()
        if err:
            raise err[0]


def crc_file(path: str) -> int:
    """Streaming CRC32 of a file's bytes (npy header included)."""
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _fsync_path(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:       # platforms without O_RDONLY dir opens
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def prepare_store(directory: str, dim: int, shard_size: Optional[int],
                  dtype: Optional[str], model_step: int) -> "VectorStore":
    """Open or create the store stamped for `model_step` with the given
    geometry. A stale store (another model_step) is reset before the new
    geometry applies, so its old shard size cannot block the open."""
    if os.path.exists(os.path.join(os.path.abspath(directory),
                                   "manifest.json")):
        plain = VectorStore(directory)
        if plain.manifest.get("model_step") != model_step:
            plain.reset()
    store = VectorStore(directory, dim=dim, shard_size=shard_size,
                        dtype=dtype)
    store.ensure_model_step(model_step)
    return store


class VectorStore:
    def __init__(self, directory: str, dim: Optional[int] = None,
                 shard_size: Optional[int] = None,
                 dtype: Optional[str] = None, verify: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._manifest_path = os.path.join(self.directory, "manifest.json")
        if dtype not in (None, "float16"):
            raise NotImplementedError(
                f"store dtype {dtype!r} is not ported yet (fp16 only; int8 "
                "stores are slice 6 of the port)")
        existed = os.path.exists(self._manifest_path)
        if existed:
            with open(self._manifest_path) as f:
                self.manifest = json.load(f)
            if dim is not None and dim != self.manifest["dim"]:
                raise ValueError(
                    f"store at {self.directory} holds {self.manifest['dim']}-d "
                    f"vectors but dim={dim} was requested; use a fresh "
                    "directory (or reset()) when the model out_dim changes")
            self._refuse_unported()
        else:
            if dim is None:
                raise FileNotFoundError(
                    f"no vector store at {self.directory} (missing "
                    "manifest.json); pass dim= to create a new store")
            self.manifest = {"dim": dim, "dtype": "float16",
                             "shard_size": shard_size or 65_536,
                             "shards": []}
            self._flush_manifest()
        if existed and verify:
            self.verify()
        # an EMPTY store may adopt a new shard size (a populated one cannot:
        # its shard files already have the recorded geometry)
        if shard_size is not None and shard_size != self.manifest["shard_size"]:
            if self.shards():
                raise ValueError(
                    f"store at {self.directory} was built with shard_size="
                    f"{self.manifest['shard_size']} and holds shards; cannot "
                    f"switch to {shard_size} (reset() first)")
            self.manifest["shard_size"] = shard_size
            self._flush_manifest()

    def _refuse_unported(self) -> None:
        m = self.manifest
        why = []
        if m.get("dtype", "float16") != "float16":
            why.append(f"dtype {m['dtype']!r}")
        if glob.glob(os.path.join(self.directory, "manifest.w*.json")):
            why.append("per-writer manifests")
        if glob.glob(os.path.join(self.directory, "gen-*")) or \
                m.get("compacted_through"):
            why.append("append generations")
        if m.get("attrs") or any("atr" in s for s in m["shards"]):
            why.append("per-row attributes")
        if m.get("migration"):
            why.append("a rolling migration")
        if why:
            raise NotImplementedError(
                f"store at {self.directory} uses {', '.join(why)}, which the "
                "port does not read yet (slice 6 of the port)")

    # -- manifest ---------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.manifest["dim"]

    @property
    def num_vectors(self) -> int:
        return sum(s["count"] for s in self.shards())

    @property
    def model_step(self) -> Optional[int]:
        return self.manifest.get("model_step")

    def shards(self) -> List[Dict]:
        return sorted(self.manifest["shards"], key=lambda s: s["index"])

    def completed_shards(self) -> set:
        return {s["index"] for s in self.shards()}

    def _flush_manifest(self) -> None:
        """tmp + fsync + atomic rename + directory fsync: a crash leaves
        the old manifest or the new one, never a torn one."""
        tmp = self._manifest_path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.manifest, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)
        _fsync_path(self.directory)

    def ensure_model_step(self, step: int) -> None:
        """Vectors embedded at another model step are stale, not resumable
        work: reset, then stamp the new step."""
        if self.manifest.get("model_step") != step:
            self.reset()
        self.manifest["model_step"] = step
        self._flush_manifest()

    def reset(self) -> None:
        """Drop every shard (the model changed and the vectors are stale)."""
        for s in self.shards():
            for key in ("vec", "ids"):
                try:
                    os.remove(os.path.join(self.directory, s[key]))
                except FileNotFoundError:
                    pass
        self.manifest["shards"] = []
        self.manifest.pop("missing_id_ranges", None)
        self._flush_manifest()

    # -- integrity --------------------------------------------------------
    def entry_error(self, entry: Dict) -> Optional[str]:
        """Why this shard entry cannot be trusted, or None: existence and
        recorded byte size first (one stat catches truncation), then CRC32."""
        for key in ("vec", "ids"):
            path = os.path.join(self.directory, entry[key])
            if not os.path.exists(path):
                return f"{key} file {entry[key]} missing"
            want_bytes = entry.get("bytes", {}).get(key)
            if want_bytes is not None and os.path.getsize(path) != want_bytes:
                return (f"{key} file {entry[key]} is {os.path.getsize(path)} "
                        f"bytes, manifest records {want_bytes} (truncated?)")
            want_crc = entry.get("crc", {}).get(key)
            if want_crc is not None:
                got = crc_file(path)
                if got != want_crc:
                    return (f"{key} file {entry[key]} CRC {got:#010x} != "
                            f"recorded {want_crc:#010x} (corrupt)")
        return None

    def quarantine(self, entry: Dict, reason: str) -> None:
        """Move a bad shard's files aside (.quarantined) and drop its entry,
        so the next embed_corpus resume re-embeds exactly its id range."""
        for key in ("vec", "ids"):
            src = os.path.join(self.directory, entry[key])
            try:
                os.replace(src, src + ".quarantined")
            except FileNotFoundError:
                pass
        ss = self.manifest["shard_size"]
        lo = entry["index"] * ss
        ranges = {(int(a), int(b))
                  for a, b in self.manifest.get("missing_id_ranges", [])}
        ranges.add((lo, lo + int(entry["count"])))
        self.manifest["missing_id_ranges"] = [list(r) for r in sorted(ranges)]
        self.manifest["shards"] = [s for s in self.manifest["shards"]
                                   if s["index"] != entry["index"]]
        self._flush_manifest()
        print(f"WARNING: quarantined store shard {entry['index']} ({reason}); "
              "its id range will be re-embedded on the next embed resume",
              flush=True)

    def verify(self) -> List[int]:
        """Re-check every shard against its recorded sizes/CRCs, quarantining
        the ones that fail; returns the quarantined indices."""
        bad = []
        for entry in self.shards():
            err = self.entry_error(entry)
            if err is not None:
                self.quarantine(entry, err)
                bad.append(entry["index"])
        return bad

    # -- write ------------------------------------------------------------
    def write_shard(self, index: int, ids: np.ndarray,
                    vecs: np.ndarray) -> None:
        """Persist one shard. Rows with id < 0 (batch padding) are dropped.
        Data files are written and fsynced first; the manifest entry lands
        last, so a crash leaves the shard unrecorded or complete."""
        if vecs.shape[-1] != self.dim:
            raise ValueError(f"vectors are {vecs.shape[-1]}-d, store is "
                             f"{self.dim}-d")
        keep = ids >= 0
        ids = ids[keep]
        vpath = os.path.join(self.directory, f"shard_{index:05d}.vec.npy")
        ipath = os.path.join(self.directory, f"shard_{index:05d}.ids.npy")
        np.save(vpath, np.asarray(vecs[keep], np.float16))
        np.save(ipath, ids.astype(np.int64))
        entry = {"index": index, "count": int(ids.shape[0]),
                 "vec": os.path.basename(vpath),
                 "ids": os.path.basename(ipath), "bytes": {}, "crc": {}}
        for key, path in (("vec", vpath), ("ids", ipath)):
            entry["bytes"][key] = os.path.getsize(path)
            entry["crc"][key] = crc_file(path)
            _fsync_path(path)
        self.manifest["shards"] = sorted(
            [s for s in self.manifest["shards"] if s["index"] != index]
            + [entry], key=lambda s: s["index"])
        # a re-embedded shard re-covers its quarantined id range
        ss = self.manifest["shard_size"]
        lo = index * ss
        ranges = self.manifest.get("missing_id_ranges", [])
        kept = [r for r in ranges if not (lo <= int(r[0])
                                          and int(r[1]) <= lo + ss)]
        if len(kept) != len(ranges):
            self.manifest["missing_id_ranges"] = kept
        self._flush_manifest()

    # -- read -------------------------------------------------------------
    def _load_entry(self, entry: Dict) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [n] int64, vecs [n, dim] float16, memory-mapped)."""
        vecs = np.load(os.path.join(self.directory, entry["vec"]),
                       mmap_mode="r")
        ids = np.load(os.path.join(self.directory, entry["ids"]))
        return ids, vecs

    def iter_shards(self, prefetch: int = 0,
                    entries: Optional[List[Dict]] = None
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (ids [n] int64, vecs [n, dim] float16) a shard at a time,
        in shard order. With `prefetch` > 0 a reader thread (read_ahead)
        loads up to `prefetch` shards ahead and reads each memory-mapped
        vector file into memory on its side: the memmap defers the disk
        read to the first touch, which would otherwise fall back on the
        consumer. `entries` sweeps the given shard entries instead of the
        manifest's."""
        if entries is None:
            entries = self.shards()
        if not prefetch:
            return (self._load_entry(s) for s in entries)

        def _load():
            for s in entries:
                ids, vecs = self._load_entry(s)
                yield ids, np.array(vecs)

        return read_ahead(_load(), depth=prefetch)

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenated (ids [N] int64, vectors [N, D] float16)."""
        parts = [self._load_entry(s) for s in self.shards()]
        if not parts:
            return (np.zeros(0, np.int64), np.zeros((0, self.dim), np.float16))
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([np.asarray(p[1]) for p in parts]))
