"""IVF inverted-file index over the vector store, the port's copy of the
JAX package's index/ivf.py on one card.

A coarse k-means quantizer (index/kmeans.py) splits the store's rows into
`nlist` inverted lists. A query scores the [nlist, D] centroids on the
card (``chunked_topk``), gathers only the rows of its top-`nprobe` lists
from the store's memory-mapped shards at stored width (int8 codes and
scales, or float16 rows), and re-ranks that block exactly on the card
(``rerank_candidates``). On a PQ index (index/pq.py) the lists' m-byte
codes are gathered instead and scored by ADC (``adc_topr``); only each
query's top-r survivors are gathered at stored width and re-ranked
exactly (``rerank_positions``). The store is never staged whole.

Layout next to the store, the JAX package's, so each package opens the
other's index:

  <store>/ivf/manifest.json     nlist, dim, model_step stamp, seed, per-file
                                byte sizes + CRC32s, per-shard posting table,
                                optional "pq" section (m, ksub, opq config)
  <store>/ivf/centroids.npy     [nlist, D] float32 unit-norm centroids
  <store>/ivf/posting_NNNNN.ord.npy   [count] int32 shard-row order, grouped
                                      by list (CSR values)
  <store>/ivf/posting_NNNNN.off.npy   [nlist+1] int64 CSR offsets
  <store>/ivf/pq_rotation.npy   [D, D] float32 OPQ rotation   (PQ builds)
  <store>/ivf/pq_codebooks.npy  [m, ksub, dsub] float32       (PQ builds)
  <store>/ivf/posting_NNNNN.pqc.npy   [count, m] uint8 PQ codes in shard
                                      row order

Validity: ``open`` checks the recorded model step against the store's
stamp, the recorded shard table (index, count) against the store's, and
every file's bytes and CRC32. A stale index raises ``IndexUnavailable``;
a file whose bytes no longer match is quarantined (renamed aside) first.
Callers (the service, eval, mine) serve exact search then.

Live updates: after a store append the recorded shard table is a strict
subset of the store's, and ``update`` extends the index by assigning only
the unrecorded shards to the existing centroids (and, on a PQ index,
encoding their codes with the existing rotation and codebooks), writing
their posting files beside the old ones, until the drift (the corpus
share appended since the last full k-means, ``updates.rebuild_drift``)
asks for a full rebuild. A tombstoned row stays in its list: the store's
read-time masking turns it into a dead (-1) candidate the re-rank drops.

Background rebuilds (maintenance/service.py): ``build(dirname=...)``
builds the next index generation in a sibling directory (ivf-NNNN) beside
the live one, and the store's ``index_dir`` pointer flips to it with one
atomic manifest dump; ``index_dir(store)`` always reads the pointer.
``update(defer_rebuild=True)`` keeps full rebuilds off the caller: past
the drift it still appends the new shards and flags
``info["rebuild_pending"]``; a structural reason raises IndexUnavailable
(the caller serves exact until the background rebuild swaps a fresh index
in).

Filtered retrieval (index/attrs.py): ``search(predicate=...)`` drops the
posting rows whose attribute word does not match before any row or code
is gathered, so ``gather_bytes`` falls with selectivity; a query the
filtered probe set leaves short of k re-runs with nprobe times
`escalate` until it fills or every list is probed
(``filter_escalations``).

The hot posting set: every search adds its probed lists to
``scan_counts``; ``stage_hot(budget_bytes)`` stages the most probed lists
(the largest on a cold table) that fit the budget on the index's device:
their PQ codes, list ids (-2 for a dead row) and attribute words, and
halves the table. A resident list is then scored from the staged codes
with no host gather (a predicate masks its rows on the card); the other
lists keep the mmap gather, and the two sets of ADC survivors merge
before the exact re-rank, so the results are the mmap path's.

Partitioned serving: ``partition_view(shard_indices)`` restricts the
index to one partition's shards (their posting files only, list counts of
their own), over the same manifest, centroids and codec; the service
opens the index once a view and takes one partition's view of it. The
index's fault-injection hooks are item 8 of ROADMAP.md queue 1.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dnn_page_vectors_tpu_torch.data.loader import to_device
from dnn_page_vectors_tpu_torch.index.attrs import words_tensor
from dnn_page_vectors_tpu_torch.index.kmeans import assign_store, train_kmeans
from dnn_page_vectors_tpu_torch.index.pq import PQCodec, adc_topr, train_pq
from dnn_page_vectors_tpu_torch.infer.vector_store import (
    _fsync_path, crc_file)
from dnn_page_vectors_tpu_torch.ops.topk import (
    chunked_topk, rerank_candidates, rerank_positions)
from dnn_page_vectors_tpu_torch.utils import telemetry
from dnn_page_vectors_tpu_torch.utils.device import DeviceLike, resolve_device

DIRNAME = "ivf"
MANIFEST = "manifest.json"


class IndexUnavailable(RuntimeError):
    """The IVF index cannot serve (missing, stale or quarantined). Callers
    catch this and serve exact search: a routing signal, not a crash."""


def index_dir(store) -> str:
    """The live index directory: the store manifest's `index_dir` pointer
    ("ivf" by default)."""
    return os.path.join(store.directory,
                        store.manifest.get("index_dir", DIRNAME))


def auto_nlist(num_vectors: int) -> int:
    """Default list count: about sqrt(N), at least 4 and at most 65,536
    (and N)."""
    return max(4, min(int(math.isqrt(max(num_vectors, 1))), 65_536,
                      max(num_vectors, 1)))


def _write_npy(path: str, arr: np.ndarray) -> Tuple[int, int]:
    """Write and fsync an array file; returns (bytes, CRC32) of the bytes
    written, for the manifest."""
    np.save(path, arr)
    _fsync_path(path)
    return os.path.getsize(path), crc_file(path)


def _atomic_dump(obj, path: str) -> None:
    """tmp + fsync + atomic rename: a crash leaves the old manifest or the
    new one, never a torn one."""
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class IVFIndex:
    def __init__(self, store, manifest: Dict, centroids: np.ndarray,
                 postings: Dict[int, Tuple[np.ndarray, np.ndarray]],
                 pq: Optional[PQCodec] = None, device: DeviceLike = None):
        self.store = store
        self.manifest = manifest
        self.device = resolve_device(device)
        self.centroids = centroids                 # [nlist, D] f32
        self._postings = postings                  # {shard: (order, offsets)}
        self._entries = {s["index"]: s for s in store.shards()}
        self._meta = {s["index"]: s for s in manifest["shards"]}
        self._raw: Dict[int, tuple] = {}           # lazy mmap cache
        self._codes: Dict[int, np.ndarray] = {}    # lazy PQ code mmaps
        self._attrs: Dict[int, np.ndarray] = {}    # lazy attribute words
        self._dev_centroids = None
        self._hot: Optional[Dict] = None           # stage_hot's state
        self.pq = pq                               # OPQ+PQ codec or None
        # rows per list over every shard: the candidate count of a search
        # without touching the postings
        sizes = np.zeros((self.nlist,), np.int64)
        for _, offsets in postings.values():
            sizes += np.diff(offsets)
        self.list_sizes = sizes
        self.build_stats: Dict[str, float] = {}    # set by build()
        self.stats = {"searches": 0, "lists_scanned": 0,
                      "candidates_reranked": 0, "gather_bytes": 0,
                      "reranked_rows": 0, "hot_rows_scored": 0,
                      "filter_escalations": 0}
        # probes a list since the last stage_hot halved the table: what
        # the hot set ranks by. Like `stats` it is telemetry: a lost
        # increment of two racing searches only nudges the ranking
        self.scan_counts = np.zeros((self.nlist,), np.int64)

    # -- identity ----------------------------------------------------------
    @property
    def nlist(self) -> int:
        return int(self.manifest["nlist"])

    @property
    def model_step(self) -> Optional[int]:
        return self.manifest.get("model_step")

    @property
    def imbalance(self) -> float:
        return float(self.manifest.get("imbalance", 0.0))

    @property
    def index_generation(self) -> int:
        return int(self.manifest.get("index_generation", 0))

    @property
    def hot_rows(self) -> int:
        """Rows in the staged hot posting set (0: none staged)."""
        hot = self._hot
        return 0 if hot is None else int(hot["rows"])

    @property
    def pq_m(self) -> int:
        """PQ subspaces, the bytes of a posting code row (0: stored-width
        postings)."""
        return int((self.manifest.get("pq") or {}).get("m", 0))

    # -- build -------------------------------------------------------------
    @staticmethod
    def _balance_assignments(tops: np.ndarray, nlist: int, cap: int
                             ) -> np.ndarray:
        """Capacity-capped assignment over the whole row set: every row
        starts on its best list; a list over `cap` rows keeps its first
        `cap` (stable global row order) and spills the rest to each row's
        next choice, for choices - 1 rounds. A row out of choices stays
        (a soft cap). `tops` [N, C] ranked lists; returns [N]."""
        n, n_choices = tops.shape
        cur = tops[:, 0].copy()
        level = np.zeros((n,), np.int64)
        for _ in range(max(1, n_choices - 1)):
            order = np.argsort(cur, kind="stable")      # group rows by list
            grouped = cur[order]
            starts = np.searchsorted(grouped, np.arange(nlist))
            rank = np.arange(n) - starts[grouped]
            overflow = order[rank >= cap]
            movable = overflow[level[overflow] < n_choices - 1]
            if movable.size == 0:
                break
            level[movable] += 1
            cur[movable] = tops[movable, level[movable]]
        return cur

    @classmethod
    def _assign_postings(cls, d: str, store, centroids: np.ndarray,
                         entries, chunk: int, device: torch.device,
                         balance_cap: int = 0, choices: int = 4):
        """Assign `entries`' rows to `centroids` and write their CSR
        posting files. Returns (shards_meta, postings, sizes [nlist],
        sizes_raw [nlist]). With `balance_cap` > 0 the sweep takes each
        row's top `choices` lists and rebalances over all rows (O(N x
        choices) host memory); sizes_raw are the first-choice counts."""
        nlist = centroids.shape[0]
        shards_meta = []
        postings: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        sizes = np.zeros((nlist,), np.int64)
        sizes_raw = np.zeros((nlist,), np.int64)
        nonzero = [e for e in entries if e["count"] > 0]
        per_shard = assign_store(
            store, centroids, chunk=chunk, entries=nonzero,
            choices=choices if balance_cap > 0 else 1, device=device)
        if balance_cap > 0:
            collected = list(per_shard)
            tops = (np.concatenate([a for _, a in collected])
                    if collected else np.zeros((0, choices), np.int32))
            if tops.size:
                sizes_raw += np.bincount(tops[:, 0], minlength=nlist)
            flat = cls._balance_assignments(tops, nlist, balance_cap)
            out, lo = [], 0
            for entry, a in collected:
                out.append((entry, flat[lo: lo + a.shape[0]]))
                lo += a.shape[0]
            per_shard = out
        for entry, assign in per_shard:
            order = np.argsort(assign, kind="stable").astype(np.int32)
            counts = np.bincount(assign, minlength=nlist)
            offsets = np.zeros((nlist + 1,), np.int64)
            offsets[1:] = np.cumsum(counts)
            sizes += counts
            if balance_cap <= 0:
                sizes_raw += counts
            stem = f"posting_{entry['index']:05d}"
            ob, oc = _write_npy(os.path.join(d, stem + ".ord.npy"), order)
            fb, fc = _write_npy(os.path.join(d, stem + ".off.npy"), offsets)
            shards_meta.append({
                "index": entry["index"], "count": int(entry["count"]),
                "ord": stem + ".ord.npy", "off": stem + ".off.npy",
                "bytes": {"ord": ob, "off": fb},
                "crc": {"ord": oc, "off": fc}})
            postings[entry["index"]] = (order, offsets)
        # zero-count shards carry no postings but stay in the recorded
        # table, or open() would read them as a change of the store
        for entry in entries:
            if entry["count"] == 0:
                shards_meta.append({"index": entry["index"], "count": 0})
        return shards_meta, postings, sizes, sizes_raw

    @staticmethod
    def _encode_codes(d: str, store, codec: PQCodec, shards_meta,
                      device: torch.device) -> None:
        """Encode each recorded shard's rows into its PQ code file (shard
        row order, gathered through the same .ord rows as the store) and
        add the file's bytes and CRC to the shard's meta."""
        entries = {s["index"]: s for s in store.shards()}
        for meta in shards_meta:
            if meta["count"] == 0 or "ord" not in meta:
                continue
            _, vecs = store._load_entry(entries[meta["index"]])
            codes = codec.encode(np.asarray(vecs, np.float32), device=device)
            name = f"posting_{meta['index']:05d}.pqc.npy"
            cb, cc = _write_npy(os.path.join(d, name), codes)
            meta["pqc"] = name
            meta["bytes"]["pqc"] = cb
            meta["crc"]["pqc"] = cc

    @classmethod
    def build(cls, store, nlist: int = 0, iters: int = 8, seed: int = 0,
              chunk: int = 8192, sample_per_shard: Optional[int] = None,
              init: str = "kmeans++", balance: float = 0.0, pq_m: int = 0,
              pq_iters: int = 8, opq_iters: int = 3,
              device: DeviceLike = None,
              dirname: Optional[str] = None) -> "IVFIndex":
        """Train the quantizer on `device`, assign every row, and write the
        inverted file next to the store (the manifest last, so a crash
        leaves the previous index or none, never a torn one that passes
        ``open``). `nlist` 0 is ``auto_nlist``. `balance` > 0 caps lists at
        ceil(balance * N / nlist) rows in the assignment sweep. `pq_m` > 0
        also trains the OPQ+PQ codec and writes m-byte codes a row.
        `stats` of the build: ``build_seconds`` in the manifest, and the
        split in ``self.build_stats``. `dirname` builds into that sibling
        directory of the store instead of the live pointer's (the
        background rebuild's build-beside-then-flip); open the index again
        after the pointer flips."""
        t0 = time.perf_counter()
        dev = resolve_device(device)
        N = store.num_vectors
        if N == 0:
            raise ValueError("cannot build an IVF index over an empty store")
        nlist = int(nlist) if nlist and nlist > 0 else auto_nlist(N)
        nlist = min(nlist, N)
        split = {}
        centroids, kstats = train_kmeans(
            store, nlist, iters=iters, seed=seed, chunk=chunk,
            sample_per_shard=sample_per_shard, init=init, device=dev)
        split["kmeans_s"] = time.perf_counter() - t0
        cap = (int(math.ceil(float(balance) * N / nlist))
               if balance and balance > 0 else 0)
        codec = None
        pq_stats: Optional[Dict] = None
        if pq_m:
            t1 = time.perf_counter()
            codec, pq_stats = train_pq(store, int(pq_m), iters=pq_iters,
                                       opq_iters=opq_iters, seed=seed,
                                       device=dev)
            split["pq_train_s"] = time.perf_counter() - t1
        d = (os.path.join(store.directory, dirname) if dirname
             else index_dir(store))
        os.makedirs(d, exist_ok=True)
        cb, cc = _write_npy(os.path.join(d, "centroids.npy"), centroids)
        t1 = time.perf_counter()
        shards_meta, postings, sizes, sizes_raw = cls._assign_postings(
            d, store, centroids, store.shards(), chunk, dev,
            balance_cap=cap)
        split["assign_s"] = time.perf_counter() - t1
        pq_section = None
        if codec is not None:
            t1 = time.perf_counter()
            rb, rc = _write_npy(os.path.join(d, "pq_rotation.npy"),
                                codec.rotation)
            kb, kc = _write_npy(os.path.join(d, "pq_codebooks.npy"),
                                codec.codebooks)
            cls._encode_codes(d, store, codec, shards_meta, dev)
            split["encode_s"] = time.perf_counter() - t1
            pq_section = {
                **pq_stats,
                "rotation": {"file": "pq_rotation.npy",
                             "bytes": rb, "crc": rc},
                "codebooks": {"file": "pq_codebooks.npy",
                              "bytes": kb, "crc": kc},
            }
        shards_meta.sort(key=lambda s: s["index"])
        imbalance = float(nlist * np.square(sizes, dtype=np.float64).sum()
                          / max(N, 1) ** 2)
        imbalance_raw = float(
            nlist * np.square(sizes_raw, dtype=np.float64).sum()
            / max(N, 1) ** 2)
        manifest = {
            "version": 1, "nlist": nlist, "dim": store.dim,
            "dtype": store.manifest["dtype"],
            "model_step": store.model_step, "seed": int(seed),
            "iters": kstats["iters"], "reseeded": kstats["reseeded"],
            "init": kstats["init"],
            "init_imbalance": kstats["init_imbalance"],
            "num_vectors": int(N), "imbalance": round(imbalance, 4),
            "balance": float(balance), "balance_cap": cap,
            "imbalance_raw": round(imbalance_raw, 4),
            # the JAX package's live-update bookkeeping, kept so its
            # update() extends an index the port built
            "built_num_vectors": int(N),
            "appended_since_build": 0,
            "index_generation": 0,
            "build_seconds": round(time.perf_counter() - t0, 3),
            "centroids": {"file": "centroids.npy", "bytes": cb, "crc": cc},
            "shards": shards_meta,
        }
        if pq_section is not None:
            manifest["pq"] = pq_section
        _atomic_dump(manifest, os.path.join(d, MANIFEST))
        index = cls(store, manifest, centroids, postings, pq=codec,
                    device=dev)
        index.build_stats = {**split, "seconds": time.perf_counter() - t0}
        return index

    @classmethod
    def build_from_config(cls, store, cfg,
                          device: DeviceLike = None) -> "IVFIndex":
        """``build`` with the knobs of `cfg`: serve.nlist, kmeans_iters,
        kmeans_init, kmeans_balance, pq_m, pq_iters and pq_opq_iters, seeded
        by data.seed (the JAX package's `cli.py index` reads the same)."""
        sv = cfg.serve
        return cls.build(store, nlist=sv.nlist, iters=sv.kmeans_iters,
                         seed=cfg.data.seed, init=sv.kmeans_init,
                         balance=sv.kmeans_balance, pq_m=sv.pq_m,
                         pq_iters=sv.pq_iters, opq_iters=sv.pq_opq_iters,
                         device=device)

    # -- incremental update ------------------------------------------------
    @classmethod
    def update(cls, store, rebuild_drift: float = 0.25, nlist: int = 0,
               iters: int = 8, seed: Optional[int] = None,
               chunk: int = 8192, init: str = "kmeans++",
               defer_rebuild: bool = False, device: DeviceLike = None
               ) -> Tuple["IVFIndex", Dict]:
        """Bring the index up to date with the store after an append, on
        `device`: assign ONLY the shards the recorded table does not hold
        to the existing centroids, write their posting files (and, on a
        PQ index, their codes under the existing rotation and codebooks),
        then dump the manifest atomically with ``index_generation`` + 1.

        Rebuilds in full (fresh k-means, ``index_generation`` 0, the
        recorded balance and PQ settings kept) when the index cannot be
        extended: none on disk, a torn manifest, another model step or
        dim, a recorded shard changed or gone, a file that fails its
        check, or a drift past `rebuild_drift`. Returns (index, info),
        info["action"] "noop" | "incremental" | "rebuild" with the inputs
        of the decision.

        `defer_rebuild` moves full rebuilds OFF this caller (the
        background rebuild's hand-off): past the drift the new shards
        are still appended (new pages serve now) and
        ``info["rebuild_pending"]`` is set; a structural reason (no index,
        a torn or stale one, a changed shard table) raises
        IndexUnavailable instead of rebuilding, so the caller serves exact
        until the background rebuild swaps a fresh index in."""
        t0 = time.perf_counter()
        dev = resolve_device(device)
        d = index_dir(store)
        mpath = os.path.join(d, MANIFEST)

        def _rebuild(reason: str, man: Optional[Dict] = None
                     ) -> Tuple["IVFIndex", Dict]:
            if defer_rebuild:
                raise IndexUnavailable(
                    f"rebuild deferred to the background worker ({reason})")
            pq_cfg = (man or {}).get("pq") or {}
            idx = cls.build(store, nlist=nlist, iters=iters,
                            seed=0 if seed is None else seed, chunk=chunk,
                            init=init,
                            balance=(man or {}).get("balance", 0.0),
                            pq_m=pq_cfg.get("m", 0),
                            pq_iters=pq_cfg.get("iters", 8),
                            opq_iters=pq_cfg.get("opq_iters", 3),
                            device=dev)
            telemetry.default_registry().event(
                "ivf_rebuild", {"reason": reason[:200], "nlist": idx.nlist})
            return idx, {"action": "rebuild", "reason": reason,
                         "seconds": round(time.perf_counter() - t0, 3)}

        if not os.path.exists(mpath):
            return _rebuild("no index on disk")
        try:
            with open(mpath) as f:
                man = json.load(f)
        except ValueError:
            return _rebuild("torn index manifest")
        if (man.get("model_step") != store.model_step
                or man.get("dim") != store.dim):
            return _rebuild("model step / dim changed", man)
        live = store.shards()
        live_by_idx = {s["index"]: s["count"] for s in live}
        recorded = {s["index"]: s["count"] for s in man.get("shards", [])}
        if any(recorded.get(i) != c for i, c in live_by_idx.items()
               if i in recorded) or any(i not in live_by_idx
                                        for i in recorded):
            return _rebuild("recorded shards changed (quarantine/re-embed)",
                            man)
        new_entries = [e for e in live if e["index"] not in recorded]
        if not new_entries:
            return (cls.open(store, device=dev),
                    {"action": "noop",
                     "seconds": round(time.perf_counter() - t0, 3)})
        try:
            cls._verify_files(d, man)      # never extend corrupt postings
        except IndexUnavailable as e:
            return _rebuild(f"existing index unhealthy ({e})", man)
        total = store.num_vectors
        appended = (int(man.get("appended_since_build", 0))
                    + sum(e["count"] for e in new_entries))
        drift = appended / max(total, 1)
        rebuild_pending = False
        if drift > rebuild_drift:
            if not defer_rebuild:
                return _rebuild(
                    f"drift {drift:.3f} > rebuild_drift {rebuild_drift}",
                    man)
            # deferred: extend anyway (new pages serve now; the stale
            # centroids cost bounded recall until the background rebuild)
            rebuild_pending = True
        centroids = np.asarray(
            np.load(os.path.join(d, man["centroids"]["file"])), np.float32)
        new_meta, _, new_sizes, _ = cls._assign_postings(
            d, store, centroids, new_entries, chunk, dev)
        if man.get("pq"):
            codec = PQCodec(
                np.load(os.path.join(d, man["pq"]["rotation"]["file"])),
                np.load(os.path.join(d, man["pq"]["codebooks"]["file"])))
            cls._encode_codes(d, store, codec, new_meta, dev)
        man["shards"] = sorted(man["shards"] + new_meta,
                               key=lambda s: s["index"])
        man["num_vectors"] = int(total)
        man["appended_since_build"] = appended
        man["index_generation"] = int(man.get("index_generation", 0)) + 1
        # imbalance over every list: the old sizes from the [nlist + 1]
        # offset files, the new from the assignment just made
        sizes = new_sizes.astype(np.float64)
        new_idx = {m["index"] for m in new_meta}
        for s in man["shards"]:
            if s["count"] == 0 or s["index"] in new_idx:
                continue
            sizes += np.diff(np.load(os.path.join(d, s["off"])))
        man["imbalance"] = round(
            float(man["nlist"] * np.square(sizes).sum()
                  / max(total, 1) ** 2), 4)
        _atomic_dump(man, mpath)
        return (cls.open(store, verify=False, device=dev),
                {"action": "incremental", "new_shards": len(new_entries),
                 "appended_rows": sum(e["count"] for e in new_entries),
                 "drift": round(drift, 4),
                 "rebuild_pending": rebuild_pending,
                 "index_generation": man["index_generation"],
                 "seconds": round(time.perf_counter() - t0, 3)})

    # -- the hot posting set -----------------------------------------------
    def stage_hot(self, budget_bytes: float) -> Dict:
        """Stage the most probed lists of a PQ index on the index's device
        until `budget_bytes` (m code bytes and a 4-byte list id a row) runs
        out: their codes, their list ids (-2 for a row dead at staging, so
        a restage follows the store's tombstones) and their attribute
        words, with the page ids and (shard, row) of each staged row kept
        on the host for the re-rank. Lists are ranked by ``scan_counts``
        (size breaking ties), or by size while the table is empty; a list
        that does not fit is skipped, and a smaller one may still fit.
        The table is halved after the ranking, so each restage sees a
        decayed window of recent traffic. The staged state is published
        with one assignment: a search in flight keeps the one it took.
        Returns hot_lists, hot_rows, hot_bytes and hot_by_popularity."""
        if self.pq is None:
            raise ValueError("stage_hot needs a PQ index (build with pq_m)")
        per_row = self.pq.m + 4                 # code bytes + list id
        resident = np.zeros((self.nlist,), bool)
        used = 0
        counts = np.asarray(self.scan_counts)
        by_popularity = bool(counts.sum() > 0)
        if by_popularity:
            order = np.lexsort((-self.list_sizes, -counts))
        else:
            order = np.argsort(-self.list_sizes, kind="stable")
        self.scan_counts = counts >> 1
        for c in order:
            need = int(self.list_sizes[c]) * per_row
            if self.list_sizes[c] == 0 or used + need > budget_bytes:
                continue
            resident[int(c)] = True
            used += need
        ids, cent, sh, rw, codes = self._gather(np.nonzero(resident)[0],
                                                codes=True)
        n = int(codes.shape[0])
        if n == 0:
            self._hot = None
            return {"hot_lists": 0, "hot_rows": 0, "hot_bytes": 0,
                    "hot_by_popularity": by_popularity}
        # the words ride along, so a predicate masks resident rows on the
        # card instead of sending their lists back to the host gather
        words = np.zeros((n,), np.uint32)
        for sidx in np.unique(sh):
            m_ = sh == sidx
            words[m_] = self._shard_attrs(int(sidx))[rw[m_]]
        self._hot = {
            "lists": resident, "rows": n, "bytes": used,
            "codes": self._dev(codes), "cent": self._dev(cent),
            "attrs": words_tensor(words, self.device),
            "ids": ids, "shard": sh, "row": rw}
        return {"hot_lists": int(resident.sum()), "hot_rows": n,
                "hot_bytes": used, "hot_by_popularity": by_popularity}

    # -- partitioned serving (infer/partition.py) -------------------------
    def partition_view(self, shard_indices) -> "IVFIndex":
        """A serving view of this index restricted to one partition's
        shard range: the same manifest, centroids and PQ codec, but only
        the listed shards' posting files, so ``search`` gathers candidates
        from exactly the partition's slice of the inverted file and
        ``stage_hot`` pins only its rows. The centroid scan stays global
        (the [nlist, D] matrix is small and the same everywhere); the list
        accounting (``list_sizes``, ``stats``, ``scan_counts``) is fresh
        and local to the partition. The mmap caches are lazy per view, so
        a partition never touches a sibling's shard files."""
        keep = {int(s) for s in shard_indices}
        return IVFIndex(self.store, self.manifest, self.centroids,
                        {s: p for s, p in self._postings.items()
                         if s in keep}, pq=self.pq, device=self.device)

    # -- open / verify -----------------------------------------------------
    @classmethod
    def open(cls, store, verify: bool = True,
             device: DeviceLike = None) -> "IVFIndex":
        """Load the index of `store`, re-checking its stamp, its shard table
        and (with `verify`) every file's bytes and CRC32. Raises
        IndexUnavailable with the reason on any mismatch; a corrupt file is
        quarantined first."""
        d = index_dir(store)
        mpath = os.path.join(d, MANIFEST)
        if not os.path.exists(mpath):
            raise IndexUnavailable(f"no IVF index at {d} (build one with "
                                   "IVFIndex.build)")
        try:
            with open(mpath) as f:
                man = json.load(f)
        except ValueError:
            q = mpath + ".quarantined"
            os.replace(mpath, q)
            print(f"WARNING: IVF manifest {mpath} is torn (invalid JSON); "
                  f"moved aside to {q}", flush=True)
            raise IndexUnavailable(f"torn IVF manifest (quarantined to {q})")
        if man.get("model_step") != store.model_step:
            raise IndexUnavailable(
                f"stale IVF index: built at model step "
                f"{man.get('model_step')}, store is stamped "
                f"{store.model_step} (rebuild after re-embedding)")
        if man.get("dim") != store.dim:
            raise IndexUnavailable(
                f"stale IVF index: built for {man.get('dim')}-d vectors, "
                f"store holds {store.dim}-d")
        live = {s["index"]: s["count"] for s in store.shards()}
        recorded = {s["index"]: s["count"] for s in man.get("shards", [])}
        if live != recorded:
            raise IndexUnavailable(
                "stale IVF index: store shard table changed since the "
                f"build ({len(recorded)} recorded vs {len(live)} live "
                "shards or row counts differ); rebuild")
        if verify:
            cls._verify_files(d, man)
        centroids = np.load(os.path.join(d, man["centroids"]["file"]))
        postings: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for s in man["shards"]:
            if s["count"] == 0:
                continue
            postings[s["index"]] = (np.load(os.path.join(d, s["ord"])),
                                    np.load(os.path.join(d, s["off"])))
        codec = None
        if man.get("pq"):
            codec = PQCodec(
                np.load(os.path.join(d, man["pq"]["rotation"]["file"])),
                np.load(os.path.join(d, man["pq"]["codebooks"]["file"])))
        return cls(store, man, np.asarray(centroids, np.float32), postings,
                   pq=codec, device=device)

    @staticmethod
    def _verify_files(d: str, man: Dict) -> None:
        files = [(man["centroids"]["file"], man["centroids"]["bytes"],
                  man["centroids"]["crc"])]
        for key in ("rotation", "codebooks"):
            rec = man.get("pq", {}).get(key)
            if rec is not None:
                files.append((rec["file"], rec["bytes"], rec["crc"]))
        for s in man["shards"]:
            if s["count"] == 0:
                continue
            for key in ("ord", "off") + (("pqc",) if "pqc" in s else ()):
                files.append((s[key], s["bytes"][key], s["crc"][key]))
        for name, want_bytes, want_crc in files:
            path = os.path.join(d, name)
            err = None
            if not os.path.exists(path):
                err = "missing"
            elif os.path.getsize(path) != want_bytes:
                err = (f"{os.path.getsize(path)} bytes, manifest records "
                       f"{want_bytes} (truncated?)")
            elif crc_file(path) != want_crc:
                err = "CRC mismatch (corrupt)"
            if err is None:
                continue
            if err != "missing":
                os.replace(path, path + ".quarantined")
                print(f"WARNING: quarantined IVF index file {path} ({err}); "
                      "exact search serves until a rebuild", flush=True)
            raise IndexUnavailable(
                f"IVF index file {name} {err}; rebuild the index")

    # -- gathers -----------------------------------------------------------
    def _shard_raw(self, sidx: int):
        raw = self._raw.get(sidx)
        if raw is None:
            raw = self._raw[sidx] = self.store._load_entry(
                self._entries[sidx], raw=True)
        return raw

    def _codes_raw(self, sidx: int) -> np.ndarray:
        arr = self._codes.get(sidx)
        if arr is None:
            arr = self._codes[sidx] = np.load(
                os.path.join(index_dir(self.store), self._meta[sidx]["pqc"]),
                mmap_mode="r")
        return arr

    def _shard_attrs(self, sidx: int) -> np.ndarray:
        """One shard's attribute words (uint32 [count]; zeros for a shard
        written before the store's attribute table): the input of the
        filtered prefilter."""
        arr = self._attrs.get(sidx)
        if arr is None:
            arr = self._attrs[sidx] = self.store.load_attrs(
                self._entries[sidx])
        return arr

    def _gather(self, cents: np.ndarray, codes: bool = False,
                predicate=None):
        """The candidate block of the probed lists `cents`: their rows in
        every shard, grouped by shard in ascending order. Returns (page_ids
        [C] i64, cand_cent [C] i32, src_shard [C] i32, src_row [C] i32) and
        the payload of ``_fetch_rows``: PQ codes (`codes`) or stored-width
        rows and scales. A dead row (id -1) gets list -2, which no probed
        list matches. A `predicate` drops the rows whose attribute word
        does not match before their ids or payload are read."""
        i_parts, c_parts, sh_parts, rw_parts = [], [], [], []
        for sidx in sorted(self._postings):
            order, offsets = self._postings[sidx]
            rows = [order[offsets[c]: offsets[c + 1]] for c in cents]
            lens = np.array([r.shape[0] for r in rows], np.int64)
            if lens.sum() == 0:
                continue
            take = np.concatenate(rows)
            cent = np.repeat(np.asarray(cents, np.int32), lens)
            if predicate is not None:
                keep = predicate.matches(self._shard_attrs(sidx)[take])
                if not keep.any():
                    continue
                take, cent = take[keep], cent[keep]
            taken_ids = np.asarray(self._shard_raw(sidx)[0][take], np.int64)
            i_parts.append(taken_ids)
            c_parts.append(np.where(taken_ids >= 0, cent, np.int32(-2)))
            sh_parts.append(np.full((take.shape[0],), sidx, np.int32))
            rw_parts.append(take.astype(np.int32))
        if i_parts:
            cols = tuple(np.concatenate(p) for p in
                         (i_parts, c_parts, sh_parts, rw_parts))
        else:
            cols = (np.zeros((0,), np.int64),) + tuple(
                np.zeros((0,), np.int32) for _ in range(3))
        return cols + self._fetch_rows(cols[2], cols[3], codes)

    def _fetch_rows(self, src_shard: np.ndarray, src_row: np.ndarray,
                    codes: bool = False):
        """The payload of the (shard, row) pairs, `src_shard` ascending:
        (PQ codes [U, m] uint8,) with `codes`, else (rows [U, D] at stored
        width, int8 scales [U] or None) straight off the mmaps. The
        candidate gather's payload, and the re-rank's gather of the ADC
        survivors."""
        cuts = np.flatnonzero(np.diff(src_shard)) + 1
        parts, s_parts = [], []
        for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, src_shard.shape[0]]):
            if lo == hi:
                continue                        # no pairs at all
            sidx, take = int(src_shard[lo]), src_row[lo:hi]
            if codes:
                parts.append(np.asarray(self._codes_raw(sidx)[take]))
                continue
            _, vecs, scl = self._shard_raw(sidx)
            parts.append(np.asarray(vecs[take]))
            if scl is not None:
                s_parts.append(np.asarray(scl[take]))
        if codes:
            return (np.concatenate(parts) if parts
                    else np.zeros((0, self.pq.m), np.uint8),)
        if not parts:
            return np.zeros((0, self.store.dim), np.float16), None
        return (np.concatenate(parts),
                np.concatenate(s_parts) if s_parts else None)

    # -- search ------------------------------------------------------------
    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return to_device(arr, self.device)

    def search(self, qvecs: np.ndarray, k: int, nprobe: Optional[int] = None,
               block: int = 256, rerank: Optional[int] = None,
               predicate=None, escalate: float = 4.0
               ) -> Tuple[np.ndarray, np.ndarray, Dict[str, int]]:
        """ANN top-k of qvecs [Nq, D]: (scores [Nq, k] float32, page_ids
        [Nq, k] int64, -inf / -1 where fewer than k rows were found,
        stats); see ``_search_once``. A `predicate` (index/attrs.py)
        restricts the results to matching rows, dropped from the posting
        gathers before any payload moves. A filtered probe set can leave a
        query short of k (its matches lie in lists it did not probe):
        with `escalate` > 1 the short queries search again with nprobe
        times `escalate` a round until they fill or every list is probed,
        counted in stats["filter_escalations"] and the
        ivf.filter_escalations counter."""
        out_s, out_i, stats = self._search_once(
            qvecs, k, nprobe=nprobe, block=block, rerank=rerank,
            predicate=predicate)
        if predicate is None or not escalate or escalate <= 1:
            return out_s, out_i, stats
        np_eff = int(min(max(1, nprobe or 1), self.nlist))
        k = int(min(k, max(out_i.shape[1], 1)))
        while np_eff < self.nlist:
            need = (out_i >= 0).sum(axis=1) < k
            if not need.any():
                break
            np_eff = int(min(self.nlist,
                             max(np_eff + 1, math.ceil(np_eff * escalate))))
            s2, i2, st2 = self._search_once(
                np.asarray(qvecs, np.float32)[need], k, nprobe=np_eff,
                block=block, rerank=rerank, predicate=predicate)
            out_s[need], out_i[need] = s2, i2
            n_esc = int(need.sum())
            stats["filter_escalations"] = (
                stats.get("filter_escalations", 0) + n_esc)
            self.stats["filter_escalations"] = (
                self.stats.get("filter_escalations", 0) + n_esc)
            telemetry.default_registry().counter(
                "ivf.filter_escalations").inc(n_esc)
            for key in ("lists_scanned", "candidates_reranked",
                        "gather_bytes", "reranked_rows", "hot_rows_scored"):
                if key in st2:
                    stats[key] = stats.get(key, 0) + st2[key]
        return out_s, out_i, stats

    def _search_once(self, qvecs: np.ndarray, k: int,
                     nprobe: Optional[int] = None, block: int = 256,
                     rerank: Optional[int] = None, predicate=None
                     ) -> Tuple[np.ndarray, np.ndarray, Dict[str, int]]:
        """One ANN pass. The probed lists come from one top-`nprobe` of the
        centroids on the card (and add to ``scan_counts``); the queries
        then go in blocks of `block`, each one gather of the union of its
        probed lists and one re-rank (or, on a PQ index, ADC over the codes
        and an exact re-rank of each query's top `rerank` survivors,
        default max(8k, 64)). stats: searches, lists_scanned,
        candidates_reranked (the probed lists' rows), gather_bytes (store
        payload moved: rows at stored width, or codes plus the survivors'
        rows; a predicate's rejected rows move none) and, on PQ,
        reranked_rows and hot_rows_scored; they are also added into
        ``self.stats``."""
        qvecs = np.asarray(qvecs, np.float32)
        nq = qvecs.shape[0]
        k = int(k)
        out_s = np.full((nq, k), -np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        if nq == 0:
            return out_s, out_i, {}
        nprobe = int(min(max(1, nprobe or 1), self.nlist))
        if self._dev_centroids is None:
            self._dev_centroids = self._dev(self.centroids)
        q_dev = self._dev(qvecs)
        _, sel_dev = chunked_topk(q_dev, self._dev_centroids, k=nprobe)
        sel = sel_dev.cpu().numpy().astype(np.int32)
        # the popularity table: one count a (query, probed list)
        self.scan_counts += np.bincount(sel.ravel(), minlength=self.nlist)
        stats = {"searches": nq, "lists_scanned": nq * nprobe,
                 "candidates_reranked": int(self.list_sizes[sel].sum()),
                 "gather_bytes": 0}
        if self.pq is not None:
            return self._search_adc(q_dev, sel, sel_dev, k, block, rerank,
                                    out_s, out_i, stats, predicate)
        pending = []       # re-ranks run on the card while the host gathers
        for s in range(0, nq, block):
            e = min(s + block, nq)
            cids, ccent, _, _, cand, scl = self._gather(
                np.unique(sel[s:e]), predicate=predicate)
            stats["gather_bytes"] += cand.shape[0] * self.store.row_bytes
            if cand.shape[0] == 0:
                continue
            top = rerank_candidates(
                q_dev[s:e], self._dev(cand),
                None if scl is None else self._dev(scl),
                self._dev(ccent), sel_dev[s:e], k)
            pending.append((s, e, top, cids))
        for s, e, (top_s, pos), cids in pending:
            top_s, pos = top_s.cpu().numpy(), pos.cpu().numpy()
            kk = pos.shape[1]
            out_i[s:e, :kk] = np.where(
                pos >= 0, cids[np.clip(pos, 0, None)], -1)
            out_s[s:e, :kk] = np.where(pos >= 0, top_s, -np.inf)
        for key, val in stats.items():
            self.stats[key] = self.stats.get(key, 0) + val
        return out_s, out_i, stats

    def _search_adc(self, q_dev: torch.Tensor, sel: np.ndarray,
                    sel_dev: torch.Tensor, k: int, block: int,
                    rerank: Optional[int], out_s: np.ndarray,
                    out_i: np.ndarray, stats: Dict, predicate=None
                    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, int]]:
        """The PQ block loop: gather the codes of the probed lists that are
        not in the hot set, the ADC tables on the card (``PQCodec.lut``),
        the running top-r of ADC scores masked to each query's lists
        (``adc_topr``) over those codes and, apart, over the staged hot
        codes (a predicate masks the staged rows on the card: their list
        id becomes -2), the two sets of survivors merged into the top r
        (a stable sort), then the union of the queries' survivors fetched
        at stored width and re-ranked exactly (``rerank_positions``) for
        the final top-k. A row scores the same from either buffer:
        ``adc_topr`` adds the subspaces in one fixed order."""
        nq = q_dev.shape[0]
        r = max(int(rerank) if rerank else max(8 * k, 64), k)
        m = self.pq.m
        hot = self._hot               # the residency this search keeps
        hmask = None
        if hot is not None and predicate is not None:
            hmask = torch.where(predicate.matches_device(hot["attrs"]),
                                hot["cent"], torch.full_like(hot["cent"],
                                                             -2))
        for s in range(0, nq, block):
            e = min(s + block, nq)
            sel_b = sel[s:e]
            cents = np.unique(sel_b)
            if hot is not None:
                cents = cents[~hot["lists"][cents]]
            cids, ccent, csh, crw, codes = self._gather(
                cents, codes=True, predicate=predicate)
            C = codes.shape[0]
            stats["gather_bytes"] += C * m
            q_blk = q_dev[s:e]
            lut = None
            parts = []            # (scores, page ids, src shard, src row)
            if C:
                lut = self.pq.lut(q_blk)
                cs, cpos = adc_topr(lut, self._dev(codes), self._dev(ccent),
                                    sel_dev[s:e], r=r)
                cs, cpos = cs.cpu().numpy(), cpos.cpu().numpy()
                ok = cpos >= 0
                idx = np.clip(cpos, 0, C - 1)
                parts.append((np.where(ok, cs, -np.inf),
                              np.where(ok, cids[idx], -1),
                              np.where(ok, csh[idx], -1),
                              np.where(ok, crw[idx], -1)))
            if hot is not None:
                if lut is None:
                    lut = self.pq.lut(q_blk)
                hs, hpos = adc_topr(
                    lut, hot["codes"], hot["cent"] if hmask is None
                    else hmask, sel_dev[s:e], r=r)
                hs, hpos = hs.cpu().numpy(), hpos.cpu().numpy()
                ok = hpos >= 0
                idx = np.clip(hpos, 0, hot["rows"] - 1)
                parts.append((np.where(ok, hs, -np.inf),
                              np.where(ok, hot["ids"][idx], -1),
                              np.where(ok, hot["shard"][idx], -1),
                              np.where(ok, hot["row"][idx], -1)))
                res = hot["lists"][sel_b]
                stats["hot_rows_scored"] = stats.get(
                    "hot_rows_scored", 0) + int(
                        self.list_sizes[sel_b][res].sum())
            if not parts:
                continue                        # out stays -inf / -1
            scores, pids, shm, rwm = (np.concatenate(c, axis=1)
                                      for c in zip(*parts))
            if scores.shape[1] > r:             # merge hot + cold survivors
                ordx = np.argsort(-scores, axis=1, kind="stable")[:, :r]
                scores, pids, shm, rwm = (np.take_along_axis(a, ordx, axis=1)
                                          for a in (scores, pids, shm, rwm))
            ok = np.isfinite(scores) & (pids >= 0)
            key = np.where(ok, shm.astype(np.int64) * (1 << 32)
                           + rwm.astype(np.int64), np.int64(-1))
            uniq = np.unique(key[ok])
            if uniq.size == 0:
                continue
            rows, scl = self._fetch_rows(
                (uniq >> 32).astype(np.int32),
                (uniq & 0xFFFFFFFF).astype(np.int32))
            stats["gather_bytes"] += int(uniq.size) * self.store.row_bytes
            stats["reranked_rows"] = (stats.get("reranked_rows", 0)
                                      + int(ok.sum()))
            pos = np.where(ok, np.searchsorted(uniq, key), -1)
            uids = np.full((uniq.size,), -1, np.int64)
            uids[pos[ok]] = pids[ok]            # union row -> page id
            top_s, top_pos = rerank_positions(
                q_blk, self._dev(rows),
                None if scl is None else self._dev(scl),
                self._dev(pos.astype(np.int64)), k)
            top_s, top_pos = top_s.cpu().numpy(), top_pos.cpu().numpy()
            kk = top_pos.shape[1]
            out_i[s:e, :kk] = np.where(
                top_pos >= 0, uids[np.clip(top_pos, 0, None)], -1)
            out_s[s:e, :kk] = np.where(top_pos >= 0, top_s, -np.inf)
        for key_, val in stats.items():
            self.stats[key_] = self.stats.get(key_, 0) + val
        return out_s, out_i, stats
