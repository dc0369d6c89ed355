"""Generation compaction, the port's copy of the JAX package's
maintenance/compact.py.

Tombstones mask dead rows when they are read; nothing reclaims their
bytes. ``compact_store`` folds the chain back down:

  * every live row (id not tombstoned) of the base and the intact chain
    is gathered at its stored width (int8 codes and scales, or float16
    rows: no requantization, so the fold is lossless and the same inputs
    give the same bytes), sorted by page id and re-sharded into fresh
    shards under ``<store>/compact-EEEE/`` by the store's own writer
    (byte sizes and CRC32s recorded);
  * the swap is one atomic dump of the main manifest: its shard table
    becomes the compacted entries, ``compacted_through`` records the
    folded epoch, and ``append_cursor`` pins the id high-water mark (a
    tombstoned top id must never be re-issued). A failure before it
    leaves the old chain whole; after it, the new base;
  * ids are kept, and generation numbers stay monotonic: the next append
    opens ``compacted_through + 1``.

Old files are not deleted at the swap (a serving view may still read
them): ``purge_stale(store, stats)`` removes them once no reader holds
the old view. The changed shard table makes an IVF index stale, and the
next ``IVFIndex.update`` rebuilds it. The compaction is host work; it
touches no device.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Dict

import numpy as np

from dnn_page_vectors_tpu_torch.utils import faults, telemetry


def _entry_bytes(entry: Dict) -> int:
    return sum(int(b) for b in entry.get("bytes", {}).values())


def compaction_due(store, cfg) -> bool:
    """The JAX maintenance service's trigger: the chain holds a generation
    past the last compaction and its tombstone density has reached
    ``maintenance.compact_tombstone_density``."""
    ms = store.maintenance_stats()
    return (store.chain_generation > store.compacted_through
            and ms["tombstone_density"]
            >= cfg.maintenance.compact_tombstone_density)


def compact_store(store, registry=None) -> Dict:
    """Fold the chain and the base into a compacted base and swap it in.
    Returns the stats (action, epoch, rows, dead rows dropped, bytes
    before and after, seconds, and the stale dirs and files
    ``purge_stale`` removes); a store with no generation to fold returns
    {"action": "noop", ...}."""
    t0 = time.perf_counter()
    if store._writer_files():
        raise ValueError(
            f"store at {store.directory} has live writer manifests (an "
            "embed fleet is mid-flight); compact after merge_writers()")
    if store.migration is not None:
        # folding would merge shards of different stamps into one output
        # shard; the migration owns the store until its completion flip
        return {"action": "noop", "reason": "migration in flight",
                "generation": store.generation}
    prev_epoch = store.compacted_through
    epoch = store.chain_generation
    if epoch <= prev_epoch:
        return {"action": "noop", "reason": "no generations to fold",
                "generation": epoch}
    old_entries = store.shards()
    old_bytes = sum(_entry_bytes(e) for e in old_entries)
    cursor_before = store.next_page_id()

    # pass 1: (page id, source entry, source row) of every stored row, the
    # tombstones applied through load_ids
    ids_parts, src_parts, row_parts = [], [], []
    for pos, entry in enumerate(old_entries):
        ids = np.asarray(store.load_ids(entry), np.int64)
        ids_parts.append(ids)
        src_parts.append(np.full(ids.shape, pos, np.int32))
        row_parts.append(np.arange(ids.shape[0], dtype=np.int64))
    all_ids = (np.concatenate(ids_parts) if ids_parts
               else np.zeros((0,), np.int64))
    src = (np.concatenate(src_parts) if src_parts
           else np.zeros((0,), np.int32))
    rows = (np.concatenate(row_parts) if row_parts
            else np.zeros((0,), np.int64))
    live = all_ids >= 0
    dead_rows = int((~live).sum())
    ids_l, src_l, row_l = all_ids[live], src[live], rows[live]
    order = np.argsort(ids_l, kind="stable")
    ids_l, src_l, row_l = ids_l[order], src_l[order], row_l[order]
    if ids_l.size and (np.diff(ids_l) == 0).any():
        raise RuntimeError(
            "duplicate live page id found while compacting: the store's "
            "update invariant (old rows tombstoned) is broken; refusing "
            "to fold")

    # pass 2: gather and rewrite one output shard at a time (host memory
    # O(shard); the sources are memory-mapped)
    subdir = f"compact-{epoch:04d}"
    d = os.path.join(store.directory, subdir)
    if os.path.isdir(d):
        # an earlier attempt that never swapped: invisible, cleared
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d, exist_ok=True)
    is_int8 = store.manifest["dtype"] == "int8"
    raw_cache: Dict[int, tuple] = {}

    def _raw(pos: int):
        got = raw_cache.get(pos)
        if got is None:
            _, vecs, scl = store._load_entry(old_entries[pos], raw=True)
            got = raw_cache[pos] = (vecs, scl)
        return got

    # the attribute words ride the fold as they are: compaction moves
    # rows, and a shard written before the table gives its all-zero words
    has_attrs = store.attrs_enabled
    attrs_cache: Dict[int, np.ndarray] = {}

    def _attr_words(pos: int) -> np.ndarray:
        got = attrs_cache.get(pos)
        if got is None:
            got = attrs_cache[pos] = store.load_attrs(old_entries[pos])
        return got

    plan = faults.active()
    new_entries = []
    next_idx = store._next_shard_index()
    ss = store.manifest["shard_size"]
    for s0 in range(0, ids_l.size, ss):
        ids_c = ids_l[s0: s0 + ss]
        src_c = src_l[s0: s0 + ss]
        row_c = row_l[s0: s0 + ss]
        n = int(ids_c.size)
        data = np.empty((n, store.dim), np.int8 if is_int8 else np.float16)
        scl_c = np.empty((n,), np.float16) if is_int8 else None
        atr_c = np.empty((n,), np.uint32) if has_attrs else None
        for pos in np.unique(src_c):
            m = src_c == pos
            vecs, scl = _raw(int(pos))
            data[m] = np.asarray(vecs[row_c[m]])
            if scl_c is not None:
                scl_c[m] = np.asarray(scl[row_c[m]])
            if atr_c is not None:
                atr_c[m] = _attr_words(int(pos))[row_c[m]]
        plan.check("compact_write")
        if is_int8:
            entry = store._write_shard_files(subdir, next_idx, ids_c,
                                             None, data, scl_c,
                                             attrs=atr_c)
        else:
            entry = store._write_shard_files(subdir, next_idx, ids_c,
                                             data, None, None,
                                             attrs=atr_c)
        entry["gen"] = epoch         # masked only by LATER tombstones
        entry["id_lo"] = int(ids_c.min())
        entry["id_hi"] = int(ids_c.max()) + 1
        new_entries.append(entry)
        next_idx += 1

    # the swap: one atomic manifest dump moves every reader to the new base
    man = dict(store.manifest)
    man["shards"] = new_entries
    man["compacted_through"] = epoch
    man.pop("gen_overrides", None)
    man["append_cursor"] = max(int(man.get("append_cursor", 0)),
                               cursor_before)
    store._atomic_dump(man, store._manifest_path, op="compact_swap")
    store.manifest = man
    store._load_generations()        # the chain resumes past the epoch

    # left for purge_stale, after readers moved: the folded generation
    # dirs, earlier compact dirs and the base files the manifest dropped
    stale_dirs = [store._gen_path(g) for g in range(prev_epoch + 1,
                                                    epoch + 1)]
    old_subdirs = {os.path.dirname(e[k]) for e in old_entries
                   for k in ("vec", "ids", "scl", "atr") if k in e}
    stale_dirs += [os.path.join(store.directory, sd)
                   for sd in sorted(old_subdirs - {"", subdir})
                   if sd.startswith(("compact-", "migrate-"))]
    stale_files = [os.path.join(store.directory, e[k])
                   for e in old_entries
                   for k in ("vec", "ids", "scl", "atr")
                   if k in e and os.path.dirname(e[k]) == ""]
    new_bytes = sum(_entry_bytes(e) for e in new_entries)
    seconds = time.perf_counter() - t0
    stats = {
        "action": "compacted",
        "epoch": epoch,
        "rows": int(ids_l.size),
        "dead_rows_dropped": dead_rows,
        "generations_folded": epoch - prev_epoch,
        "shards": len(new_entries),
        "store_bytes_before": old_bytes,
        "store_bytes_after": new_bytes,
        "bytes_reclaimed": max(0, old_bytes - new_bytes),
        "seconds": round(seconds, 3),
        "compact_docs_per_s": round(ids_l.size / max(seconds, 1e-9), 2),
        "stale_dirs": stale_dirs,
        "stale_files": stale_files,
    }
    reg = registry or telemetry.default_registry()
    reg.counter("maintenance.compactions").inc()
    reg.counter("maintenance.compact_bytes_reclaimed").inc(
        stats["bytes_reclaimed"])
    reg.gauge("maintenance.compact_docs_per_s").set(
        stats["compact_docs_per_s"])
    reg.event("compaction", {
        "epoch": epoch, "rows": stats["rows"],
        "dead_rows_dropped": dead_rows,
        "bytes_reclaimed": stats["bytes_reclaimed"],
        "seconds": stats["seconds"]})
    faults.count("store_compactions")
    return stats


def purge_stale(store, stats: Dict) -> Dict:
    """Remove the old chain's files after a compaction, once no reader
    holds the pre-swap view. Never touches a path the current manifest
    references, and never leaves the store directory."""
    referenced = {os.path.normpath(os.path.join(store.directory, e[k]))
                  for e in store.shards()
                  for k in ("vec", "ids", "scl", "atr") if k in e}
    removed_dirs, removed_files = 0, 0
    root = os.path.normpath(store.directory)
    for path in stats.get("stale_dirs", []):
        p = os.path.normpath(path)
        if not p.startswith(root + os.sep) or any(
                r.startswith(p + os.sep) for r in referenced):
            continue
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
            removed_dirs += 1
    for path in stats.get("stale_files", []):
        p = os.path.normpath(path)
        if not p.startswith(root + os.sep) or p in referenced:
            continue
        try:
            os.remove(p)
            removed_files += 1
        except OSError:
            pass
    return {"purged_dirs": removed_dirs, "purged_files": removed_files}
