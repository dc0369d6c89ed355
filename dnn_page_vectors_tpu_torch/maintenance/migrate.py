"""Rolling model migration, the port's copy of the JAX package's
maintenance/migrate.py (same manifest keys, directory names, op names,
counters and events, so a store one package leaves mid-sweep opens in the
other).

Re-embed a LIVE store to a new model step unit by unit while it serves:
the base shard table first (the oldest vectors), then each appended
generation in chain order. Every commit point is ONE atomic dump of the
MAIN manifest (op ``migrate_swap``), so a crash anywhere, the injected
``migrate_write`` / ``migrate_swap_dump`` / ``migrate_swap_file`` faults
included, leaves a serveable store on exactly one side of the flip:

  * ``begin()`` records ``{"migration": {from_step, to_step}}`` and bumps
    ``migration_epoch`` (folded into ``store.generation``, so every flip
    moves the number the refresh and the result-cache key gate on);
  * a unit's re-embedded shards land under ``migrate-<to_step>-<unit>/``
    (data files and fsync first), then commit atomically: the base unit
    by replacing its ``shards`` entries, a generation unit as a
    ``gen_overrides`` record (CRC-matched against the generation manifest
    on disk, ``VectorStore._gen_override``), so no crash window spans two
    manifests;
  * ``complete()`` drops the migration record and flips the store stamp
    once NO unit carries the old stamp. Appends that land mid-sweep are
    stamped with the old step by the GenerationWriter and become new
    pending units, so the sweep loops until the store drains.

A shard is re-embedded whole: one stamp a shard, never mixed within one
(``entry_step``). Mid-sweep the store serves BOTH stamps, and
infer/serve.py scores each shard with the query tower of its stamp.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from dnn_page_vectors_tpu_torch.utils import faults, telemetry

_FILES = ("vec", "ids", "scl", "atr")


def _entry_paths(store, entry: Dict) -> List[str]:
    return [os.path.join(store.directory, entry[k])
            for k in _FILES if k in entry]


class MigrationPlan:
    """One rolling migration of `store` to `to_step`.

    `corpus` supplies the page text (``page_text(i)``), `embedder` the NEW
    model's page tower (``embed_texts(texts, tower="page")``, float16
    rows); `batch_rows` bounds the texts a re-embed call takes. Drive it
    with ``run()`` (the CLI: sweep to completion) or a unit at a time with
    ``begin()`` / ``pending_units()`` / ``migrate_unit()`` / ``complete()``
    (the maintenance pillar, which hot-swaps the serving view between
    units)."""

    def __init__(self, store, corpus, embedder, to_step: int,
                 registry=None, batch_rows: int = 4096):
        self.store = store
        self.corpus = corpus
        self.embedder = embedder
        self.to_step = int(to_step)
        self.registry = registry or telemetry.default_registry()
        self.batch_rows = max(1, int(batch_rows))

    # -- lifecycle ---------------------------------------------------------
    def begin(self) -> Dict:
        """Record the migration in the main manifest. Resuming a migration
        to the same step flips nothing ({"action": "resumed"}); a store
        already at `to_step` returns {"action": "noop"}."""
        store = self.store
        if store._writer_files():
            raise ValueError(
                f"store at {store.directory} has live writer manifests (an "
                "embed fleet is mid-flight); migrate after merge_writers()")
        mig = store.migration
        if mig is not None:
            if int(mig.get("to_step", -1)) != self.to_step:
                raise ValueError(
                    f"a migration to step {mig.get('to_step')} is already "
                    f"in flight; finish it before migrating to "
                    f"{self.to_step}")
            return {"action": "resumed",
                    "from_step": int(mig.get("from_step", -1)),
                    "to_step": self.to_step}
        if store.model_step is None:
            raise ValueError(
                "store is unstamped (no model_step); run the base 'embed' "
                "before migrating")
        from_step = int(store.model_step)
        if from_step == self.to_step:
            return {"action": "noop", "reason": "store already at to_step",
                    "to_step": self.to_step}
        man = dict(store.manifest)
        man["migration"] = {"from_step": from_step, "to_step": self.to_step}
        man["migration_epoch"] = int(man.get("migration_epoch", 0)) + 1
        self._commit(man)
        self.registry.event("migration_started", {
            "from_step": from_step, "to_step": self.to_step,
            "units": len(self.pending_units()),
            "rows": store.num_vectors})
        return {"action": "started", "from_step": from_step,
                "to_step": self.to_step}

    def pending_units(self) -> List[int]:
        """Units still carrying another stamp, oldest first: 0 is the base
        shard table, g > 0 generation g."""
        store = self.store
        units: List[int] = []
        if any(store.entry_step(e) != self.to_step
               for e in store.manifest.get("shards", [])):
            units.append(0)
        for man in store.generations():
            if any(store.entry_step(e) != self.to_step
                   for e in man.get("shards", [])):
                units.append(int(man["gen"]))
        return units

    def migrate_unit(self, unit: int) -> Dict:
        """Re-embed every shard of one unit that carries another stamp and
        commit the unit with one atomic main-manifest flip. Returns the
        unit's stats with the superseded files (``stale_files``) for
        ``purge_stale``, which must run only AFTER the serving view moved
        over: a reader on the previous view may still map them."""
        store = self.store
        t0 = time.perf_counter()
        plan = faults.active()
        if unit == 0:
            src_entries = list(store.manifest.get("shards", []))
        else:
            mans = [m for m in store.generations()
                    if int(m["gen"]) == int(unit)]
            if not mans:
                raise ValueError(
                    f"generation {unit} is not in the live chain")
            src_entries = list(mans[0].get("shards", []))
        todo = [e for e in src_entries
                if store.entry_step(e) != self.to_step]
        if not todo:
            return {"action": "noop", "unit": int(unit), "rows": 0,
                    "stale_files": [], "stale_dirs": []}
        subdir = f"migrate-{self.to_step}-{int(unit):04d}"
        d = os.path.join(store.directory, subdir)
        self._clear_torn(d)
        os.makedirs(d, exist_ok=True)

        rows = 0
        new_by_index: Dict[int, Dict] = {}
        for e in todo:
            # the RAW ids on disk (not load_ids): row positions survive
            # byte for byte, so the rewritten shard keeps its index, count
            # and id range, and the tombstones keep masking at read time
            ids = np.load(os.path.join(store.directory, e["ids"]))
            vecs = self._embed_ids(ids)
            # the words describe the page, not its vector: the source
            # shard's words verbatim (all zero for a shard written before
            # the attribute table)
            words = store.load_attrs(e) if store.attrs_enabled else None
            plan.check("migrate_write")
            entry = store._write_shard_files(subdir, int(e["index"]), ids,
                                             vecs, None, None, attrs=words)
            for k in ("gen", "id_lo", "id_hi"):
                if k in e:
                    entry[k] = e[k]
            entry["model_step"] = self.to_step
            new_by_index[int(e["index"])] = entry
            rows += int(entry["count"])

        # THE unit's flip: one atomic main-manifest dump moves every reader
        # from the old-stamp shards to the re-embedded ones, and bumps
        # migration_epoch in the same write, so a cache entry keyed before
        # the flip never answers after it
        man = dict(store.manifest)
        man["migration_epoch"] = int(man.get("migration_epoch", 0)) + 1
        if unit == 0:
            man["shards"] = [new_by_index.get(int(e["index"]), e)
                             for e in src_entries]
        else:
            gpath = os.path.join(store._gen_path(int(unit)), "manifest.json")
            with open(gpath) as f:
                disk_man = json.load(f)
            ovs = dict(man.get("gen_overrides") or {})
            ovs[str(int(unit))] = {
                "src_vec_crc": [s.get("crc", {}).get("vec")
                                for s in disk_man.get("shards", [])],
                "shards": [dict(new_by_index.get(int(e["index"]), e))
                           for e in src_entries]}
            man["gen_overrides"] = ovs
        self._commit(man)

        dt = time.perf_counter() - t0
        pps = round(rows / max(dt, 1e-9), 2)
        total = 1 + len(store.generations())
        done = total - len(self.pending_units())
        reg = self.registry
        reg.gauge("migrate.generations_done").set(done)
        reg.gauge("migrate.pages_per_s").set(pps)
        reg.event("migration_generation_done", {
            "generation": int(unit), "shards": len(todo), "rows": rows,
            "seconds": round(dt, 3)})
        faults.count("store_migrate_units")
        return {"action": "migrated_unit", "unit": int(unit),
                "shards": len(todo), "rows": rows,
                "seconds": round(dt, 3), "migrate_pages_per_s": pps,
                "stale_files": [p for e in todo
                                for p in _entry_paths(store, e)],
                # a gen-NNNN directory keeps its manifest.json (the chain
                # walk reads it), so only single files go stale here
                "stale_dirs": []}

    def complete(self) -> Optional[Dict]:
        """Drop the migration record and flip the store stamp: the LAST
        flip, legal only once no unit carries the old stamp. None while
        units are pending (or no migration is in flight)."""
        store = self.store
        # a generation committed since this handle last read the chain is
        # a pending unit too
        store.reload_generations()
        mig = store.migration
        if mig is None or self.pending_units():
            return None
        man = dict(store.manifest)
        man.pop("migration", None)
        man["model_step"] = self.to_step
        man["migration_epoch"] = int(man.get("migration_epoch", 0)) + 1
        self._commit(man)
        self.registry.event("migration_complete", {
            "from_step": int(mig.get("from_step", -1)),
            "to_step": self.to_step, "rows": store.num_vectors})
        self.registry.counter("maintenance.migrations").inc()
        faults.count("store_migrations")
        return {"action": "completed",
                "from_step": int(mig.get("from_step", -1)),
                "to_step": self.to_step}

    def run(self) -> Dict:
        """Sweep to completion (the CLI's path): begin, migrate every
        pending unit oldest first (re-listed between units, so appends that
        land mid-sweep are picked up), then complete. Returns the stats
        with the superseded files for purge_stale."""
        t0 = time.perf_counter()
        begun = self.begin()
        if begun.get("action") == "noop":
            return begun
        units_done, rows = 0, 0
        stale_files: List[str] = []
        while True:
            units = self.pending_units()
            if not units:
                break
            st = self.migrate_unit(units[0])
            units_done += 1
            rows += st["rows"]
            stale_files += st["stale_files"]
        fin = self.complete() or {}
        dt = time.perf_counter() - t0
        return {"action": "migrated",
                "from_step": int(begun.get("from_step", -1)),
                "to_step": self.to_step, "units": units_done,
                "rows": rows, "seconds": round(dt, 3),
                "migrate_pages_per_s": round(rows / max(dt, 1e-9), 2),
                "completed": fin.get("action") == "completed",
                "stale_dirs": [], "stale_files": stale_files}

    # -- internals ---------------------------------------------------------
    def _commit(self, man: Dict) -> None:
        store = self.store
        store._atomic_dump(man, store._manifest_path, op="migrate_swap")
        store.manifest = man
        store._load_generations()

    def _embed_ids(self, ids: np.ndarray) -> np.ndarray:
        parts = []
        bulk = getattr(self.corpus, "page_texts", None)   # one read a batch
        for s in range(0, int(ids.shape[0]), self.batch_rows):
            chunk = [int(i) for i in ids[s: s + self.batch_rows]]
            texts = (bulk(chunk) if bulk is not None
                     else [self.corpus.page_text(i) for i in chunk])
            parts.append(self.embedder.embed_texts(texts, tower="page"))
        if not parts:
            return np.zeros((0, self.store.dim), np.float16)
        return np.concatenate(parts)

    def _clear_torn(self, d: str) -> None:
        """A crashed earlier attempt's files in this unit's directory never
        made a manifest: remove them, so stale bytes never satisfy a fresh
        CRC record. Files the CURRENT manifest references (an earlier pass
        over this directory that committed) are kept."""
        if not os.path.isdir(d):
            return
        store = self.store
        referenced = {os.path.normpath(os.path.join(store.directory, e[k]))
                      for e in store.shards() for k in _FILES if k in e}
        for name in os.listdir(d):
            p = os.path.normpath(os.path.join(d, name))
            if p not in referenced:
                try:
                    os.remove(p)
                except OSError:
                    pass


def migrate_store(store, corpus, embedder, to_step: int, registry=None,
                  batch_rows: int = 4096) -> Dict:
    """One rolling migration of `store` to `to_step`, swept to completion
    (``MigrationPlan.run``)."""
    return MigrationPlan(store, corpus, embedder, to_step,
                         registry=registry, batch_rows=batch_rows).run()
