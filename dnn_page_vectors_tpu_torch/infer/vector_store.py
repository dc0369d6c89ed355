"""Vector store: fp16 or int8 shards + id files under one directory, the
on-disk format of the JAX package's infer/vector_store.py, so each package
reads the other's store.

Layout:
  manifest.json          {"dim", "dtype", "shard_size", "model_step",
                          "shards": [{"index", "count", "vec", "ids",
                                      ["scl",] "bytes": {...},
                                      "crc": {...}}]}
  shard_00000.vec.npy    [n, dim] float16 L2-normalized page vectors, or
                         int8 codes when dtype == "int8"
  shard_00000.scl.npy    [n] float16 per-vector scales (int8 stores)
  shard_00000.ids.npy    [n] int64 page ids (batch padding never stored)

int8 stores quantize each row symmetrically: scale = max|v| / 127 rounded
to float16 (floored at the smallest float16 normal, so an all-zero row
never divides by zero), codes = rint(v / scale) clipped to [-127, 127];
a read dequantizes to scale * codes in float32, within scale / 2 of v.
``write_shard`` quantizes float rows on the host, or takes codes and
scales quantized on the device (infer/bulk_embed.py ``quantize_rows``,
the same math). ``raw=True`` reads hand back the stored codes and scales,
so the top-k and the index widen them on the card.

Shards are the resume unit: a completed shard is recorded in the manifest
after its files are written and fsynced, so a restarted job skips exactly
the finished ones. Each entry records the byte size and CRC32 of its files;
``verify()`` re-checks them on open and quarantines (renames aside and
drops) any shard whose bytes no longer match, so resume re-embeds it.

Readers take the whole store (``load_all``) or a shard at a time
(``iter_shards``, optionally read ahead on a thread: ``read_ahead``).

Writers of one store that share no process each append to their own
``manifest.wNNNN.json`` (tmp + rename, no locks): readers see the union of
the main manifest and every writer manifest (``shards()``), and
``merge_writers()`` folds them into the main one once every writer is
done. A torn writer manifest is renamed aside (``.quarantined``) and its
shards drop out, so resume re-embeds them.

Generations: the base embed is generation 0; a live update lands as
generation G under ``gen-NNNN/``, ordinary shard files plus a
``manifest.json`` of its own (``gen``, ``model_step``, ``tombstones``,
``id_start``, ``id_end``, ``max_index``, ``shards``) written last by
``GenerationWriter.commit()``. The chain must run 1..G without a gap
from one past ``compacted_through``, each stamped at the store's model
step; a torn manifest is quarantined and a stale one skipped, and that
generation and every later one drop out (readers keep the longest intact
prefix). A tombstone kills a page id in every EARLIER generation: reads
map such an id to -1 (``_load_entry``, the one place every reader goes
through), which every retrieval path treats as a dead slot. The files and
manifests are the JAX package's, byte for byte, so each package opens the
other's chain.

Rolling model migrations (maintenance/migrate.py) are read here as the
JAX package reads them: the main manifest's ``migration`` record
({from_step, to_step}), ``migration_epoch`` (bumped at every migration
flip and folded into ``generation``, so every flip moves the number the
refresh and the result cache gate on), per-entry ``model_step`` stamps
(``entry_step``: one stamp a shard, two stamps a store mid-sweep) and
``gen_overrides``, the re-embedded entries of a migrated generation,
applied only while their recorded source CRCs match the generation
manifest on disk. A torn main manifest is quarantined (renamed aside,
counted) and raises a clear ValueError, or starts fresh when the caller
passes ``dim`` (a creation intent).

Manifest dumps run under the transient-I/O retry with the JAX package's
fault-injection points (utils/faults.py): ``<op>_dump`` checked before the
write, ``<op>_file`` corrupted after the fsync; shard writes check
``shard_write`` and corrupt ``shard_file``, reads check ``shard_read``.

Per-row attributes (index/attrs.py): ``init_attrs`` records the word
layout in the manifest; from then on every shard write (the base embed,
appends, compaction, migration) also writes ``shard_NNNNN.atr.npy``, one
packed uint32 word a row, recorded with its bytes and CRC under the
entry's ``atr`` key. A shard written before the table existed has no
file and reads as all-zero words (``load_attrs``).
"""
from __future__ import annotations

import glob
import json
import os
import queue as queue_mod
import shutil
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from dnn_page_vectors_tpu_torch.utils import faults

# a shard entry's data files: vectors (or int8 codes), ids, int8 scales,
# attribute words
_FILES = ("vec", "ids", "scl", "atr")
# the smallest float16 normal, exact in float32: the int8 scale's floor
SCALE_FLOOR = np.float32(np.float16(6.2e-5))


def quantize_rows(vecs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """float rows [n, D] -> (int8 codes [n, D], float16 scales [n]): the
    int8 store's symmetric per-row quantization, on the host (the module
    docstring; infer/bulk_embed.py has the device twin). The codes are
    taken with the float16-rounded scale the reader dequantizes with, so
    |scale * code - v| <= scale / 2 holds exactly."""
    v = np.asarray(vecs, np.float32)
    scale = (np.abs(v).max(axis=-1) / 127.0 if v.size
             else np.zeros((v.shape[0],), np.float32))
    safe = np.maximum(scale.astype(np.float16).astype(np.float32),
                      SCALE_FLOOR)
    codes = np.clip(np.rint(v / safe[:, None]), -127, 127)
    return codes.astype(np.int8), safe.astype(np.float16)


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
        try:
            plain = VectorStore(directory)
            if plain.manifest.get("model_step") != model_step:
                plain.reset()
        except ValueError:
            # a torn main manifest: the open quarantined it, and this
            # caller means to create the store, so the fresh open below
            # starts over (the unstamped store is reset and re-embedded)
            pass
    store = VectorStore(directory, dim=dim, shard_size=shard_size,
                        dtype=dtype)
    store.ensure_model_step(model_step)
    return store


class VectorStore:
    def __init__(self, directory: str, dim: Optional[int] = None,
                 shard_size: Optional[int] = None,
                 writer_id: Optional[int] = None,
                 dtype: Optional[str] = None, verify: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._manifest_path = os.path.join(self.directory, "manifest.json")
        self.writer_id = writer_id
        self._writer_path = (
            None if writer_id is None else
            os.path.join(self.directory, f"manifest.w{int(writer_id):04d}.json"))
        if dtype not in (None, "float16", "int8"):
            raise ValueError(f"unsupported store dtype {dtype!r} "
                             "(want float16 or int8)")
        existed = os.path.exists(self._manifest_path)
        if existed:
            try:
                with open(self._manifest_path) as f:
                    self.manifest = json.load(f)
            except ValueError:
                # a torn main manifest: the shard files may be whole but
                # their record is gone. Quarantine it; with a creation
                # intent (dim given) start a fresh manifest, else raise a
                # clear error instead of a JSON traceback
                q = self._manifest_path + ".quarantined"
                os.replace(self._manifest_path, q)
                faults.count("quarantined_manifests")
                faults.warn(f"store manifest {self._manifest_path} is torn "
                            f"(invalid JSON); moved aside to {q}")
                if dim is None:
                    raise ValueError(
                        f"vector store manifest at {self.directory} is "
                        f"corrupt (quarantined to {q}); re-run 'init-store' "
                        "+ 'embed' to rebuild, or restore the manifest")
                existed = False
        if existed:
            if dim is not None and dim != self.manifest["dim"]:
                raise ValueError(
                    f"store at {self.directory} holds {self.manifest['dim']}-d "
                    f"vectors but dim={dim} was requested; use a fresh "
                    "directory (or reset()) when the model out_dim changes")
        else:
            if dim is None:
                raise FileNotFoundError(
                    f"no vector store at {self.directory} (missing "
                    "manifest.json); pass dim= to create a new store")
            self.manifest = {"dim": dim, "dtype": dtype or "float16",
                             "shard_size": shard_size or 65_536,
                             "shards": []}
            self._flush_manifest()
        # resume: this writer's previously recorded shards
        self._writer_shards: List[Dict] = []
        if self._writer_path and os.path.exists(self._writer_path):
            data = self._read_writer(self._writer_path)
            self._writer_shards = [] if data is None else data.get("shards", [])
        # the longest intact generation chain and its tombstone map
        self._generations: List[Dict] = []
        self._tomb_gen: Dict[int, int] = {}   # page id -> gen that killed it
        self._dead_cache: Dict[int, np.ndarray] = {}
        self._load_generations()
        if existed and verify:
            self.verify()
        # an EMPTY store may adopt a new shard size or dtype (a populated
        # one cannot: its shard files already have the recorded geometry)
        for key, want in (("shard_size", shard_size), ("dtype", dtype)):
            if want is not None and want != self.manifest[key]:
                if self.shards():
                    raise ValueError(
                        f"store at {self.directory} was built with "
                        f"{key}={self.manifest[key]!r} and holds shards; "
                        f"cannot switch to {want!r} (reset() first)")
                self.manifest[key] = want
                self._flush_manifest()

    # -- per-row attributes (index/attrs.py) -------------------------------
    @property
    def attrs_enabled(self) -> bool:
        """Whether the store carries a per-row attribute table: decided by
        init_attrs() and recorded in the manifest with the layout version.
        Shards written before it have no `.atr.npy` and read as all-zero
        words."""
        return "attrs" in self.manifest

    def init_attrs(self) -> None:
        """Record the versioned word layout in the manifest (or check the
        recorded one), so every later shard write carries one packed uint32
        attribute word a row under the same bytes + CRC32 record as the
        vectors."""
        # in the call: the index package imports this module
        from dnn_page_vectors_tpu_torch.index import attrs as attrs_mod
        if self.attrs_enabled:
            attrs_mod.check_attrs_section(self.manifest["attrs"])
            return
        self.manifest["attrs"] = attrs_mod.attrs_manifest_section()
        self._flush_manifest()

    def load_attrs(self, entry: Dict) -> np.ndarray:
        """One shard's packed attribute words (uint32 [count]). A shard
        written before init_attrs() (no `.atr.npy`) reads as all-zero
        words, a defined value, so every predicate is total."""
        if "atr" not in entry:
            return np.zeros(int(entry["count"]), np.uint32)
        faults.active().check("shard_read")
        return np.ascontiguousarray(
            np.load(os.path.join(self.directory, entry["atr"])), np.uint32)

    # -- manifest ---------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.manifest["dim"]

    @property
    def num_vectors(self) -> int:
        return sum(s["count"] for s in self.shards())

    @property
    def row_bytes(self) -> int:
        """Bytes one row costs to gather at its stored width: int8 codes
        plus the float16 scale, or float16 rows (the IVF index's
        ``gather_bytes`` unit)."""
        return (self.dim + 2 if self.manifest["dtype"] == "int8"
                else self.dim * 2)

    @property
    def model_step(self) -> Optional[int]:
        """The stamp the store's vectors were embedded at. Mid-migration it
        stays the FROM stamp until the completion flip; a shard's own
        stamp is ``entry_step``."""
        return self.manifest.get("model_step")

    # -- rolling model migration ------------------------------------------
    @property
    def migration(self) -> Optional[Dict]:
        """The in-flight migration record ({"from_step", "to_step"}), or
        None. While it is present a shard carries either stamp, one stamp a
        shard, and serving scores each shard with its stamp's tower."""
        return self.manifest.get("migration")

    @property
    def migration_epoch(self) -> int:
        """How many migration flips the store has committed, ever."""
        return int(self.manifest.get("migration_epoch", 0))

    def entry_step(self, entry: Dict) -> Optional[int]:
        """The stamp one shard entry was embedded at: its own recorded
        stamp (migrated entries, generation entries), else the store's."""
        return entry.get("model_step", self.manifest.get("model_step"))

    def model_steps(self) -> List[int]:
        """The distinct stamps of the live shard table, ascending: one
        outside a migration, two mid-sweep."""
        return sorted({s for s in (self.entry_step(e) for e in self.shards())
                       if s is not None})

    # -- the live index directory -----------------------------------------
    @property
    def index_dirname(self) -> str:
        """The directory (under the store) of the LIVE IVF index: "ivf", or
        the ivf-NNNN a background rebuild built beside it and flipped to."""
        return self.manifest.get("index_dir", "ivf")

    def set_index_dir(self, name: str) -> None:
        """Repoint the live index directory with one atomic manifest dump
        (the background rebuild's flip)."""
        self.manifest["index_dir"] = str(name)
        self._atomic_dump(self.manifest, self._manifest_path,
                          op="index_swap")

    def _writer_files(self) -> List[str]:
        return sorted(p for p in glob.glob(
            os.path.join(self.directory, "manifest.w*.json"))
            if not p.endswith(".quarantined"))

    def _read_writer(self, path: str) -> Optional[Dict]:
        """One writer manifest, or None: merged away since the glob, or
        torn (invalid JSON), in which case it is renamed aside and its
        shards fall out of the table, so resume re-embeds them."""
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except ValueError:
            q = path + ".quarantined"
            try:
                os.replace(path, q)
            except FileNotFoundError:
                return None
            faults.count("quarantined_manifests")
            faults.warn(f"writer manifest {path} is torn (invalid JSON); "
                        f"moved aside to {q}; its shards will be re-embedded")
            return None

    def shards(self) -> List[Dict]:
        """The merged shard table: the main manifest, every writer manifest
        on disk, and every intact generation's appended shards, by index."""
        by_idx = {s["index"]: s for s in self.manifest["shards"]}
        for path in self._writer_files():
            data = self._read_writer(path)
            if data is None:
                continue
            for s in data.get("shards", []):
                by_idx[s["index"]] = s
        for gen in self._generations:
            for s in gen.get("shards", []):
                by_idx[s["index"]] = s
        return [by_idx[i] for i in sorted(by_idx)]

    def completed_shards(self) -> set:
        return {s["index"] for s in self.shards()}

    def reload(self) -> None:
        """Re-read the main manifest from disk (another process merged,
        stamped or compacted it)."""
        with open(self._manifest_path) as f:
            self.manifest = json.load(f)

    def _atomic_dump(self, obj, path: str, op: str = "manifest") -> None:
        """tmp + fsync + atomic rename + directory fsync: a crash leaves
        the old file or the new one, never a torn one. Runs under the
        transient-I/O retry; the fault points are `op`_dump (before the
        write) and `op`_file (the tmp file, before the rename)."""
        plan = faults.active()

        def _dump():
            plan.check(f"{op}_dump")
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(obj, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            plan.corrupt(f"{op}_file", tmp)
            os.replace(tmp, path)
            _fsync_path(os.path.dirname(path))

        faults.retry(_dump, op=f"{op}_dump")

    def _flush_manifest(self) -> None:
        self._atomic_dump(self.manifest, self._manifest_path)

    def ensure_model_step(self, step: int) -> None:
        """Vectors embedded at another model step are stale, not resumable
        work: reset, then stamp the new step. Mid-migration, either end of
        the sweep is a no-op (the migration owns the stamp)."""
        mig = self.manifest.get("migration")
        if mig and step in (mig.get("from_step"), mig.get("to_step")):
            return
        if self.manifest.get("model_step") != step:
            self.reset()
        self.manifest["model_step"] = step
        self._flush_manifest()

    def merge_writers(self) -> None:
        """Fold every writer manifest into the main one and remove them.
        One process calls it, after every writer finished."""
        files = self._writer_files()
        merged = {s["index"]: s for s in self.manifest["shards"]}
        for path in files:
            data = self._read_writer(path)
            for s in (data or {}).get("shards", []):
                merged[s["index"]] = s
        files = [p for p in files if os.path.exists(p)]  # minus quarantined
        self.manifest["shards"] = [merged[i] for i in sorted(merged)]
        self._flush_manifest()
        for path in files:
            os.remove(path)

    # -- generations --------------------------------------------------------
    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.directory, f"gen-{int(gen):04d}")

    def _load_generations(self) -> None:
        """The longest intact chain gen-NNNN from one past
        ``compacted_through``: it stops at the first missing, torn
        (quarantined: renamed aside) or stale (another gen number or model
        step) manifest, since every later generation was appended against
        a view that held the broken one."""
        self._generations = []
        self._tomb_gen = {}
        self._dead_cache = {}
        step = self.manifest.get("model_step")
        # mid-migration a generation sits at either end's stamp; a
        # migrated one carries its entries as a main-manifest override
        mig = self.manifest.get("migration") or {}
        ok_steps = ({step, mig.get("from_step"), mig.get("to_step")}
                    if mig else {step})
        g = int(self.manifest.get("compacted_through", 0)) + 1
        while True:
            mpath = os.path.join(self._gen_path(g), "manifest.json")
            if not os.path.exists(mpath):
                break
            try:
                with open(mpath) as f:
                    man = json.load(f)
            except ValueError:
                q = mpath + ".quarantined"
                os.replace(mpath, q)
                faults.count("quarantined_generations")
                faults.warn(
                    f"generation manifest {mpath} is torn (invalid JSON); "
                    f"moved aside to {q}; serving the store without "
                    f"generation {g} and anything after it")
                break
            if man.get("gen") != g or (man.get("model_step") not in ok_steps
                                       and self._gen_override(g, man)
                                       is None):
                faults.count("stale_generations")
                faults.warn(
                    f"generation {g} at {mpath} is stale (gen="
                    f"{man.get('gen')}, model_step={man.get('model_step')} "
                    f"vs store {step}); serving without it")
                break
            self._register_generation(man)
            g += 1

    def _gen_override(self, g: int, man: Dict) -> Optional[List[Dict]]:
        """The migrated entries of generation `g` (the main manifest's
        ``gen_overrides``), or None. Applied only while the recorded
        source CRCs still match the generation manifest on disk, so a
        quarantined and reused generation number never takes a stale
        override."""
        ov = (self.manifest.get("gen_overrides") or {}).get(str(int(g)))
        if not ov:
            return None
        src = [e.get("crc", {}).get("vec") for e in man.get("shards", [])]
        if src != ov.get("src_vec_crc"):
            return None
        return ov.get("shards")

    def _register_generation(self, man: Dict) -> None:
        ov = self._gen_override(int(man["gen"]), man)
        if ov is not None:
            # a migrated generation: its re-embedded entries (and their
            # stamp) stand in for the manifest's own
            man = dict(man)
            man["shards"] = [dict(e) for e in ov]
            steps = {e.get("model_step") for e in man["shards"]}
            if len(steps) == 1 and None not in steps:
                man["model_step"] = steps.pop()
        # each entry carries its generation manifest's stamp, as the JAX
        # package's merged table does
        for s in man.get("shards", []):
            s.setdefault("model_step", man.get("model_step"))
        self._generations.append(man)
        g = int(man["gen"])
        for t in man.get("tombstones", []):
            self._tomb_gen[int(t)] = max(self._tomb_gen.get(int(t), 0), g)
        self._dead_cache = {}

    def reload_generations(self) -> None:
        """Pick up the generations another process appended (or
        quarantined) since this handle was opened."""
        self._load_generations()

    @property
    def generation(self) -> int:
        """The store generation (0: the base embed only). Monotonic across
        compactions (folded generations still count) and across migration
        flips (``migration_epoch``)."""
        return (int(self.manifest.get("compacted_through", 0))
                + len(self._generations)
                + int(self.manifest.get("migration_epoch", 0)))

    @property
    def chain_generation(self) -> int:
        """The top generation number of the chain (compacted_through plus
        the intact generations): where the next gen-NNNN lands."""
        return (int(self.manifest.get("compacted_through", 0))
                + len(self._generations))

    def generations(self) -> List[Dict]:
        """The intact generation manifests, in chain order."""
        return list(self._generations)

    def tombstoned_count(self) -> int:
        """Page ids with an active tombstone."""
        return len(self._tomb_gen)

    def appended_vectors(self) -> int:
        """Rows appended by generations > 0, tombstoned rows included."""
        return sum(s["count"] for g in self._generations
                   for s in g.get("shards", []))

    @property
    def compacted_through(self) -> int:
        """The highest generation folded into a compacted base (0: never
        compacted; maintenance/compact.py)."""
        return int(self.manifest.get("compacted_through", 0))

    def maintenance_stats(self) -> Dict:
        """The compaction trigger's inputs: tombstone density, the dead
        rows still stored, and the bytes a compaction would reclaim. Each
        tombstoned id masks exactly one stored row (an append tombstones
        only assigned ids, and an update's old row dies when the new one
        lands)."""
        dead = len(self._tomb_gen)
        total = self.num_vectors
        return {
            "tombstone_density": round(dead / max(total, 1), 4),
            "dead_rows": dead,
            "reclaimable_bytes": dead * (self.row_bytes + 8),
            "generations": len(self._generations),
            "compacted_through": self.compacted_through,
        }

    def _dead_for_gen(self, gen: int) -> np.ndarray:
        """Sorted page ids tombstoned by a generation LATER than `gen`: the
        mask of a shard written at `gen` (a tombstone never masks the
        generation that wrote it, or an update would kill its own new
        row)."""
        arr = self._dead_cache.get(gen)
        if arr is None:
            arr = np.array(sorted(i for i, tg in self._tomb_gen.items()
                                  if tg > gen), np.int64)
            self._dead_cache[gen] = arr
        return arr

    def _mask_dead(self, ids: np.ndarray, gen: int) -> np.ndarray:
        if not self._tomb_gen:
            return ids
        dead = self._dead_for_gen(int(gen))
        if not dead.size:
            return ids
        return np.where(np.isin(ids, dead), np.int64(-1), ids)

    def _next_shard_index(self) -> int:
        """One past the highest shard index ever assigned: live entries,
        quarantined base ranges and every generation's high-water mark, so
        a new generation never takes a quarantined shard's index."""
        hi = max((s["index"] + 1 for s in self.shards()), default=0)
        ss = self.manifest["shard_size"]
        for lo, _ in self.manifest.get("missing_id_ranges", []):
            hi = max(hi, lo // ss + 1)
        for g in self._generations:
            hi = max(hi, int(g.get("max_index", -1)) + 1)
        return hi

    def next_page_id(self) -> int:
        """The append cursor: one past the highest page id ever assigned,
        counting live shards, quarantined (missing) id ranges, every
        generation's id_end and a compaction's ``append_cursor``, so an
        append never re-issues an id."""
        hi = int(self.manifest.get("append_cursor", 0))
        ss = self.manifest["shard_size"]
        for s in self.shards():
            if s.get("gen", 0):
                hi = max(hi, int(s.get("id_hi", 0)))
            else:
                hi = max(hi, s["index"] * ss + s["count"])
        for _, rhi in self.manifest.get("missing_id_ranges", []):
            hi = max(hi, int(rhi))
        for g in self._generations:
            hi = max(hi, int(g.get("id_end", 0)))
        return hi

    def missing_id_ranges(self) -> List[Tuple[int, int]]:
        """[lo, hi) id ranges dropped by shard quarantines and not yet
        re-covered: embed resume re-embeds them, and the append cursor
        counts them as assigned."""
        return [(int(lo), int(hi)) for lo, hi
                in self.manifest.get("missing_id_ranges", [])]

    def _record_missing_range(self, lo: int, hi: int) -> None:
        if hi <= lo:
            return
        ranges = {(int(a), int(b))
                  for a, b in self.manifest.get("missing_id_ranges", [])}
        ranges.add((int(lo), int(hi)))
        self.manifest["missing_id_ranges"] = [list(r) for r in sorted(ranges)]
        self._flush_manifest()

    def _clear_missing_ranges(self, covered) -> None:
        """Drop the recorded missing ranges that `covered(lo, hi)` holds."""
        ranges = self.manifest.get("missing_id_ranges", [])
        kept = [r for r in ranges if not covered(int(r[0]), int(r[1]))]
        if len(kept) != len(ranges):
            self.manifest["missing_id_ranges"] = kept
            self._flush_manifest()

    def begin_generation(self, tombstones=()) -> "GenerationWriter":
        """Open the next generation for appending; `tombstones` are the
        page ids it kills in earlier generations (deleted pages, or pages
        re-appended with fresh vectors). Nothing is visible to readers
        until ``commit()``."""
        return GenerationWriter(self, self.chain_generation + 1,
                                tombstones=tombstones)

    def reset(self) -> None:
        """Drop every shard (the model changed and the vectors are stale):
        the base, the writer manifests' and every generation's, with the
        compaction and migration leftovers."""
        for s in self.shards():
            for key in _FILES:
                if key not in s:
                    continue
                try:
                    os.remove(os.path.join(self.directory, s[key]))
                except FileNotFoundError:
                    pass
        for path in self._writer_files():
            os.remove(path)
        for pat in ("gen-*", "compact-*", "migrate-*"):
            for path in glob.glob(os.path.join(self.directory, pat)):
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
        self._generations = []
        self._tomb_gen = {}
        self._dead_cache = {}
        self.manifest["shards"] = []
        for key in ("missing_id_ranges", "compacted_through", "append_cursor",
                    "migration", "gen_overrides"):
            # migration_epoch stays: generation never moves backward
            self.manifest.pop(key, None)
        self._writer_shards = []
        self._flush_manifest()

    # -- integrity --------------------------------------------------------
    def entry_error(self, entry: Dict) -> Optional[str]:
        """Why this shard entry cannot be trusted, or None: existence and
        recorded byte size first (one stat catches truncation), then CRC32."""
        for key in _FILES:
            if key not in entry:
                continue
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
        """Move a bad shard's files aside (.quarantined) and drop its entry
        from whichever manifest holds it; its id range is recorded missing,
        so embed resume re-embeds it and appends never re-issue it."""
        idx = entry["index"]
        for key in _FILES:
            if key not in entry:
                continue
            src = os.path.join(self.directory, entry[key])
            try:
                os.replace(src, src + ".quarantined")
            except FileNotFoundError:
                pass
        gen = int(entry.get("gen", 0))
        if gen:
            lo, hi = int(entry.get("id_lo", 0)), int(entry.get("id_hi", 0))
            for g in self._generations:
                if g["gen"] != gen:
                    continue
                shards = g.get("shards", [])
                kept = [s for s in shards if s["index"] != idx]
                if len(kept) != len(shards):
                    g["shards"] = kept
                    self._atomic_dump(g, os.path.join(self._gen_path(gen),
                                                      "manifest.json"),
                                      op="gen_manifest")
        else:
            ss = self.manifest["shard_size"]
            lo, hi = idx * ss, idx * ss + int(entry["count"])
        if any(s["index"] == idx for s in self.manifest["shards"]):
            self.manifest["shards"] = [
                s for s in self.manifest["shards"] if s["index"] != idx]
            self._flush_manifest()
        self._record_missing_range(lo, hi)
        for path in self._writer_files():
            data = self._read_writer(path)
            if data is None:
                continue
            shards = data.get("shards", [])
            kept = [s for s in shards if s["index"] != idx]
            if len(kept) != len(shards):
                self._atomic_dump({"shards": kept}, path)
        self._writer_shards = [
            s for s in self._writer_shards if s["index"] != idx]
        faults.count("quarantined_shards")
        faults.warn(f"quarantined store shard {idx} ({reason}); its id "
                    "range will be re-embedded on the next embed resume")

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
                    vecs: Optional[np.ndarray] = None, *,
                    codes: Optional[np.ndarray] = None,
                    scales: Optional[np.ndarray] = None,
                    attrs: Optional[np.ndarray] = None) -> None:
        """Persist one shard. Rows with id < 0 (batch padding) are dropped.
        Either `vecs` (float rows, quantized here by ``quantize_rows`` when
        the store is int8) or, for an int8 store, `codes` + `scales`
        quantized on the device; `attrs`, the rows' attribute words, on a
        store with an attribute table. Data files are written and fsynced
        first; the manifest entry (this writer's manifest, with a
        `writer_id`) lands last, so a crash leaves the shard unrecorded or
        complete."""
        entry = self._write_shard_files("", index, ids, vecs, codes, scales,
                                        attrs=attrs)
        if self._writer_path is not None:
            self._writer_shards = sorted(
                [s for s in self._writer_shards if s["index"] != index]
                + [entry], key=lambda s: s["index"])
            self._atomic_dump({"shards": self._writer_shards},
                              self._writer_path)
            return
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

    def _write_shard_files(self, subdir: str, index: int, ids: np.ndarray,
                           vecs, codes, scales, attrs=None) -> Dict:
        """Write and fsync one shard's data files under `subdir` of the
        store ("" for the base) and return its manifest entry with the
        files' byte sizes and CRC32s: the core of the base write_shard,
        GenerationWriter, compaction and migration. On a store with an
        attribute table every shard also gets its `.atr.npy`: `attrs`
        aligned with `ids` before the padding rows drop, zeros when the
        writer has none. `attrs` on a store without a table raises."""
        data = vecs if codes is None else codes
        if data.shape[-1] != self.dim:
            raise ValueError(f"vectors are {data.shape[-1]}-d, store is "
                             f"{self.dim}-d")
        int8 = self.manifest["dtype"] == "int8"
        if codes is not None and not int8:
            raise ValueError("pre-quantized codes require an int8 store")
        keep = ids >= 0
        ids = ids[keep]
        if attrs is not None and not self.attrs_enabled:
            raise ValueError("attrs given but the store has no attribute "
                             "table; call init_attrs() first")
        words = None
        if self.attrs_enabled:
            words = (np.zeros(keep.shape[0], np.uint32) if attrs is None
                     else np.asarray(attrs, np.uint32))
            if words.shape[0] != keep.shape[0]:
                raise ValueError(f"attrs has {words.shape[0]} rows, ids has "
                                 f"{keep.shape[0]}")
            words = words[keep]
        d = os.path.join(self.directory, subdir) if subdir else self.directory
        stem = f"shard_{index:05d}"
        names = {"vec": stem + ".vec.npy", "ids": stem + ".ids.npy"}
        if int8:
            names["scl"] = stem + ".scl.npy"
        if words is not None:
            names["atr"] = stem + ".atr.npy"
        paths = {key: os.path.join(d, n) for key, n in names.items()}
        entry = {"index": index, "count": int(ids.shape[0]),
                 **{key: os.path.join(subdir, n) if subdir else n
                    for key, n in names.items()},
                 "bytes": {}, "crc": {}}
        plan = faults.active()

        def _write_files():
            plan.check("shard_write")
            if codes is not None:
                np.save(paths["vec"], np.asarray(codes[keep], np.int8))
                scl = np.asarray(scales[keep], np.float16)
            elif int8:
                q, scl = quantize_rows(np.asarray(vecs)[keep])
                np.save(paths["vec"], q)
            else:
                np.save(paths["vec"], np.asarray(vecs[keep], np.float16))
            if int8:
                np.save(paths["scl"], scl)
            np.save(paths["ids"], ids.astype(np.int64))
            if words is not None:
                np.save(paths["atr"], words.astype("<u4"))
            for key, path in paths.items():
                entry["bytes"][key] = os.path.getsize(path)
                entry["crc"][key] = crc_file(path)
                _fsync_path(path)
            # damage after the checksum record: the verify gate, not this
            # writer, must catch it
            plan.corrupt("shard_file", paths["vec"])

        faults.retry(_write_files, op="shard_write")
        return entry

    # -- read -------------------------------------------------------------
    def _load_entry(self, entry: Dict, raw: bool = False):
        """(ids [n] int64, vecs [n, dim]): float16 rows memory-mapped, or
        int8 rows dequantized to float32. With `raw`, (ids, stored rows
        memory-mapped, float16 scales or None), so the card widens them.
        Every reader comes through here, so the tombstones are applied
        here: an id a later generation tombstoned reads as -1."""
        faults.active().check("shard_read")
        vecs = np.load(os.path.join(self.directory, entry["vec"]),
                       mmap_mode="r")
        ids = self.load_ids(entry)
        scale = (np.load(os.path.join(self.directory, entry["scl"]))
                 if "scl" in entry else None)
        if raw:
            return ids, vecs, scale
        if scale is not None:
            vecs = (np.asarray(vecs, np.float32)
                    * scale.astype(np.float32)[:, None])
        return ids, vecs

    def load_ids(self, entry: Dict) -> np.ndarray:
        """One shard's page ids, tombstones applied (-1)."""
        return self._mask_dead(
            np.load(os.path.join(self.directory, entry["ids"])),
            entry.get("gen", 0))

    def load_shard(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._load_entry({s["index"]: s for s in self.shards()}[index])

    def iter_shards(self, raw: bool = False, prefetch: int = 0,
                    entries: Optional[List[Dict]] = None) -> Iterator[Tuple]:
        """Yield each shard's ``_load_entry(entry, raw)`` in shard order.
        With `prefetch` > 0 a reader thread (read_ahead) loads up to
        `prefetch` shards ahead and reads each memory-mapped vector file
        into memory on its side: the memmap defers the disk read to the
        first touch, which would otherwise fall back on the consumer.
        `entries` sweeps the given shard entries instead of the store's
        table (a serving view's frozen snapshot)."""
        if entries is None:
            entries = self.shards()
        if not prefetch:
            return (self._load_entry(s, raw=raw) for s in entries)

        def _load():
            for s in entries:
                out = self._load_entry(s, raw=raw)
                yield (out[0], np.array(out[1]), *out[2:])

        return read_ahead(_load(), depth=prefetch)

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenated (ids [N] int64, tombstoned ids -1; vectors [N, D]:
        float16, or float32 dequantized from an int8 store)."""
        parts = [self._load_entry(s) for s in self.shards()]
        if not parts:
            return (np.zeros(0, np.int64), np.zeros((0, self.dim), np.float16))
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([np.asarray(p[1]) for p in parts]))


class GenerationWriter:
    """Appends one generation to a VectorStore. Shards written through
    ``write_shard`` land under ``gen-NNNN/`` with indices that continue the
    store's (past quarantined ones too), invisible to every reader until
    ``commit()`` writes the generation manifest last: a crash or an error
    mid-append costs this generation only, and ``abort()`` removes its
    directory. ``commit()`` also clears a recorded missing id range the
    generation fully re-covers (a repair append)."""

    def __init__(self, store: VectorStore, gen: int, tombstones=()):
        if gen != store.chain_generation + 1:
            raise ValueError(f"generation {gen} cannot be opened: the chain "
                             f"is at {store.chain_generation}")
        self.store = store
        self.gen = int(gen)
        self.tombstones = sorted({int(t) for t in tombstones})
        self._dir = store._gen_path(gen)
        # a quarantined generation's number is reused: clear its leftovers
        # so stale bytes can never satisfy a fresh CRC record
        if os.path.isdir(self._dir):
            shutil.rmtree(self._dir, ignore_errors=True)
        os.makedirs(self._dir, exist_ok=True)
        self._entries: List[Dict] = []
        self._next_index = store._next_shard_index()
        self._id_cursor = store.next_page_id()
        self._committed = False

    def write_shard(self, ids: np.ndarray,
                    vecs: Optional[np.ndarray] = None, *,
                    codes: Optional[np.ndarray] = None,
                    scales: Optional[np.ndarray] = None,
                    attrs: Optional[np.ndarray] = None) -> Dict:
        """Persist one appended shard (the vecs / codes / attrs contract
        of VectorStore.write_shard); its shard index is assigned here."""
        index = self._next_index
        entry = self.store._write_shard_files(
            os.path.basename(self._dir), index, ids, vecs, codes, scales,
            attrs=attrs)
        entry["gen"] = self.gen
        kept = np.asarray(ids)[np.asarray(ids) >= 0]
        entry["id_lo"] = int(kept.min()) if kept.size else self._id_cursor
        entry["id_hi"] = int(kept.max()) + 1 if kept.size else self._id_cursor
        self._entries.append(entry)
        self._next_index += 1
        return entry

    def commit(self) -> Dict:
        """Publish the generation: its manifest, written atomically, last."""
        if self._committed:
            raise RuntimeError(f"generation {self.gen} already committed")
        man = {
            "gen": self.gen,
            "model_step": self.store.manifest.get("model_step"),
            "tombstones": self.tombstones,
            "id_start": self._id_cursor,
            "id_end": max([self._id_cursor]
                          + [e["id_hi"] for e in self._entries]),
            "max_index": max([self._next_index - 1]
                             + [e["index"] for e in self._entries]),
            "shards": sorted(self._entries, key=lambda s: s["index"]),
        }
        self.store._atomic_dump(man, os.path.join(self._dir, "manifest.json"),
                                op="gen_manifest")
        self.store._register_generation(man)
        if self._entries:
            lo = min(e["id_lo"] for e in self._entries)
            hi = max(e["id_hi"] for e in self._entries)
            self.store._clear_missing_ranges(
                lambda a, b: lo <= a and b <= hi)
        self._committed = True
        return man

    def abort(self) -> None:
        if not self._committed:
            shutil.rmtree(self._dir, ignore_errors=True)
