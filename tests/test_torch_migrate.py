"""Rolling model migrations in the port (maintenance/migrate.py, the
store's migration read path, dual-stamp serving in infer/serve.py) against
the JAX package, on the CPU.

Model-free as the JAX package's tests/test_migrate.py is: a deterministic
(text, step) -> unit-vector stub stands in for the towers on both sides,
so the routing is discriminating (vectors of two steps are independent
directions; only a shard scored with its own stamp's query self-hits).
The port's and the JAX sweep write byte-identical shard files and equal
manifests; a store either package leaves mid-sweep opens, serves both
stamps and resumes in the other; a crash at each fault point leaves a
serveable store that resumes to completion; appends mid-sweep become
pending units; a torn flip quarantines the main manifest (the repair of
``VectorStore.__init__``). Then real weights: config 3's towers cut to 2
layers, d=64, flax-initialized twice (two steps) and converted, where the
port's dual-stamp service returns the JAX service's ids with raw scores
within 1e-5 at float32."""
import json
import os
import zlib

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.maintenance.migrate import (
    MigrationPlan as JaxPlan, migrate_store as jax_migrate_store)
from dnn_page_vectors_tpu.utils import faults as jfaults
from dnn_page_vectors_tpu.utils import telemetry as jtelemetry
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import (
    VectorStore, prepare_store)
from dnn_page_vectors_tpu_torch.maintenance.migrate import (
    MigrationPlan, migrate_store)
from dnn_page_vectors_tpu_torch.utils import faults, telemetry

DIM = 24
SHARD = 40


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    for mod in (faults, jfaults):
        mod.reset()
    telemetry.reset_default()
    jtelemetry.reset_default()
    yield
    for mod in (faults, jfaults):
        mod.reset()


def _vec(text, step):
    seed = zlib.crc32(f"{int(step)}|{text}".encode()) & 0xFFFFFFFF
    v = np.random.default_rng(seed).standard_normal(DIM).astype(np.float32)
    return v / np.linalg.norm(v)


class _Corpus:
    def page_text(self, i):
        return f"page {int(i)}"


class _Embedder:
    """The page tower a sweep drives (both packages call embed_texts)."""

    def __init__(self, step):
        self.step = int(step)
        self.params = ("tower", int(step))
        self.model = torch.nn.Identity()

    def embed_texts(self, texts, tower="page", batch_size=None):
        return np.stack([_vec(t, self.step) for t in texts])


class _QueryStub:
    """A port service's embedder stand-in: the encode is replaced by the
    (text, step) stub."""
    device = torch.device("cpu")
    query_tok = object()

    def __init__(self):
        self.model = torch.nn.Identity()


def _build_store(sdir, nbase=2, gen_rows=(20,), step=1):
    emb, corpus = _Embedder(step), _Corpus()
    store = VectorStore(sdir, dim=DIM, shard_size=SHARD)
    store.ensure_model_step(step)
    for si in range(nbase):
        ids = np.arange(si * SHARD, (si + 1) * SHARD, dtype=np.int64)
        store.write_shard(si, ids, emb.embed_texts(
            [corpus.page_text(i) for i in ids]))
    for rows in gen_rows:
        _append_gen(sdir, rows, step)
    return VectorStore(sdir)


def _append_gen(sdir, rows, step):
    store = VectorStore(sdir)
    base = store.next_page_id()
    ids = np.arange(base, base + rows, dtype=np.int64)
    w = store.begin_generation()
    w.write_shard(ids, _Embedder(step).embed_texts(
        [_Corpus().page_text(i) for i in ids]))
    w.commit()
    return ids


def _port_service(store, hbm=4.0, **serve_over):
    cfg = get_config("cdssm_toy", {
        "model.out_dim": DIM,
        **{f"serve.{k}": v for k, v in serve_over.items()}})
    svc = SearchService(cfg, _QueryStub(), _Corpus(), store,
                        preload_hbm_gb=hbm)

    def _step(queries, step):
        use = svc.store.model_step if step is None else step
        return torch.from_numpy(np.stack([_vec(q, use) for q in queries]))
    svc._embed_queries_step = _step
    return svc


def _jax_service(store, hbm=4.0):
    import jax
    from jax.sharding import Mesh

    from dnn_page_vectors_tpu.config import get_config as jax_get_config
    from dnn_page_vectors_tpu.infer.partition_host import MeshEmbedder
    from dnn_page_vectors_tpu.infer.serve import SearchService as JaxService
    cfg = jax_get_config("cdssm_toy", {"model.out_dim": DIM})
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    svc = JaxService(cfg, MeshEmbedder(mesh), None, store,
                     preload_hbm_gb=hbm)

    def _embed(queries, steps=None):
        ss = list(steps) if steps is not None else []
        if len(ss) <= 1:
            use = ss[0] if ss else svc.store.model_step
            return np.stack([_vec(q, use) for q in queries])
        return np.concatenate(
            [np.stack([_vec(q, s) for q in queries]) for s in ss], axis=1)
    svc._embed_queries_cached = _embed
    svc.corpus = _Corpus()
    return svc


def _self_hits(svc, ids):
    bad = []
    for pid in ids:
        hits = svc.search(f"page {int(pid)}", k=10)
        if not hits or int(hits[0]["page_id"]) != int(pid):
            bad.append(int(pid))
    return bad


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


# -- the sweep, byte for byte ---------------------------------------------------

def test_sweep_writes_the_jax_files_and_manifests(tmp_path):
    """migrate_store in each package over identical stores, and the port's
    unit-at-a-time drive: the same files byte for byte, the same
    manifests, the same stats."""
    a, b, c = (str(tmp_path / x) for x in "abc")
    for d in (a, b, c):
        _build_store(d, gen_rows=(20, 7))
    got = migrate_store(VectorStore(a), _Corpus(), _Embedder(2), 2,
                        batch_rows=16)
    want = jax_migrate_store(JaxStore(b), _Corpus(), _Embedder(2), 2,
                             batch_rows=16)
    drop = ("seconds", "migrate_pages_per_s", "stale_files")
    assert {k: v for k, v in got.items() if k not in drop} == \
        {k: v for k, v in want.items() if k not in drop}
    assert got["units"] == 3 and got["rows"] == 107 and got["completed"]
    assert [os.path.relpath(p, a) for p in got["stale_files"]] == \
        [os.path.relpath(p, b) for p in want["stale_files"]]
    plan = MigrationPlan(VectorStore(c), _Corpus(), _Embedder(2), 2)
    assert plan.begin()["action"] == "started"
    assert plan.pending_units() == [0, 1, 2]
    for u in (0, 1, 2):
        assert plan.migrate_unit(u)["action"] == "migrated_unit"
    assert plan.complete() == {"action": "completed", "from_step": 1,
                               "to_step": 2}
    assert _files(a) == _files(b) == _files(c)
    assert _manifest(a) == _manifest(b)
    store = VectorStore(a)
    assert store.model_step == 2 and store.model_steps() == [2]
    assert store.migration is None and store.migration_epoch == 5
    assert sorted(store.manifest["gen_overrides"]) == ["1", "2"]
    assert store.generation == JaxStore(b).generation == 7
    assert migrate_store(VectorStore(a), _Corpus(), _Embedder(2),
                         2)["action"] == "noop"


@pytest.mark.parametrize("leaver", ["jax", "port"])
def test_a_store_left_mid_sweep_opens_serves_and_resumes_in_the_other(
        tmp_path, leaver):
    sdir = str(tmp_path / "s")
    _build_store(sdir, gen_rows=(20, 7))
    Plan, Store = ((JaxPlan, JaxStore) if leaver == "jax"
                   else (MigrationPlan, VectorStore))
    plan = Plan(Store(sdir), _Corpus(), _Embedder(2), 2)
    plan.begin()
    plan.migrate_unit(0)
    plan.migrate_unit(1)          # a gen_overrides record; gen 2 still old
    port, ref = VectorStore(sdir), JaxStore(sdir)
    for s in (port, ref):
        assert s.model_steps() == [1, 2] and s.model_step == 1
        assert s.migration == {"from_step": 1, "to_step": 2}
    assert port.shards() == ref.shards()
    assert port.generation == ref.generation
    assert [port.entry_step(e) for e in port.shards()] == [2, 2, 2, 1]
    # both packages serve both stamps from it
    svc = _port_service(VectorStore(sdir))
    assert svc._view.steps == [1, 2]
    assert [r[2] for r in svc._view.runs] == [2, 1]
    assert not _self_hits(svc, range(0, 107, 3))
    svc.close()
    jsvc = _jax_service(JaxStore(sdir))
    assert not _self_hits(jsvc, range(0, 107, 3))
    jsvc.close()
    # and the other package finishes the sweep
    if leaver == "jax":
        out = migrate_store(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
    else:
        out = jax_migrate_store(JaxStore(sdir), _Corpus(), _Embedder(2), 2)
    assert out["action"] == "migrated" and out["units"] == 1
    for s in (VectorStore(sdir), JaxStore(sdir)):
        assert s.model_steps() == [2] and s.migration is None


def test_appends_mid_sweep_become_pending_units(tmp_path):
    sdir = str(tmp_path / "s")
    _build_store(sdir)
    plan = MigrationPlan(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
    plan.begin()
    plan.migrate_unit(0)
    # an append lands mid-sweep, stamped by the OLD model
    new_ids = _append_gen(sdir, 15, step=1)
    plan = MigrationPlan(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
    assert plan.begin()["action"] == "resumed"
    assert plan.pending_units() == [1, 2]
    assert plan.complete() is None
    for u in (1, 2):
        plan.migrate_unit(u)
    assert plan.complete()["action"] == "completed"
    store = VectorStore(sdir)
    assert store.model_steps() == [2] and store.num_vectors == 115
    assert set(new_ids.tolist()) <= set(store.load_all()[0].tolist())
    # a second migration can not start while this one is recorded
    other = _build_store(str(tmp_path / "o"))
    MigrationPlan(other, _Corpus(), _Embedder(2), 2).begin()
    with pytest.raises(ValueError, match="already in flight"):
        MigrationPlan(VectorStore(other.directory), _Corpus(),
                      _Embedder(3), 3).begin()


def test_mid_migration_store_rules(tmp_path):
    """ensure_model_step is a no-op at either end of a sweep, a store with
    writer manifests refuses to begin, a compaction waits, and reset()
    drops the migration but keeps the epoch."""
    sdir = str(tmp_path / "s")
    _build_store(sdir)
    w = VectorStore(sdir, writer_id=9)
    w.write_shard(9, np.arange(360, 365, dtype=np.int64),
                  _Embedder(1).embed_texts(["x"] * 5))
    with pytest.raises(ValueError, match="writer manifests"):
        MigrationPlan(VectorStore(sdir), _Corpus(), _Embedder(2), 2).begin()
    VectorStore(sdir).merge_writers()
    plan = MigrationPlan(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
    plan.begin()
    plan.migrate_unit(0)
    store = VectorStore(sdir)
    n = store.num_vectors
    for step in (1, 2):
        store.ensure_model_step(step)
        assert VectorStore(sdir).num_vectors == n
    from dnn_page_vectors_tpu_torch.maintenance import compact_store
    assert compact_store(VectorStore(sdir))["reason"] == \
        "migration in flight"
    epoch = store.migration_epoch
    store.reset()
    again = VectorStore(sdir)
    assert again.migration is None and "gen_overrides" not in again.manifest
    assert again.migration_epoch == epoch and again.num_vectors == 0
    assert not [p for p in os.listdir(sdir) if p.startswith("migrate-")]


# -- crashes ---------------------------------------------------------------------

_CRASH_PLANS = [
    "migrate_write:io_error:0",
    "migrate_write:io_error:1",
    "migrate_write:io_error:2",
    "migrate_swap_dump:io_error:0:*",
    "migrate_swap_dump:io_error:1:*",
    "migrate_swap_dump:io_error:2:*",
    "migrate_swap_dump:io_error:3:*",
]


@pytest.mark.parametrize("plan_txt", _CRASH_PLANS)
def test_a_crash_at_each_fault_point_leaves_a_serveable_store_and_resumes(
        tmp_path, plan_txt):
    sdir = str(tmp_path / "s")
    _build_store(sdir)
    faults.install(faults.FaultPlan.parse(plan_txt, seed=0))
    with pytest.raises(IOError):
        migrate_store(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
    faults.install(faults.FaultPlan())
    cold = VectorStore(sdir)
    assert cold.num_vectors == 100
    assert set(cold.model_steps()) <= {1, 2}
    svc = _port_service(cold)
    assert not _self_hits(svc, range(0, 100, 7)), plan_txt
    svc.close()
    out = migrate_store(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
    assert out["action"] in ("migrated", "noop")
    store = VectorStore(sdir)
    assert store.model_step == 2 and store.model_steps() == [2]
    assert store.migration is None
    svc = _port_service(store)
    assert not _self_hits(svc, range(0, 100, 7)), plan_txt
    svc.close()


def test_a_transient_swap_fault_is_absorbed_by_the_retry(tmp_path):
    sdir = str(tmp_path / "s")
    _build_store(sdir)
    faults.configure_retry(3, 0.0, 0.0)
    faults.install(faults.FaultPlan.parse("migrate_swap_dump:io_error:1"))
    out = migrate_store(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
    assert out["action"] == "migrated" and out["completed"]
    c = faults.counters()
    assert c["injected_migrate_swap_dump_io_error"] == 1
    assert c["retry_migrate_swap_dump"] == 1
    assert c["store_migrate_units"] == 2 and c["store_migrations"] == 1
    assert VectorStore(sdir).model_step == 2


def test_a_torn_flip_quarantines_the_main_manifest(tmp_path):
    """The repair: post-fsync damage to complete()'s flip lands a torn MAIN
    manifest; both packages quarantine it with a clear error and count it,
    and a caller that creates the store falls through to a fresh one."""
    for pkg, Store, mod in (("port", VectorStore, faults),
                            ("jax", JaxStore, jfaults)):
        sdir = str(tmp_path / pkg)
        _build_store(sdir)
        faults.install(faults.FaultPlan.parse("migrate_swap_file:truncate:3"))
        migrate_store(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
        faults.install(faults.FaultPlan())
        torn = open(os.path.join(sdir, "manifest.json")).read()
        with pytest.raises(ValueError, match="corrupt"):
            Store(sdir)
        assert os.path.exists(os.path.join(sdir,
                                           "manifest.json.quarantined"))
        assert mod.counters().get("quarantined_manifests") == 1
        assert not os.path.exists(os.path.join(sdir, "manifest.json"))
        with open(os.path.join(sdir, "manifest.json"), "w") as f:
            f.write(torn)
    # a creation intent starts over: prepare_store opens a fresh store
    os.remove(os.path.join(str(tmp_path / "port"),
                           "manifest.json.quarantined"))
    fresh = prepare_store(str(tmp_path / "port"), DIM, SHARD, None, 3)
    assert fresh.model_step == 3 and fresh.num_vectors == 0
    assert faults.counters()["quarantined_manifests"] == 2


# -- dual-stamp serving ------------------------------------------------------------

@pytest.mark.parametrize("hbm", [4.0, 0.0], ids=["staged", "streaming"])
def test_dual_stamp_serving_routes_each_shard_through_its_tower(tmp_path,
                                                                hbm):
    sdir = str(tmp_path / "s")
    _build_store(sdir, nbase=3, gen_rows=(20, 7))
    svc = _port_service(VectorStore(sdir), hbm=hbm)
    svc.begin_migration(torch.nn.Identity(), 2)
    plan = MigrationPlan(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
    plan.begin()
    plan.migrate_unit(1)                 # gen 1 re-stamped: runs 1, 2, 1
    info = svc.refresh()
    view = svc._view
    assert view.steps == [1, 2]
    assert info["migration"] == {"from_step": 1, "to_step": 2,
                                 "shards_migrated": 1, "shards_total": 5,
                                 "stamps_serving": [1, 2]}
    if hbm:
        assert [(a, b, st) for a, b, st in view.runs] == [
            (0, 120, 1), (120, 140, 2), (140, 147, 1)]
        assert info["stage"]["replaced_rows"] == 20
    else:
        assert not svc.preloaded
    assert not _self_hits(svc, range(0, 147, 3))
    qv = svc._embed_queries_cached(view, ["page 5", "page 130"])
    assert tuple(qv.shape) == (2, 2 * DIM)
    plan.migrate_unit(0)
    plan.migrate_unit(2)
    svc.refresh()
    assert not _self_hits(svc, range(0, 147, 3))
    plan.complete()
    info = svc.refresh()
    assert info["migration_adopted_step"] == 2 and svc._towers == {}
    assert svc._view.steps == [2] and "migration" not in info
    assert not _self_hits(svc, range(0, 147, 3))
    svc.close()


def test_refresh_writes_a_migrated_unit_at_its_staged_rows(tmp_path):
    """The staged buffer after each unit's refresh equals the store's live
    rows; only the unit's rows come from the host, into a copy of the
    buffer (the old view keeps its rows); a tombstone landing beside it
    stays masked."""
    sdir = str(tmp_path / "s")
    _build_store(sdir, nbase=2, gen_rows=(20,))
    svc = _port_service(VectorStore(sdir))
    old_view = svc._view
    old_rows = old_view.pages.clone()
    store = VectorStore(sdir)
    w = store.begin_generation(tombstones=[3, 50])
    w.commit()
    plan = MigrationPlan(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
    plan.begin()
    plan.migrate_unit(0)
    info = svc.refresh()
    st = info["stage"]
    assert (st["replaced_entries"], st["replaced_rows"]) == (2, 80)
    assert st["h2d_rows"] == 80
    assert st["h2d_bytes"] == 80 * DIM * 2 + 2 * 8
    assert st["d2d_bytes"] == 100 * DIM * 2 and not st["grew_buffer"]
    assert torch.equal(old_view.pages, old_rows)      # the old view's rows
    ids, vecs = VectorStore(sdir).load_all()
    view = svc._view
    np.testing.assert_array_equal(view.page_ids, ids)
    np.testing.assert_array_equal(view.pages.numpy(),
                                  np.asarray(vecs, np.float16))
    assert view.dead_rows == 2
    assert not _self_hits(svc, [i for i in range(100) if i not in (3, 50)])
    assert all(h["page_id"] not in (3, 50)
               for h in svc.search("page 3", k=10))
    svc.close()


def test_the_ivf_path_serves_exact_while_two_stamps_serve(tmp_path):
    from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
    sdir = str(tmp_path / "s")
    _build_store(sdir)
    IVFIndex.build(VectorStore(sdir), nlist=4, seed=0, device="cpu")
    svc = _port_service(VectorStore(sdir), index="ivf")
    assert svc.index is not None
    plan = MigrationPlan(VectorStore(sdir), _Corpus(), _Embedder(2), 2)
    plan.begin()
    plan.migrate_unit(0)
    svc.refresh(update_index=False)
    before = svc.ann_fallbacks
    assert not _self_hits(svc, range(0, 100, 9))
    assert svc.ann_fallbacks - before == len(range(0, 100, 9))
    svc.close()


def test_the_result_cache_key_carries_the_view_stamps(tmp_path):
    """Page 7's text IS the probe: after the migration its vector equals
    the step-2 query, so the right answer flips from the planted page 3
    to page 7; a cached answer of step 1 is never returned after it."""
    sdir = str(tmp_path / "s")
    query = "the zipf head probe"
    store = VectorStore(sdir, dim=DIM, shard_size=SHARD)
    store.ensure_model_step(1)
    vecs = np.stack([_vec(f"page {i}", 1) for i in range(SHARD)])
    vecs[3] = _vec(query, 1)
    vecs[7] = _vec("decoy", 1)
    store.write_shard(0, np.arange(SHARD, dtype=np.int64), vecs)

    class _PinCorpus(_Corpus):
        def page_text(self, i):
            return query if int(i) == 7 else f"page {int(i)}"
    svc = _port_service(VectorStore(sdir), result_cache=True)
    svc.corpus = _PinCorpus()
    first = svc.search(query, k=5)
    assert int(first[0]["page_id"]) == 3
    assert svc.search(query, k=5) == first and svc.result_cache_hits == 1
    key1 = svc._result_cache_key(query, 5, None)
    assert key1[3] >> 32 == 1
    svc.begin_migration(torch.nn.Identity(), 2)
    out = migrate_store(VectorStore(sdir), _PinCorpus(), _Embedder(2), 2)
    assert out["completed"]
    svc.refresh()
    after = svc.search(query, k=5)
    assert svc.result_cache_hits == 1 and svc.result_cache_misses == 2
    assert int(after[0]["page_id"]) == 7
    key2 = svc._result_cache_key(query, 5, None)
    assert key2[3] >> 32 == 2 and key1 != key2
    svc.close()


# -- real weights against the JAX service -------------------------------------------

VOCAB = 600
OV = {"data.num_pages": 300, "data.vocab_size": VOCAB,
      "model.num_layers": 2, "model.model_dim": 64, "model.num_heads": 4,
      "model.mlp_dim": 128, "model.out_dim": 32,
      "model.attention": "flash", "model.dtype": "float32",
      "eval.embed_batch_size": 64, "eval.store_shard_size": 128}
JAX_OV = {**OV, "model.dropout": 0.0, "eval.embed_stack": 1,
          "data.tokenize_workers": 1}


def test_dual_stamp_service_returns_the_jax_ids_on_converted_weights(
        tmp_path):
    import jax
    import jax.numpy as jnp

    from dnn_page_vectors_tpu.config import MeshConfig
    from dnn_page_vectors_tpu.config import get_config as jax_get_config
    from dnn_page_vectors_tpu.data.loader import (
        build_corpus as jax_build_corpus,
        build_tokenizer as jax_build_tokenizer)
    from dnn_page_vectors_tpu.infer.bulk_embed import (
        BulkEmbedder as JaxEmbedder)
    from dnn_page_vectors_tpu.infer.serve import SearchService as JaxService
    from dnn_page_vectors_tpu.models.factory import build_two_tower as jbuild
    from dnn_page_vectors_tpu.parallel.mesh import make_mesh
    from dnn_page_vectors_tpu_torch.convert import params_from_flax
    from dnn_page_vectors_tpu_torch.data.loader import (
        build_corpus, build_tokenizer)
    from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    from dnn_page_vectors_tpu_torch.updates import append_corpus

    jcfg = jax_get_config("bert_mini_v5p16", JAX_OV)
    tcfg = get_config("bert_mini_v5p16", OV)
    jcorpus, tcorpus = jax_build_corpus(jcfg), build_corpus(tcfg)
    jq_tok, jp_tok = jax_build_tokenizer(jcfg, jcorpus)
    tq_tok, tp_tok = build_tokenizer(tcfg, tcorpus)
    jmodel = jbuild(jcfg, vocab_size=VOCAB)
    mesh = make_mesh(MeshConfig(data=1))
    jembs, tmodels = [], []
    for seed in (0, 1):
        params = jmodel.init(jax.random.PRNGKey(seed),
                             jnp.zeros((2, jcfg.data.query_len), jnp.int32),
                             jnp.zeros((2, jcfg.data.page_len), jnp.int32))
        jembs.append(JaxEmbedder(jcfg, jmodel, params, jp_tok, mesh,
                                 query_tok=jq_tok))
        tm = build_two_tower(tcfg, vocab_size=VOCAB, device="cpu")
        tm.load_state_dict(params_from_flax(
            jax.tree_util.tree_map(np.asarray, params)))
        tmodels.append(tm)
    temb = BulkEmbedder(tcfg, tmodels[0], tp_tok, query_tok=tq_tok,
                        device="cpu")
    sdir = str(tmp_path / "store")
    store = VectorStore(sdir, dim=32, shard_size=128)
    store.ensure_model_step(1)
    temb.embed_corpus(tcorpus, store, stop=256)
    append_corpus(temb, tcorpus, VectorStore(sdir), start=256, stop=300)
    # the JAX sweep re-stamps the base with its step-2 page tower
    plan = JaxPlan(JaxStore(sdir), jcorpus, jembs[1], 2)
    plan.begin()
    plan.migrate_unit(0)
    queries = [tcorpus.query_text(i) for i in (0, 7, 42, 99, 150, 201, 255,
                                               260, 280, 299)]
    jsvc = JaxService(jcfg, jembs[0], jcorpus, JaxStore(sdir))
    jsvc.begin_migration(jembs[1].params, 2)
    tsvc = SearchService(tcfg, temb, tcorpus, VectorStore(sdir))
    tsvc.begin_migration(tmodels[1], 2)
    jview, tview = jsvc._view, tsvc._view
    assert jview.steps == tview.steps == [1, 2]
    n = len(queries)
    jqv = jsvc._embed_queries_cached(queries, steps=jview.steps)
    tqv = tsvc._embed_queries_cached(tview, queries)
    np.testing.assert_allclose(tqv.numpy(), jqv, rtol=0, atol=1e-5)
    js, ji, _ = jsvc._topk_view(jview, jqv, n, 10)
    ts, ti, _ = tsvc._topk_view(tview, tqv, n, 10)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    for r in range(n):
        for j in np.flatnonzero(ti[r] != ji[r]):
            assert any(abs(js[r, j] - js[r, x]) <= 1e-5
                       for x in (j - 1, j + 1) if 0 <= x < 10), (r, j)
    # the gen unit's pages (step-1 tower) and the base's (step-2) are both
    # in the answers
    assert (ti >= 256).any() and (ti < 256).any()
    assert [[h["page_id"] for h in hits]
            for hits in tsvc.search_many(queries, k=10)] == ti.tolist()
    jsvc.close()
    tsvc.close()
