"""The port's live corpus updates against the JAX package's, on the CPU.

Store files: given the same vectors, the port's and JAX's writer
manifests and GenerationWriter write byte-identical files and manifests
(no field carries a time), fp16 and int8; each package opens the other's
chain with the same generation, cursor, tombstones and rows; a torn or
stale generation manifest drops that generation and every later one in
both; a quarantined shard's ids are never re-issued by an append.

Appends: ``append_corpus`` through the port and through JAX on copies of
one store (config 3's towers at 2 layers, d=64, flax weights converted by
``params_from_flax``, flash attention at float32): the same ids, ranges
and tombstones, and page rows whose float32 values agree within 1e-5
(stored as float16, so within 1e-5 plus one float16 step of each other);
a second port append of the same range writes the same bytes; tombstoned
rows never come back, an updated page serves once from its new row.

Index: ``IVFIndex.update`` over the same store and index writes the JAX
update's posting and code files byte for byte (plain and PQ), and a drift
past ``rebuild_drift`` rebuilds.

Serving: ``refresh()`` copies only the appended rows from the host, never
lets a dead row take a result slot (k live hits, equal to a service
opened fresh), never mixes generations in one result set under threads,
and the result cache keys on the view's generation (the repair of the
generation-0 key). CLI: the new commands print the JAX CLI's keys."""
import json
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import MeshConfig
from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.loader import (
    build_corpus as jax_build_corpus, build_tokenizer as jax_build_tokenizer)
from dnn_page_vectors_tpu.index.ivf import IVFIndex as JaxIndex
from dnn_page_vectors_tpu.infer.bulk_embed import BulkEmbedder as JaxEmbedder
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.models.factory import build_two_tower as jax_build
from dnn_page_vectors_tpu.parallel.mesh import make_mesh
from dnn_page_vectors_tpu.updates import append_corpus as jax_append
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.convert import params_from_flax
from dnn_page_vectors_tpu_torch.data.loader import (
    build_corpus, build_tokenizer)
from dnn_page_vectors_tpu_torch.index.ivf import IVFIndex
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.serve import SearchService
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.ops.topk import topk_over_store
from dnn_page_vectors_tpu_torch.updates import append_corpus

DIM = 16
VOCAB = 600
OV = {"data.num_pages": 300, "data.vocab_size": VOCAB,
      "model.num_layers": 2, "model.model_dim": 64, "model.num_heads": 4,
      "model.mlp_dim": 128, "model.out_dim": 32,
      "model.attention": "flash", "model.dtype": "float32",
      "eval.embed_batch_size": 64, "eval.store_shard_size": 128}
JAX_OV = {**OV, "model.dropout": 0.0, "eval.embed_stack": 1,
          "data.tokenize_workers": 1}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _rows(rng, ids):
    v = rng.standard_normal((len(ids), DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _chain(cls, d, dtype, rng_seed=0):
    """A base of 3 shards (8, 8, 5 rows) and two generations, the first
    tombstoning 2 and 9 (re-appending 2), the second tombstoning 21."""
    rng = np.random.default_rng(rng_seed)
    store = cls(d, dim=DIM, shard_size=8, dtype=dtype)
    store.ensure_model_step(3)
    for s, (lo, hi) in enumerate(((0, 8), (8, 16), (16, 21))):
        ids = np.arange(lo, hi, dtype=np.int64)
        store.write_shard(s, ids, _rows(rng, ids))
    w = store.begin_generation(tombstones=[2, 9])
    for ids in (np.arange(21, 29), np.array([29, 30, 2, -1])):
        w.write_shard(np.asarray(ids, np.int64), _rows(rng, ids))
    w.commit()
    w = store.begin_generation(tombstones=[21])
    ids = np.arange(31, 35, dtype=np.int64)
    w.write_shard(ids, _rows(rng, ids))
    w.commit()
    return store


def _same_view(a, b):
    assert a.generation == b.generation
    assert a.chain_generation == b.chain_generation
    assert a.next_page_id() == b.next_page_id()
    assert a.tombstoned_count() == b.tombstoned_count()
    assert a.appended_vectors() == b.appended_vectors()
    assert a.missing_id_ranges() == b.missing_id_ranges()
    assert a.shards() == b.shards()
    ia, va = a.load_all()
    ib, vb = b.load_all()
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(va, vb)


# -- store files ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_generation_chain_files_byte_identical_to_jax(dtype, tmp_path):
    port = _chain(VectorStore, str(tmp_path / "port"), dtype)
    jax_ = _chain(JaxStore, str(tmp_path / "jax"), dtype)
    got, want = _files(port.directory), _files(jax_.directory)
    assert sorted(got) == sorted(want)
    assert "gen-0002/manifest.json" in got
    for name in want:
        assert got[name] == want[name], name
    man = json.loads(got["gen-0001/manifest.json"])
    assert man["tombstones"] == [2, 9] and man["id_start"] == 21
    assert man["id_end"] == 31 and man["max_index"] == 4
    assert port.generation == 2 and port.tombstoned_count() == 3
    ids, _ = port.load_all()
    # 2 lives on in generation 1's row only; 9 and 21 are dead
    assert sorted(int(i) for i in ids if i >= 0) == sorted(
        set(range(35)) - {9, 21})
    assert list(ids).count(2) == 1 and list(ids).count(-1) == 3
    # each package opens the other's chain
    _same_view(VectorStore(jax_.directory), JaxStore(jax_.directory))
    _same_view(JaxStore(port.directory), VectorStore(port.directory))
    _same_view(VectorStore(port.directory), JaxStore(jax_.directory))


def test_abort_and_writer_rules(tmp_path):
    store = _chain(VectorStore, str(tmp_path / "s"), "float16")
    w = store.begin_generation(tombstones=[0])
    w.write_shard(np.arange(35, 40), _rows(np.random.default_rng(1),
                                            range(5)))
    with pytest.raises(ValueError, match="cannot be opened"):
        type(w)(store, 5)
    w.abort()
    assert not os.path.exists(os.path.join(store.directory, "gen-0003"))
    again = VectorStore(store.directory)
    assert again.generation == 2 and again.next_page_id() == 35
    assert again.tombstoned_count() == 3
    man = store.begin_generation().commit()   # an empty generation commits
    assert man["gen"] == 3 and man["shards"] == [] and man["id_end"] == 35
    with pytest.raises(RuntimeError, match="already committed"):
        w2 = store.begin_generation()
        w2.commit()
        w2.commit()
    # reset drops every generation, but the stamp of a migration epoch
    # would stay: the generation never runs backward past it
    store.reset()
    assert store.generation == 0 and store.shards() == []
    assert not any(n.startswith("gen-") for n in os.listdir(store.directory))


def _writers(cls, d, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    base = cls(d, dim=DIM, shard_size=8)
    base.ensure_model_step(1)
    for wid, shards in ((0, (0, 1)), (2, (2,))):
        w = cls(d, writer_id=wid)
        for s in shards:
            ids = np.arange(s * 8, s * 8 + 8, dtype=np.int64)
            w.write_shard(s, ids, _rows(rng, ids))
    return cls(d)


def test_writer_manifests_byte_identical_and_merged_like_jax(tmp_path):
    port = _writers(VectorStore, str(tmp_path / "port"))
    jax_ = _writers(JaxStore, str(tmp_path / "jax"))
    got, want = _files(port.directory), _files(jax_.directory)
    assert {"manifest.w0000.json", "manifest.w0002.json"} <= set(want)
    assert got == want
    assert [s["index"] for s in port.shards()] == [0, 1, 2]
    _same_view(VectorStore(jax_.directory), JaxStore(port.directory))
    # a writer resumes from its own manifest
    assert [s["index"] for s in VectorStore(
        port.directory, writer_id=0)._writer_shards] == [0, 1]
    # a torn writer manifest is moved aside in both packages: its shards
    # drop out of the table (resume re-embeds them)
    for d in (port.directory, jax_.directory):
        with open(os.path.join(d, "manifest.w0002.json"), "w") as f:
            f.write('{"shards": [')
    p2, j2 = VectorStore(port.directory), JaxStore(jax_.directory)
    assert [s["index"] for s in p2.shards()] == [0, 1]
    assert [s["index"] for s in j2.shards()] == [0, 1]
    for d in (port.directory, jax_.directory):
        assert os.path.exists(os.path.join(d,
                                           "manifest.w0002.json.quarantined"))
    p2.merge_writers()
    j2.merge_writers()
    assert _files(port.directory) == _files(jax_.directory)
    assert not any(n.startswith("manifest.w") and n.endswith(".json")
                   for n in os.listdir(port.directory))
    assert [s["index"] for s in VectorStore(port.directory).shards()] == [0, 1]


@pytest.mark.parametrize("fault", ["torn", "stale"])
def test_torn_or_stale_generation_keeps_the_prefix(fault, tmp_path):
    store = _chain(VectorStore, str(tmp_path / "s"), "float16")
    w = store.begin_generation(tombstones=[31])
    w.write_shard(np.arange(35, 38), _rows(np.random.default_rng(2),
                                           range(3)))
    w.commit()
    mpath = os.path.join(store.directory, "gen-0002", "manifest.json")
    if fault == "torn":
        with open(mpath, "r+") as f:
            f.truncate(40)
    else:
        man = json.load(open(mpath))
        man["model_step"] = 99
        with open(mpath, "w") as f:
            json.dump(man, f)
    copy = str(tmp_path / "copy")
    shutil.copytree(store.directory, copy)
    for s in (VectorStore(store.directory), JaxStore(copy)):
        assert s.generation == 1 and s.chain_generation == 1
        assert s.tombstoned_count() == 2    # generation 2's and 3's dropped
        assert s.num_vectors == 21 + 11       # the -1 pad row is dropped
    assert os.path.exists(mpath + ".quarantined") == (fault == "torn")
    _same_view(VectorStore(store.directory), JaxStore(copy))
    # the number is reused: the old files cannot satisfy the new record
    again = VectorStore(store.directory)
    w = again.begin_generation()
    assert w.gen == 2
    assert not os.path.exists(os.path.join(store.directory, "gen-0002",
                                           "shard_00004.vec.npy"))
    w.abort()


def test_quarantine_plus_append_never_double_assigns(tmp_path):
    store = _chain(VectorStore, str(tmp_path / "s"), "float16")
    vec = os.path.join(store.directory, "shard_00001.vec.npy")
    with open(vec, "r+b") as f:
        f.seek(200)
        f.write(b"\xff\xff\xff")
    copy = str(tmp_path / "copy")
    shutil.copytree(store.directory, copy)
    port, jax_ = VectorStore(store.directory), JaxStore(copy)
    for s in (port, jax_):
        assert 1 not in s.completed_shards()
        assert s.missing_id_ranges() == [(8, 16)]
        assert s.next_page_id() == 35 and s._next_shard_index() == 6
    assert _files(port.directory) == _files(jax_.directory)
    w = port.begin_generation()
    e = w.write_shard(np.arange(35, 37), _rows(np.random.default_rng(3),
                                               range(2)))
    assert e["index"] == 6 and (e["id_lo"], e["id_hi"]) == (35, 37)
    w.commit()
    ids, _ = VectorStore(port.directory).load_all()
    live = [int(i) for i in ids if i >= 0]
    assert len(live) == len(set(live))


# -- appends through the towers ------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("updates")
    jcfg = jax_get_config("bert_mini_v5p16", JAX_OV)
    tcfg = get_config("bert_mini_v5p16", OV)
    jcorpus, tcorpus = jax_build_corpus(jcfg), build_corpus(tcfg)
    jq_tok, jp_tok = jax_build_tokenizer(jcfg, jcorpus)
    tq_tok, tp_tok = build_tokenizer(tcfg, tcorpus)
    jmodel = jax_build(jcfg, vocab_size=VOCAB)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((2, jcfg.data.query_len), jnp.int32),
                         jnp.zeros((2, jcfg.data.page_len), jnp.int32))
    jemb = JaxEmbedder(jcfg, jmodel, params, jp_tok,
                       make_mesh(MeshConfig(data=1)), query_tok=jq_tok)
    tmodel = build_two_tower(tcfg, vocab_size=VOCAB, device="cpu")
    tmodel.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    temb = BulkEmbedder(tcfg, tmodel, tp_tok, query_tok=tq_tok,
                        device="cpu")
    base = VectorStore(os.path.join(root, "base"), dim=32, shard_size=128)
    base.ensure_model_step(0)
    temb.embed_corpus(tcorpus, base)
    grown = {n: (jax_build_corpus(jax_get_config(
                     "bert_mini_v5p16", {**JAX_OV, "data.num_pages": n})),
                 build_corpus(get_config(
                     "bert_mini_v5p16", {**OV, "data.num_pages": n})))
             for n in (400, 430)}
    return dict(jcfg=jcfg, tcfg=tcfg, tcorpus=tcorpus, jemb=jemb, temb=temb,
                base=base, grown=grown, root=str(root))


def _copy(world, dst):
    shutil.copytree(world["base"].directory, str(dst))
    return str(dst)


def _fp16_close(got, want):
    """float16 rows of float32 values within 1e-5 of each other: apart by
    at most 1e-5 plus one float16 step at their magnitude."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    step = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
    assert (np.abs(got - want) <= 1e-5 + step).all(), \
        np.abs(got - want).max()


def test_append_matches_jax_and_is_byte_deterministic(world, tmp_path):
    jc, tc = world["grown"][400]
    stores, stats = [], []
    for sub in ("a", "b"):
        s = VectorStore(_copy(world, tmp_path / sub))
        stats.append(append_corpus(world["temb"], tc, s, tombstone=[7],
                                   update_ids=[12]))
        stores.append(s)
    js = JaxStore(_copy(world, tmp_path / "jax"))
    jstats = jax_append(world["jemb"], jc, js, tombstone=[7],
                        update_ids=[12])
    drop = ("seconds", "append_docs_per_s")
    assert {k: v for k, v in stats[0].items() if k not in drop} == \
        {k: v for k, v in jstats.items() if k not in drop} == {
            "generation": 1, "appended": 100, "updated": 1,
            "tombstoned": 2, "id_start": 300, "id_end": 400, "shards": 1}
    ga, gb = (_files(os.path.join(s.directory, "gen-0001")) for s in stores)
    assert ga == gb                       # two appends, the same bytes
    gj = _files(os.path.join(js.directory, "gen-0001"))
    assert sorted(ga) == sorted(gj)
    np.testing.assert_array_equal(
        np.load(os.path.join(stores[0].directory,
                             "gen-0001/shard_00003.ids.npy")),
        np.load(os.path.join(js.directory, "gen-0001/shard_00003.ids.npy")))
    pm, jm = (json.loads(g["manifest.json"]) for g in (ga, gj))
    for m in (pm, jm):
        for e in m["shards"]:
            e.pop("crc")
    assert pm == jm
    _fp16_close(np.load(os.path.join(stores[0].directory,
                                     "gen-0001/shard_00003.vec.npy")),
                np.load(os.path.join(js.directory,
                                     "gen-0001/shard_00003.vec.npy")))
    s = stores[0]
    assert s.num_vectors == 401 and s.generation == 1
    assert s.next_page_id() == 400
    # tombstoned 7 never comes back; 12 serves once, from its new row
    ids, vecs = s.load_all()
    assert 7 not in ids and list(ids).count(12) == 1
    q = np.asarray(vecs[list(ids).index(12)], np.float32)[None]
    old = VectorStore(world["base"].directory).load_all()
    q7 = np.asarray(old[1][list(old[0]).index(7)], np.float32)[None]
    _, got = topk_over_store(np.concatenate([q, q7]), s, k=10,
                             device="cpu")
    assert got[0][0] == 12 and list(got[0]).count(12) == 1
    assert 7 not in got[1]
    # the JAX package reads the port's appended store and agrees
    _same_view(JaxStore(s.directory), VectorStore(s.directory))
    with pytest.raises(ValueError, match="not an existing page"):
        append_corpus(world["temb"], tc, s, tombstone=[500])
    with pytest.raises(ValueError, match="overlaps ids already assigned"):
        append_corpus(world["temb"], tc, s, start=350)
    noop = append_corpus(world["temb"], tc, s)
    assert noop["appended"] == 0 and s.generation == 1
    assert not os.path.exists(os.path.join(s.directory, "gen-0002"))
    # attribute words need the store's attribute table: refused before
    # anything is embedded (tests/test_torch_filtered.py has the rest)
    with pytest.raises(ValueError, match="no attribute table"):
        append_corpus(world["temb"], tc, s, attrs=1)
    assert s.generation == 1


@pytest.mark.parametrize("pq_m", [0, 4])
def test_ivf_update_writes_the_jax_files(world, pq_m, tmp_path):
    tc = world["grown"][400][1]
    port = VectorStore(_copy(world, tmp_path / "port"))
    IVFIndex.build(port, nlist=8, iters=3, seed=0, pq_m=pq_m, pq_iters=3,
                   opq_iters=1, device="cpu")
    append_corpus(world["temb"], tc, port, tombstone=[5])
    shutil.copytree(port.directory, str(tmp_path / "jax"))
    js = JaxStore(str(tmp_path / "jax"))
    idx, info = IVFIndex.update(VectorStore(port.directory),
                                rebuild_drift=0.5, device="cpu")
    _, jinfo = JaxIndex.update(js, make_mesh(MeshConfig(data=1)),
                               rebuild_drift=0.5)
    drop = ("seconds",)
    assert {k: v for k, v in info.items() if k not in drop} == \
        {k: v for k, v in jinfo.items() if k not in drop}
    assert info["action"] == "incremental" and info["new_shards"] == 1
    assert info["appended_rows"] == 100 and idx.index_generation == 1
    # the same store and index in: the same files out, the manifest too
    got = _files(os.path.join(port.directory, "ivf"))
    want = _files(os.path.join(js.directory, "ivf"))
    assert sorted(got) == sorted(want)
    assert sum(n.startswith("posting_00003") for n in got) == (
        3 if pq_m else 2)
    for name in want:
        assert got[name] == want[name], name
    # full probe, every candidate re-ranked: exact search, the tombstone out
    qv = world["temb"].embed_texts([tc.query_text(i) for i in (5, 50, 320,
                                                               399)])
    s, i, _ = idx.search(qv, k=10, nprobe=8, rerank=10_000)
    es, ei = topk_over_store(qv, VectorStore(port.directory), k=10,
                             device="cpu")
    np.testing.assert_allclose(s, es, rtol=0, atol=1e-5)
    assert all(set(a) == set(b) for a, b in zip(i, ei))
    assert not (i == 5).any()
    # JAX opens the port's extended index
    JaxIndex.open(JaxStore(port.directory))
    # past the drift bar: a full rebuild, index generation 0
    append_corpus(world["temb"], world["grown"][430][1],
                  VectorStore(port.directory))
    idx2, info2 = IVFIndex.update(VectorStore(port.directory),
                                  rebuild_drift=0.01, device="cpu")
    assert info2["action"] == "rebuild" and idx2.index_generation == 0
    assert int(idx2.list_sizes.sum()) == 430     # dead rows stay listed
    noop = IVFIndex.update(VectorStore(port.directory), device="cpu")[1]
    assert noop["action"] == "noop"


# -- the hot swap ---------------------------------------------------------------

def _svc(world, store, **over):
    cfg = get_config("bert_mini_v5p16", {**OV, **{
        k if "." in k else f"serve.{k}": v for k, v in over.items()}})
    return SearchService(cfg, world["temb"], world["grown"][430][1], store)


def _pids(res):
    return [tuple(r["page_id"] for r in hits) for hits in res]


def test_refresh_copies_only_appended_rows_and_dead_rows_never_surface(
        world, tmp_path):
    tc = world["grown"][400][1]
    store = VectorStore(_copy(world, tmp_path / "s"))
    svc = _svc(world, store, query_cache_size=0)
    queries = [tc.query_text(i) for i in (3, 7, 12, 150, 299, 310, 399)]
    before = svc.search_many(queries, k=10)
    # the pages the base retrieves first for their own queries die
    victims = sorted({h[0]["page_id"] for h in before[:5]})
    append_corpus(world["temb"], tc, VectorStore(store.directory),
                  tombstone=victims)
    info = svc.refresh()
    assert info["store_generation"] == 1 and info["new_docs"] == 100
    assert info["tombstoned"] == len(victims)
    st = info["stage"]
    assert st["h2d_rows"] == 100 and st["reused_entries"] == 3
    assert st["h2d_bytes"] == 100 * 64 + len(victims) * 8
    assert st["grew_buffer"] and st["newly_dead_rows"] == len(victims)
    assert svc.restage_skipped == 1 and svc.restage_forced == 0
    assert svc._view.alive is not None and svc.num_vectors == 400 - len(
        victims)
    after = svc.search_many(queries, k=10)
    assert all(len(h) == 10 for h in after)           # k live hits
    assert not set(victims) & {i for r in _pids(after) for i in r}
    fresh = _svc(world, VectorStore(store.directory), query_cache_size=0)
    assert fresh._view.alive is None                  # dead rows not staged
    assert _pids(after) == _pids(fresh.search_many(queries, k=10))
    # the appended pages are found by their own vectors
    ids, vecs = VectorStore(store.directory).load_all()
    rows = [list(ids).index(i) for i in (310, 399)]
    _, got = svc.topk_vectors(np.asarray(vecs[rows], np.float32), k=3)
    assert got[0][0] == 310 and got[1][0] == 399
    # a second append fits the grown buffer; killing past the density bar
    # compacts the staged rows on the card
    many = list(range(20, 60))
    append_corpus(world["temb"], world["grown"][430][1],
                  VectorStore(store.directory), tombstone=many)
    info = svc.refresh()
    st = info["stage"]
    assert st["h2d_rows"] == 30 and not st["grew_buffer"]
    assert st["compacted_on_card"] and svc.restage_forced == 1
    dead = set(victims) | set(many)
    assert svc._view.alive is None and svc.num_vectors == 430 - len(dead)
    fresh = _svc(world, VectorStore(store.directory), query_cache_size=0)
    assert _pids(svc.search_many(queries, k=10)) == _pids(
        fresh.search_many(queries, k=10))
    met = svc.metrics()
    assert (met["store_generation"], met["refreshes"], met["docs_appended"],
            met["tombstoned"]) == (2, 2, 130, len(dead))
    svc.close()


def test_result_cache_never_returns_an_older_generation(world, tmp_path):
    tc = world["grown"][400][1]
    store = VectorStore(_copy(world, tmp_path / "s"))
    svc = _svc(world, store, result_cache=True, query_cache_size=0)
    q = tc.query_text(11)
    first = svc.search(q, k=10)
    assert svc.search(q, k=10) == first and svc.result_cache_hits == 1
    top = first[0]["page_id"]
    append_corpus(world["temb"], tc, VectorStore(store.directory),
                  tombstone=[top])
    svc.refresh()
    misses = svc.result_cache_misses
    again = svc.search(q, k=10)
    assert svc.result_cache_misses == misses + 1      # the old key is dead
    assert top not in [h["page_id"] for h in again]
    assert svc._result_cache_key(q, 10, None)[3] & 0xFFFFFFFF == 1
    svc.close()


def test_refresh_under_threads_never_mixes_generations(world, tmp_path):
    tc = world["grown"][400][1]
    store = VectorStore(_copy(world, tmp_path / "s"))
    svc = _svc(world, store, batch_window_ms=1.0, max_batch=8)
    svc.start_batcher()
    qids = [3, 42, 101, 250]
    queries = {i: tc.query_text(i) for i in qids}
    before = {i: tuple(h["page_id"] for h in svc.search(queries[i], k=10))
              for i in qids}
    victim = before[qids[0]][0]
    stop, errors = threading.Event(), []
    seen = {i: set() for i in qids}

    def hammer(i):
        while not stop.is_set():
            try:
                seen[i].add(tuple(h["page_id"]
                                  for h in svc.search(queries[i], k=10)))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer, args=(i,)) for i in qids
               for _ in range(2)]
    for t in threads:
        t.start()
    append_corpus(world["temb"], tc, VectorStore(store.directory),
                  tombstone=[victim])
    info = svc.refresh()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join()
    after = {i: tuple(h["page_id"] for h in svc.search(queries[i], k=10))
             for i in qids}
    assert not errors and info["swap_ms"] >= 0
    for i in qids:
        assert seen[i] <= {before[i], after[i]}, i
    assert victim not in after[qids[0]]
    svc.close()


def test_refresh_through_the_index_and_defaults_to_cuda(world, tmp_path):
    tc = world["grown"][400][1]
    store = VectorStore(_copy(world, tmp_path / "s"))
    IVFIndex.build(store, nlist=8, iters=3, seed=0, device="cpu")
    svc = _svc(world, store, index="ivf", nprobe=8)
    append_corpus(world["temb"], tc, VectorStore(store.directory),
                  tombstone=[4])
    info = svc.refresh()
    assert info["index_update"]["action"] == "incremental"
    assert info["index_generation"] == 1 and "index_error" not in info
    assert svc.incremental_updates == 1 and svc.full_rebuilds == 0
    assert svc.metrics()["index_generation"] == 1
    # an index that cannot serve degrades the view, visibly
    info = svc.refresh(update_index=False)
    assert info["index_generation"] == 1 and "index_error" not in info
    os.remove(os.path.join(store.directory, "ivf", "centroids.npy"))
    info = svc.refresh(update_index=False)
    assert "index_error" in info and svc.index is None
    svc.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IVFIndex.update(VectorStore(store.directory))


# -- the CLI --------------------------------------------------------------------

CLI_OV = {"data.num_pages": 600, "data.trigram_buckets": 1024,
          "model.embed_dim": 16, "model.conv_channels": 32,
          "model.out_dim": 16, "eval.embed_batch_size": 128,
          "eval.store_shard_size": 256}


def _cli_args(wd, ov, *extra):
    args = ["--config", "cdssm_toy", "--workdir", str(wd)]
    for k, v in ov.items():
        args += ["--set", f"{k}={v}"]
    return [*args, *extra]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_store_commands_print_the_jax_keys(tmp_path, capsys,
                                               monkeypatch):
    from dnn_page_vectors_tpu import cli as jcli
    from dnn_page_vectors_tpu_torch import cli
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    port, ref = tmp_path / "port", tmp_path / "jax"

    def both(command, *extra, ov=CLI_OV):
        cli.main([command, *_cli_args(port, ov, *extra), "--device", "cpu"])
        got = _last_json(capsys)
        jcli.main([command, *_cli_args(ref, ov, *extra)])
        want = _last_json(capsys)
        want.pop("fault_counters", None)
        assert sorted(got) == sorted(want), (command, got, want)
        return got, want

    got, _ = both("init-store")
    assert got["model_step"] == 0
    for lo, hi in ((256, 600), (0, 256)):
        cli.main(["embed", *_cli_args(port, CLI_OV, "--start", str(lo),
                                      "--stop", str(hi)), "--device", "cpu"])
        jcli.main(["embed", *_cli_args(ref, CLI_OV, "--start", str(lo),
                                       "--stop", str(hi))])
        capsys.readouterr()
    assert sorted(os.listdir(port / "store")) == sorted(
        os.listdir(ref / "store"))
    got, _ = both("merge-store")
    assert got["shards"] == 3 and got["vectors"] == 600
    grown = {**CLI_OV, "data.num_pages": 700}
    got, _ = both("append", "--tombstone", "3,4", "--update-ids", "9",
                  ov=grown)
    assert (got["generation"], got["appended"], got["tombstoned"],
            got["store_vectors"], got["index_update"]) == (1, 100, 3, 701,
                                                           None)
    got, _ = both("refresh", ov=grown)
    assert got["action"] == "rebuild" and got["store_generation"] == 1
    got, _ = both("reset-store", ov=grown)
    assert got["dropped_vectors"] == 701
    assert not [n for n in os.listdir(port / "store")
                if n.startswith("gen-")]
