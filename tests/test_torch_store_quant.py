"""The port's int8 vector store (infer/vector_store.py), its device-side
quantize (infer/bulk_embed.py ``quantize_rows``, ``embed_corpus`` into an
int8 store) and the int8 path of ops/topk.py against the JAX package on
the CPU, at small sizes: 3 shards of at most 150 rows, dim 48, seeded
numpy vectors.

Tolerances, each with its reason:
* store files, codes, scales, ids: byte-identical (the same float32
  operations, each correctly rounded, in both packages);
* the round trip: within scale / 2 per element (the codes are taken with
  the float16-rounded scale the reader uses);
* topk_over_store over an int8 store: scores within 1e-5, ids equal
  except where two scores tie within 1e-6 (float32 products of the same
  int8 codes summed in other orders)."""
import os

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.config import MeshConfig
from dnn_page_vectors_tpu.infer.vector_store import VectorStore as JaxStore
from dnn_page_vectors_tpu.ops.topk import topk_over_store as jax_topk_store
from dnn_page_vectors_tpu.parallel.mesh import make_mesh
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.loader import (
    build_corpus, build_tokenizer)
from dnn_page_vectors_tpu_torch.infer.bulk_embed import (
    BulkEmbedder, quantize_rows as device_quantize)
from dnn_page_vectors_tpu_torch.infer.vector_store import (
    VectorStore, quantize_rows)
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.ops.topk import chunked_topk, topk_over_store

DIM = 48
SHARDS = ((0, 150), (150, 300), (300, 360))


def _vectors(seed=0, n=360):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, DIM)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[7] = 0.0                       # an all-zero row: the scale's floor
    v[8, :] = 0.0
    v[8, 3] = 1.0                    # one non-zero element
    return v


def _write(cls, d, vecs, dtype="int8"):
    store = cls(d, dim=DIM, shard_size=150, dtype=dtype)
    for i, (lo, hi) in enumerate(SHARDS):
        ids = np.arange(lo, hi, dtype=np.int64)
        if i == 2:                   # batch padding rows are dropped
            ids = np.concatenate([ids, np.full(4, -1, np.int64)])
            vecs_i = np.concatenate([vecs[lo:hi], np.ones((4, DIM),
                                                          np.float32)])
        else:
            vecs_i = vecs[lo:hi]
        store.write_shard(i, ids, vecs_i)
    return store


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("quant")
    vecs = _vectors()
    return {"vecs": vecs,
            "port": _write(VectorStore, str(root / "port"), vecs),
            "jax": _write(JaxStore, str(root / "jax"), vecs)}


def test_int8_shards_byte_equal_to_jax_and_cross_read(stores):
    port, jax_ = stores["port"], stores["jax"]
    assert port.manifest["dtype"] == "int8" and port.row_bytes == DIM + 2
    assert port.row_bytes == jax_.row_bytes
    assert port.shards() == jax_.shards()
    for s in port.shards():
        assert set(s) >= {"vec", "ids", "scl"}
        for key in ("vec", "ids", "scl"):
            with open(os.path.join(port.directory, s[key]), "rb") as a, \
                    open(os.path.join(jax_.directory, s[key]), "rb") as b:
                assert a.read() == b.read(), (s["index"], key)
    # each package opens the other's store, integrity checks included,
    # and reads the same dequantized rows and raw codes
    cross_t, cross_j = VectorStore(jax_.directory), JaxStore(port.directory)
    assert cross_t.verify() == [] and cross_j.verify() == []
    for a, b in ((cross_t, jax_), (port, cross_j)):
        ids_a, v_a = a.load_all()
        ids_b, v_b = b.load_all()
        np.testing.assert_array_equal(ids_a, ids_b)
        assert v_a.dtype == v_b.dtype == np.float32
        np.testing.assert_array_equal(v_a, v_b)
    for (ia, ca, sa), (ib, cb, sb) in zip(port.iter_shards(raw=True),
                                          jax_.iter_shards(raw=True)):
        assert ca.dtype == np.int8 and sa.dtype == np.float16
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ca, np.asarray(cb))
        np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("prefetch", [0, 1])
def test_int8_round_trip_within_half_a_scale(stores, prefetch):
    vecs = stores["vecs"]
    ids, got = stores["port"].load_all()
    np.testing.assert_array_equal(ids, np.arange(360))
    scales = np.concatenate([s for _, _, s in stores["port"].iter_shards(
        raw=True, prefetch=prefetch)]).astype(np.float32)
    assert (np.abs(got - vecs) <= scales[:, None] / 2).all()
    assert not got[7].any()                 # the all-zero row stays zero
    assert np.count_nonzero(got[8]) == 1 and got[8, 3] > 0.999
    for (i0, v0), (i1, c1, s1) in zip(
            stores["port"].iter_shards(prefetch=prefetch),
            stores["port"].iter_shards(raw=True, prefetch=prefetch)):
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(
            v0, np.asarray(c1, np.float32) * s1.astype(np.float32)[:, None])
        if prefetch:
            assert not isinstance(c1, np.memmap)


def test_pre_quantized_codes_write_the_same_files(stores, tmp_path):
    vecs = stores["vecs"][:150]
    codes, scales = quantize_rows(vecs)
    port = VectorStore(str(tmp_path / "p"), dim=DIM, shard_size=150,
                       dtype="int8")
    port.write_shard(0, np.arange(150), codes=codes, scales=scales)
    jax_ = JaxStore(str(tmp_path / "j"), dim=DIM, shard_size=150,
                    dtype="int8")
    jax_.write_shard(0, np.arange(150), codes=codes, scales=scales)
    ref = stores["port"].shards()[0]
    for key in ("vec", "ids", "scl"):
        want = open(os.path.join(stores["port"].directory, ref[key]),
                    "rb").read()
        for d in (port.directory, jax_.directory):
            with open(os.path.join(d, ref[key]), "rb") as f:
                assert f.read() == want, key
    fp16 = VectorStore(str(tmp_path / "f"), dim=DIM, shard_size=150)
    with pytest.raises(ValueError, match="int8 store"):
        fp16.write_shard(0, np.arange(150), codes=codes, scales=scales)


def test_device_quantize_equals_host_quantize():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(257, DIM)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[0] = 0.0
    v[1] *= 1e-6                     # a scale under float16's normal range
    v16 = v.astype(np.float16)
    codes, scales = device_quantize(torch.from_numpy(v16))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float16
    h_codes, h_scales = quantize_rows(v16)
    np.testing.assert_array_equal(codes.numpy(), h_codes)
    np.testing.assert_array_equal(scales.numpy(), h_scales)


def test_embed_corpus_into_int8_store_equals_host_quantize(tmp_path):
    """The bulk embed quantizes on the device (here the CPU): its shards
    equal the host quantization of the float16 store's rows of the same
    embedder, byte for byte."""
    cfg = get_config("cdssm_toy", {
        "data.num_pages": 200, "data.trigram_buckets": 512,
        "model.embed_dim": 16, "model.conv_channels": 32,
        "model.out_dim": 24, "eval.embed_batch_size": 50})
    corpus = build_corpus(cfg)
    q_tok, p_tok = build_tokenizer(cfg, corpus)
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device="cpu")
    emb = BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device="cpu")
    fp16 = VectorStore(str(tmp_path / "fp16"), dim=24, shard_size=100)
    q8 = VectorStore(str(tmp_path / "q8"), dim=24, shard_size=100,
                     dtype="int8")
    emb.embed_corpus(corpus, fp16)
    emb.embed_corpus(corpus, q8)
    host = VectorStore(str(tmp_path / "host"), dim=24, shard_size=100,
                       dtype="int8")
    for entry in fp16.shards():
        ids, v16 = fp16._load_entry(entry)
        host.write_shard(entry["index"], ids, np.asarray(v16))
    assert [s["count"] for s in q8.shards()] == [100, 100]
    for a, b in zip(q8.iter_shards(raw=True), host.iter_shards(raw=True)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    codes, scales = emb.encode_pages_q8(torch.from_numpy(
        p_tok.encode_batch([corpus.page_text(i) for i in range(3)])))
    _, raw, scl = next(q8.iter_shards(raw=True))
    np.testing.assert_array_equal(codes.numpy(), raw[:3])
    np.testing.assert_array_equal(scales.numpy(), scl[:3])


def test_dtype_switch_requires_reset(tmp_path):
    store = VectorStore(str(tmp_path), dim=16, shard_size=32, dtype="int8")
    store.write_shard(0, np.arange(4), np.ones((4, 16), np.float32))
    with pytest.raises(ValueError, match="dtype"):
        VectorStore(str(tmp_path), dtype="float16")
    store.reset()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".npy")]
    assert VectorStore(str(tmp_path), dtype="float16").manifest[
        "dtype"] == "float16"
    with pytest.raises(ValueError, match="unsupported store dtype"):
        VectorStore(str(tmp_path / "x"), dim=16, dtype="bfloat16")


def test_corrupt_scale_file_is_quarantined(stores, tmp_path):
    import shutil
    d = str(tmp_path / "store")
    shutil.copytree(stores["port"].directory, d)
    scl = os.path.join(d, "shard_00001.scl.npy")
    with open(scl, "r+b") as f:
        f.seek(140)
        b = f.read(1)
        f.seek(140)
        f.write(bytes([b[0] ^ 0xFF]))
    store = VectorStore(d)
    assert store.completed_shards() == {0, 2}
    assert os.path.exists(scl + ".quarantined")
    assert os.path.exists(os.path.join(d, "shard_00001.vec.npy.quarantined"))


@pytest.mark.parametrize("k,chunk", [(10, 64), (5, 1000)])
def test_topk_over_int8_store_matches_jax(stores, k, chunk):
    rng = np.random.default_rng(k)
    q = rng.normal(size=(37, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mesh = make_mesh(MeshConfig(data=1))
    want_s, want_i = jax_topk_store(q, stores["jax"], mesh, k=k, chunk=chunk,
                                    query_batch=16)
    got_s, got_i = topk_over_store(q, stores["port"], k=k, chunk=chunk,
                                   query_batch=16, device="cpu")
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    differ = got_i != want_i
    assert (np.abs(got_s - want_s)[differ] <= 1e-6).all()
    # against the dequantized store scored whole
    ids, deq = stores["port"].load_all()
    want = np.sort(q @ deq.T, axis=1)[:, ::-1][:, :k]
    np.testing.assert_allclose(got_s, want, rtol=0, atol=1e-5)
    # chunked_topk: scales multiply the float32 product of the codes
    _, codes, scl = next(stores["port"].iter_shards(raw=True))
    s, i = chunked_topk(torch.from_numpy(q), torch.from_numpy(
        np.array(codes)), k=k, chunk=chunk, scales=torch.from_numpy(scl))
    full = (q @ np.asarray(codes, np.float32).T) * scl.astype(
        np.float32)[None]
    np.testing.assert_allclose(s.numpy(), np.sort(full, axis=1)[:, ::-1][
        :, :k], rtol=0, atol=1e-6)
