"""The port's host data path on the CPU: the tokenizer worker pool
(``ordered_parallel_map``), ``TrainBatcher`` and ``iter_corpus_batches``
with 4 workers over a jsonl corpus against the JAX package's (byte for
byte), ``embed_corpus`` with 4 workers writing the store files of one
worker (fp16 and int8, a 1-layer BERT), the background shard writer's
error contract and ``prefetch_to_device``'s."""
import os
import threading
import time

import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.data.jsonl import JsonlCorpus as JaxCorpus
from dnn_page_vectors_tpu.data.loader import TrainBatcher as JaxBatcher
from dnn_page_vectors_tpu.data.loader import \
    iter_corpus_batches as jax_iter_batches
from dnn_page_vectors_tpu.data.subword import SubwordTokenizer as JaxSubword
from dnn_page_vectors_tpu.data.trigram import TrigramTokenizer as JaxTrigram
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
from dnn_page_vectors_tpu_torch.data.loader import (
    TrainBatcher, build_tokenizer, fused_encode, iter_corpus_batches,
    ordered_parallel_map, prefetch_to_device)
from dnn_page_vectors_tpu_torch.data.subword import SubwordTokenizer
from dnn_page_vectors_tpu_torch.data.synth import write_synth_jsonl
from dnn_page_vectors_tpu_torch.data.trigram import TrigramTokenizer
from dnn_page_vectors_tpu_torch.infer.bulk_embed import BulkEmbedder
from dnn_page_vectors_tpu_torch.infer.vector_store import VectorStore
from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
from dnn_page_vectors_tpu_torch.utils.profiling import PipelineProfiler

N = 400



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests: pytest-xdist workers
    share the host's cores, and more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("host")
    path = str(d / "c.jsonl")
    write_synth_jsonl(path, N, seed=4, num_topics=8, page_len=20,
                      query_len=6, block=128)
    with open(path, "ab") as f:       # a record the fused extract punts on
        f.write(b'{"query": "q \\"x\\"", "page": "esc \\u00fc page"}\n')
    corpus = JsonlCorpus(path)
    vocab = SubwordTokenizer.train(corpus.all_texts(), vocab_size=300,
                                   max_tokens=24).vocab
    return {"path": path, "corpus": corpus, "vocab": vocab,
            "jax_corpus": JaxCorpus(path)}


def _lookup(ids):
    ids = np.asarray(ids, np.int64)
    return ((ids[:, None] * 7 + np.arange(1, 4)[None, :]) % (N + 1)
            ).astype(np.int32)


def test_ordered_parallel_map_keeps_order_and_raises_in_place():
    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.01, size=40)

    def fn(i):
        time.sleep(delays[i])
        return i * i

    assert list(ordered_parallel_map(fn, range(40), workers=4)) == \
        [i * i for i in range(40)]
    assert list(ordered_parallel_map(fn, range(5), workers=1)) == \
        [0, 1, 4, 9, 16]

    def bad(i):
        time.sleep(delays[i])
        if i == 13:
            raise KeyError("batch 13")
        return i

    got = []
    with pytest.raises(KeyError, match="batch 13"):
        for x in ordered_parallel_map(bad, range(40), workers=4):
            got.append(x)
    assert got == list(range(13))     # everything before it, in order


def test_ordered_parallel_map_stops_when_abandoned():
    calls = []
    lock = threading.Lock()

    def fn(i):
        with lock:
            calls.append(i)
        time.sleep(0.005)
        return i

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = ordered_parallel_map(fn, endless(), workers=4, depth=2)
    assert [next(it) for _ in range(10)] == list(range(10))
    it.close()
    time.sleep(0.1)
    n = len(calls)
    time.sleep(0.1)
    assert len(calls) == n <= 10 + 4 + 2   # the window, and nothing after


@pytest.mark.parametrize("pack,negatives", [(1, False), (1, True),
                                            (4, False), (4, True)])
def test_train_batcher_with_workers_equals_jax(world, pack, negatives):
    port_tok = SubwordTokenizer(world["vocab"], max_tokens=24)
    port_q = SubwordTokenizer(world["vocab"], max_tokens=8)
    jax_tok = JaxSubword(world["vocab"], max_tokens=24)
    jax_q = JaxSubword(world["vocab"], max_tokens=8)
    lookup = _lookup if negatives else None
    prof = PipelineProfiler()
    port = TrainBatcher(world["corpus"], port_q, port_tok, batch_size=32,
                        seed=3, start_step=5, hard_negative_lookup=lookup,
                        pack=pack, workers=4, profiler=prof)
    # one worker and the plain encoders: the unfused route
    serial = TrainBatcher(world["corpus"],
                          SubwordTokenizer(world["vocab"], max_tokens=8,
                                           use_native=False),
                          SubwordTokenizer(world["vocab"], max_tokens=24,
                                           use_native=False),
                          batch_size=32, seed=3, start_step=5,
                          hard_negative_lookup=lookup, pack=pack)
    assert port.fused and not serial.fused
    jax_ = JaxBatcher(world["jax_corpus"], jax_q, jax_tok, batch_size=32,
                      seed=3, start_step=5, hard_negative_lookup=lookup,
                      process_index=0, process_count=1, workers=4, pack=pack)

    def take(batcher, steps=15):    # past an epoch's end (12 of 32)
        return [b for _, b in zip(range(steps), batcher)]

    for a, b, c in zip(take(port), take(serial), take(jax_)):
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            assert a[k].dtype == c[k].dtype, k
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ("neg_page" in a) == negatives
    assert ("page_seg" in a) == (pack > 1)
    assert {"read", "tokenize"} <= set(prof.stages())


def test_trigram_train_batcher_with_workers_equals_jax(world):
    args = dict(batch_size=50, seed=1)
    port = iter(TrainBatcher(world["corpus"], TrigramTokenizer(512, 6, 4),
                             TrigramTokenizer(512, 20, 4), workers=4,
                             **args))
    jax_ = iter(JaxBatcher(world["jax_corpus"], JaxTrigram(512, 6, 4),
                           JaxTrigram(512, 20, 4), process_index=0,
                           process_count=1, **args))
    for _ in range(9):
        a, b = next(port), next(jax_)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_iter_corpus_batches_fused_equals_plain_and_jax(world):
    tok = SubwordTokenizer(world["vocab"], max_tokens=24)
    assert fused_encode(world["corpus"], tok)
    plain_tok = SubwordTokenizer(world["vocab"], max_tokens=24,
                                 use_native=False)
    assert not fused_encode(world["corpus"], plain_tok)
    jax_tok = JaxSubword(world["vocab"], max_tokens=24)
    prof = PipelineProfiler()
    fused = list(iter_corpus_batches(world["corpus"], tok, 64, start=64,
                                     workers=4, profiler=prof))
    plain = list(iter_corpus_batches(world["corpus"], plain_tok, 64,
                                     start=64))
    jax_ = list(jax_iter_batches(world["jax_corpus"], jax_tok, 64, start=64,
                                 workers=4))
    assert len(fused) == len(plain) == len(jax_) == 6
    for a, b, c in zip(fused, plain, jax_):
        for k in ("page", "page_id"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])
    assert (fused[-1]["page_id"] == -1).sum() == 64 - (N + 1 - 64) % 64
    assert prof.counts()["tokenize"] == 6


def _bert_embedder(world, dtype="float32"):
    cfg = get_config("bert_mini_v5p16", {
        "data.corpus": f"jsonl:{world['path']}", "data.vocab_size": 300,
        "data.page_len": 24, "data.query_len": 8, "model.num_layers": 1,
        "model.model_dim": 32, "model.num_heads": 2, "model.mlp_dim": 64,
        "model.out_dim": 16, "model.dtype": dtype,
        "eval.embed_batch_size": 32})
    q_tok = SubwordTokenizer(world["vocab"], max_tokens=8)
    p_tok = SubwordTokenizer(world["vocab"], max_tokens=24)
    torch.manual_seed(0)
    model = build_two_tower(cfg, vocab_size=p_tok.vocab_size, device="cpu")
    return BulkEmbedder(cfg, model, p_tok, query_tok=q_tok, device="cpu")


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".npy"):
            out[name] = open(os.path.join(d, name), "rb").read()
    return out


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_embed_corpus_with_workers_writes_the_serial_store(world, tmp_path,
                                                           dtype):
    emb = _bert_embedder(world)
    stores = {}
    for workers in (1, 4):
        d = str(tmp_path / f"w{workers}")
        store = VectorStore(d, dim=16, shard_size=128, dtype=dtype)
        prof = PipelineProfiler()
        emb.embed_corpus(world["corpus"], store, workers=workers,
                         profiler=prof)
        assert store.num_vectors == N + 1 and len(store.shards()) == 4
        assert emb.stats["pages"] == N + 1 and emb.stats["workers"] == workers
        for key in ("produce_s", "device_wait_s", "write_s",
                    "stage_read_s", "stage_tokenize_s", "stage_write_s",
                    "stage_produce_wait_s", "stage_compute_s"):
            assert key in emb.stats, key
        stores[workers] = _files(d)
    assert stores[1].keys() == stores[4].keys() and len(stores[1]) >= 8
    for name in stores[1]:
        assert stores[1][name] == stores[4][name], name


def test_a_failing_shard_writer_reraises(world, tmp_path, monkeypatch):
    emb = _bert_embedder(world)
    store = VectorStore(str(tmp_path / "s"), dim=16, shard_size=128)
    real = store.write_shard

    class DiskFull(OSError):
        pass

    def write_shard(index, *a, **kw):
        if index == 1:
            raise DiskFull("no space left (shard 1)")
        return real(index, *a, **kw)

    monkeypatch.setattr(store, "write_shard", write_shard)
    with pytest.raises(DiskFull, match="shard 1"):
        emb.embed_corpus(world["corpus"], store, workers=4)
    assert store.completed_shards() <= {0, 2}
    assert 1 not in store.completed_shards()
    assert not [t for t in threading.enumerate()
                if t.name == "shard-writer" and t.is_alive()]
    # an error of the main path wins over the writer's
    monkeypatch.setattr(store, "write_shard", write_shard)
    calls = {"n": 0}
    real_encode = emb.encode_pages

    def encode_pages(ids):
        calls["n"] += 1
        if calls["n"] == 9:                   # in shard 2 of a fresh sweep
            raise ValueError("device failure")
        return real_encode(ids)

    monkeypatch.setattr(emb, "encode_pages", encode_pages)
    store2 = VectorStore(str(tmp_path / "s2"), dim=16, shard_size=128)
    monkeypatch.setattr(store2, "write_shard", write_shard)
    with pytest.raises(ValueError, match="device failure"):
        emb.embed_corpus(world["corpus"], store2, workers=2,
                         write_pending=4)
    # resume re-embeds exactly the shards that never completed
    monkeypatch.setattr(emb, "encode_pages", real_encode)
    fresh = VectorStore(str(tmp_path / "s"))
    emb.embed_corpus(world["corpus"], fresh, workers=4)
    assert fresh.num_vectors == N + 1


def test_prefetch_to_device_reraises_and_stops():
    def batches(fail_at):
        for i in range(10):
            if i == fail_at:
                raise IndexError(f"producer broke at {i}")
            yield {"x": np.full((2, 3), i, np.int32),
                   "page_id": np.arange(2) + i}

    prof = PipelineProfiler()
    got = list(prefetch_to_device(batches(None), torch.device("cpu"),
                                  profiler=prof, host_keys=("page_id",)))
    assert [int(b["x"][0, 0]) for b in got] == list(range(10))
    assert isinstance(got[0]["x"], torch.Tensor)
    assert isinstance(got[0]["page_id"], np.ndarray)
    assert prof.counts()["produce_wait"] == 11
    seen = []
    with pytest.raises(RuntimeError, match="prefetch producer failed") as ei:
        for b in prefetch_to_device(batches(4), torch.device("cpu")):
            seen.append(int(b["x"][0, 0]))
    assert seen == [0, 1, 2, 3]
    assert isinstance(ei.value.__cause__, IndexError)

    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield {"x": np.full(4, i)}
                i += 1
        finally:
            closed.set()

    it = prefetch_to_device(endless(), torch.device("cpu"), depth=2)
    assert [int(next(it)["x"][0]) for _ in range(5)] == list(range(5))
    it.close()
    assert closed.wait(5)
    for t in threading.enumerate():
        if t.name == "prefetch-producer":
            t.join(5)
            assert not t.is_alive()


def test_build_tokenizer_sets_threads_and_trainer_uses_the_pool(world,
                                                                 tmp_path):
    from dnn_page_vectors_tpu_torch.train.loop import Trainer
    cfg = get_config("bert_mini_v5p16", {
        "data.corpus": f"jsonl:{world['path']}", "data.vocab_size": 300,
        "data.page_len": 24, "data.query_len": 8,
        "data.tokenize_threads": 3, "data.tokenize_workers": 3,
        "model.num_layers": 1, "model.model_dim": 32, "model.num_heads": 2,
        "model.mlp_dim": 64, "model.out_dim": 16, "model.dtype": "float32",
        "model.dropout": 0.0, "train.batch_size": 32, "train.log_every": 2})
    q, p = build_tokenizer(cfg, world["corpus"], cache_dir=str(tmp_path))
    assert q.threads == p.threads == 3 and p.vocab_size == 300
    tr = Trainer(cfg, device="cpu")
    out = tr.train(steps=2)
    assert np.isfinite(out["loss"]) and tr.step == 2
    stages = tr.profiler.stages()
    assert {"read", "tokenize", "produce_wait"} <= set(stages)


def test_concurrent_encodes_while_the_encode_pool_grows(world, monkeypatch):
    """Tokenizer workers share the C++ encoder cache and the subword
    encode's thread pool, which one of them replaces (to grow it) while
    others submit to it: 16 threads over tokenizers of 2 to 6 encode
    threads, with a short switch interval; every result equals the plain
    encode."""
    import concurrent.futures
    import sys

    from dnn_page_vectors_tpu_torch.data import subword
    from dnn_page_vectors_tpu_torch.native import subword_native
    monkeypatch.setattr(subword, "_POOL", None)
    monkeypatch.setattr(subword, "_POOL_SIZE", 0)
    monkeypatch.setattr(subword_native, "_CACHE",
                        type(subword_native._CACHE)())
    texts = (world["corpus"].page_texts(range(N)) * 4)[:1_600]
    want = SubwordTokenizer(world["vocab"], max_tokens=24,
                            use_native=False).encode_batch(texts)

    def work(i):
        tok = SubwordTokenizer(dict(world["vocab"]), max_tokens=24)
        tok.threads = 2 + i % 5
        return all(np.array_equal(tok.encode_batch(texts), want)
                   for _ in range(3))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            futs = [ex.submit(work, i) for i in range(16)]
            assert all(f.result(timeout=120) for f in futs)
    finally:
        sys.setswitchinterval(old)
    assert subword._POOL_SIZE == 6
    assert len(subword_native._CACHE) == 1      # one C++ map for the vocab


def test_a_toy_corpus_is_read_in_one_thread(world):
    """ToyCorpus makes its texts in Python under the GIL, so the loader
    reads it in one thread whatever `workers` says; a jsonl corpus gets
    the pool. The batches are the same either way."""
    from dnn_page_vectors_tpu_torch.data.loader import read_workers
    from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
    toy = ToyCorpus(num_pages=64, seed=1)
    assert read_workers(toy, 4) == 1
    assert read_workers(world["corpus"], 4) == 4
    assert read_workers(world["corpus"], 0) == 1
    tok = TrigramTokenizer(256, 8, 3)
    assert TrainBatcher(toy, tok, tok, batch_size=16, workers=4).workers == 1
    a = [b["page"] for b in iter_corpus_batches(toy, tok, 16, workers=4)]
    b = [b["page"] for b in iter_corpus_batches(toy, tok, 16)]
    assert len(a) == 4 and all(np.array_equal(x, y) for x, y in zip(a, b))
