"""The port's jsonl corpora against the JAX package's: write_synth_jsonl
writes the JAX writer's file byte for byte, whole and in start-aligned
parts; JsonlCorpus agrees with JAX's on num_pages, every text route (bulk,
one at a time, pairs, all_texts, the raw lines), the fast extract's punt
cases and the fingerprint; build_corpus accepts "jsonl:<path>"."""
import json

import numpy as np
import pytest

from dnn_page_vectors_tpu.data.jsonl import JsonlCorpus as JaxCorpus
from dnn_page_vectors_tpu.data.synth import write_synth_jsonl as jax_write
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
from dnn_page_vectors_tpu_torch.data.loader import build_corpus
from dnn_page_vectors_tpu_torch.data.synth import write_synth_jsonl


@pytest.mark.parametrize("kw", [
    {"seed": 11, "page_len": 32, "query_len": 8},
    {"seed": 3, "num_topics": 5, "page_len": 12, "query_len": 4,
     "block": 64}])
def test_synth_writer_byte_identical_to_jax(tmp_path, kw):
    port = write_synth_jsonl(str(tmp_path / "port.jsonl"), 300, **kw)
    want = jax_write(str(tmp_path / "jax.jsonl"), 300, **kw)
    got = open(port, "rb").read()
    assert got == open(want, "rb").read()
    assert got.count(b"\n") == 300
    assert not list(tmp_path.glob("*.tmp.*"))


def test_synth_writer_parts_concatenate_to_the_whole(tmp_path):
    kw = {"seed": 5, "num_topics": 7, "page_len": 10, "query_len": 4,
          "block": 64}
    whole = open(write_synth_jsonl(str(tmp_path / "w.jsonl"), 300, **kw),
                 "rb").read()
    parts = b""
    for lo, hi in ((0, 128), (128, 256), (256, 300)):
        path = str(tmp_path / f"p{lo}.jsonl")
        parts += open(write_synth_jsonl(path, hi, start=lo, **kw),
                      "rb").read()
        jax_part = jax_write(str(tmp_path / f"j{lo}.jsonl"), hi, start=lo,
                             **kw)
        assert open(path, "rb").read() == open(jax_part, "rb").read()
    assert parts == whole
    with pytest.raises(ValueError, match="multiple of"):
        write_synth_jsonl(str(tmp_path / "x.jsonl"), 300, start=10, **kw)


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("jsonl")
    path = str(d / "c.jsonl")
    write_synth_jsonl(path, 200, seed=2, num_topics=6, page_len=14,
                      query_len=5, block=64)
    # the fast extract's punt cases, blank lines and a record with no query
    with open(path, "ab") as f:
        f.write(b"\n   \n")
        f.write(b'{"query": "q \\"esc\\"", "page": "p \\u00fc\\ud800"}\n')
        f.write(b'{"page": "first", "page": "second", "query": "dup"}\n')
        f.write(b'{"meta": {"page": "inner"}, "page": "outer"}\n')
        f.write(b'{"page": "no query here"}\n')
        f.write(b'{"page":"tight", "query":\t"tab"}\n')
        f.write('{"query": "ünï", "page": "日本語 テキスト"}'.encode())
    return path


def test_jsonl_corpus_equals_jax(corpus_file):
    port, jax_ = JsonlCorpus(corpus_file), JaxCorpus(corpus_file)
    assert port.native_index and jax_.native_index
    assert port.num_pages == jax_.num_pages == 206
    np.testing.assert_array_equal(port.offsets, jax_._offsets)
    ids = np.random.default_rng(0).permutation(port.num_pages)
    assert port.page_texts(ids) == jax_.page_texts(ids)
    assert port.query_texts(ids) == jax_.query_texts(ids)
    assert [port.page_text(i) for i in range(200, 206)] == \
        [jax_.page_text(i) for i in range(200, 206)]
    assert [port.query_text(i) for i in range(200, 206)] == \
        [jax_.query_text(i) for i in range(200, 206)]
    assert port.page_texts(range(200, 206))[:3] == [
        "p ü\ud800", "second", "outer"]
    assert port.query_text(203) == ""
    assert list(port.pairs(190)) == list(jax_.pairs(190))
    assert list(port.all_texts()) == list(jax_.all_texts())
    assert port.page_lines(ids[:20]) == jax_.page_lines(ids[:20])
    # the fingerprint: the same form, and the same string for one file
    fp = port.fingerprint()
    assert fp == jax_.fingerprint()
    kind, path, size, mtime, n = fp.split(":")
    assert (kind, path, int(n)) == ("jsonl", corpus_file, 206)
    plain = JsonlCorpus(corpus_file, use_native=False)
    assert not plain.native_index and plain.fingerprint() == fp
    np.testing.assert_array_equal(plain.offsets, port.offsets)


def test_jsonl_corpus_threads_read_their_own_handles(corpus_file):
    import concurrent.futures
    port = JsonlCorpus(corpus_file)
    want = [port.page_texts(range(s, s + 20)) for s in range(0, 200, 20)]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        for _ in range(3):
            got = list(ex.map(lambda s: port.page_texts(range(s, s + 20)),
                              range(0, 200, 20)))
            assert got == want


def test_build_corpus_accepts_jsonl(corpus_file, tmp_path):
    cfg = get_config("cdssm_toy", {"data.corpus": f"jsonl:{corpus_file}"})
    corpus = build_corpus(cfg)
    assert isinstance(corpus, JsonlCorpus) and corpus.num_pages == 206
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n\n")
    with pytest.raises(ValueError, match="empty corpus"):
        build_corpus(get_config("cdssm_toy",
                                {"data.corpus": f"jsonl:{empty}"}))
    with pytest.raises(ValueError, match="unknown corpus"):
        build_corpus(get_config("cdssm_toy", {"data.corpus": "csv:x"}))
    # a record is what json.loads gives, whatever the extract took
    lines = open(corpus_file, "rb").read().split(b"\n")
    assert [json.loads(ln)["page"] for ln in lines if ln.strip()] == \
        corpus.page_texts(range(206))
