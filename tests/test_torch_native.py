"""The port's C++ host library (dnn_page_vectors_tpu_torch/native/) against
the JAX package: the trigram hash (one text and batches), the jsonl line
index, the WordPiece and SentencePiece batch encodes, the threaded encode,
the fused jsonl extract + encode and a random-unicode fuzz, each equal to
both the JAX package's Python path and its C++ path. Also: the library is
built into build/torch_native/ (never into the package), two processes
building at once leave one loadable library, and a failed build raises
instead of falling back to the Python encoders."""
import json
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from dnn_page_vectors_tpu.data.subword import SubwordTokenizer as JaxSubword
from dnn_page_vectors_tpu.data.trigram import TrigramTokenizer as JaxTrigram
from dnn_page_vectors_tpu.native import jsonl_native as jax_jsonl_native
from dnn_page_vectors_tpu_torch import native
from dnn_page_vectors_tpu_torch.data import subword as port_subword
from dnn_page_vectors_tpu_torch.data.jsonl import JsonlCorpus
from dnn_page_vectors_tpu_torch.data.subword import SubwordTokenizer
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.data.trigram import TrigramTokenizer
from dnn_page_vectors_tpu_torch.native import jsonl_native, trigram_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EDGE = ["", "a", "ab", "abc", "unknownwordxyz", "  spaced   out  ",
        "ünïcôdé wörds ärë fïne", "日本語 テキスト", "x" * 500,
        "\tmixed\nwhitespace\r here", " nbsp\xa0separated　words",
        "lone " + chr(0xD800) + " surrogate",
        " ".join("tok" for _ in range(64))]


def _toy_texts(n, seed):
    corpus = ToyCorpus(num_pages=n, seed=seed)
    return ([corpus.page_text(i) for i in range(n)]
            + [corpus.query_text(i) for i in range(n)])


def _fuzz_texts(n=300, seed=0):
    rng = random.Random(seed)
    pool = (list("abcdefgh0123 ") + list("äöüßéñç") + list("日本語中文한국")
            + ["🙂", "👍", "́"]                 # astral + combining
            + ["\t", "\n", "\r", "\x0b", "\x0c", "\x1c", "\x85", "\xa0",
               " ", " ", " ", " ", "　"]
            + [chr(0xD800)])                          # lone surrogate
    return ["".join(rng.choice(pool) for _ in range(rng.randint(0, 60)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def vocabs():
    texts = _toy_texts(300, 5)
    return {style: SubwordTokenizer.train(texts, vocab_size=600, style=style,
                                          max_tokens=24).vocab
            for style in ("wordpiece", "sentencepiece")}


@pytest.mark.parametrize("buckets,max_words,k", [(4096, 32, 6),
                                                 (512, 16, 4)])
def test_trigram_single_and_batch_equal_jax(buckets, max_words, k):
    texts = _toy_texts(50, 3) + EDGE
    port = TrigramTokenizer(buckets, max_words=max_words, k=k)
    assert port.path == "native"
    jax_py = JaxTrigram(buckets, max_words=max_words, k=k, use_native=False)
    jax_c = JaxTrigram(buckets, max_words=max_words, k=k)
    assert jax_c._native is not None
    batch = port.encode_batch(texts)
    assert batch.dtype == np.int32
    np.testing.assert_array_equal(batch, jax_c.encode_batch(texts))
    for j, t in enumerate(texts):
        want = jax_py.encode(t)
        np.testing.assert_array_equal(port.encode(t), want, err_msg=repr(t))
        np.testing.assert_array_equal(batch[j], want, err_msg=repr(t))
        np.testing.assert_array_equal(
            trigram_native.encode(t, buckets, max_words, k), want)
    plain = TrigramTokenizer(buckets, max_words=max_words, k=k,
                             use_native=False)
    assert plain.path == "python"
    np.testing.assert_array_equal(plain.encode_batch(texts), batch)
    assert port.encode_batch([]).shape == (0, max_words, k)


def test_jsonl_index_offsets_equal_jax(tmp_path):
    p = tmp_path / "corpus.jsonl"
    # blank lines, whitespace-only lines, CRLF, unicode, no final newline
    p.write_bytes(b'{"page": "one"}\n\n   \t  \n{"page": "two"}\r\n'
                  b'{"page": "\xc3\xbcnic\xc3\xb4de"}\n\r\n'
                  b'{"page": "last, no newline"}')
    got = jsonl_native.index_offsets(str(p))
    assert got.dtype == np.int64 and len(got) == 4 and got[0] == 0
    np.testing.assert_array_equal(got, JsonlCorpus.scan_offsets(str(p)))
    np.testing.assert_array_equal(got, jax_jsonl_native.index_offsets(str(p)))
    from dnn_page_vectors_tpu.data.jsonl import JsonlCorpus as JaxCorpus
    np.testing.assert_array_equal(got, JaxCorpus(str(p))._offsets)
    for name, data in (("empty", b""), ("blank", b"\n  \n\t\n")):
        q = tmp_path / f"{name}.jsonl"
        q.write_bytes(data)
        assert jsonl_native.index_offsets(str(q)).size == 0
        assert jax_jsonl_native.index_offsets(str(q)).size == 0
    with pytest.raises(OSError, match="cannot read"):
        jsonl_native.index_offsets(str(tmp_path / "missing.jsonl"))
    # a file big enough for several of the scan's 1 MiB reads
    big = tmp_path / "big.jsonl"
    with open(big, "wb") as f:
        for i in range(60_000):
            f.write(b'{"query": "q%d", "page": "page text %d"}\n' % (i, i)
                    + (b"\n" if i % 7 == 0 else b""))
    got = jsonl_native.index_offsets(str(big))
    assert len(got) == 60_000
    np.testing.assert_array_equal(got, JsonlCorpus.scan_offsets(str(big)))
    np.testing.assert_array_equal(got,
                                  jax_jsonl_native.index_offsets(str(big)))


@pytest.mark.parametrize("style", ["wordpiece", "sentencepiece"])
def test_subword_batch_encode_equal_jax(vocabs, style):
    texts = _toy_texts(50, 7) + EDGE
    port = SubwordTokenizer(vocabs[style], style=style, max_tokens=24)
    assert port.path == "native"
    jax_tok = JaxSubword(vocabs[style], style=style, max_tokens=24)
    assert jax_tok._native_encoder() is not None
    want = np.stack([jax_tok.encode(t) for t in texts])     # JAX Python
    got = port.encode_batch(texts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_tok.encode_batch(texts))
    plain = SubwordTokenizer(vocabs[style], style=style, max_tokens=24,
                             use_native=False)
    np.testing.assert_array_equal(plain.encode_batch(texts), want)
    for j, t in enumerate(texts[-len(EDGE):]):
        np.testing.assert_array_equal(port.encode(t), want[50 * 2 + j])
    # the query and the page tokenizer of one vocab share one C++ map
    q = SubwordTokenizer(dict(vocabs[style]), style=style, max_tokens=8)
    assert q.native_encoder() is port.native_encoder()


def test_threaded_encode_equal_jax(vocabs):
    texts = _toy_texts(300, 5)
    batch = [texts[i % len(texts)] for i in range(1_100)]
    port = SubwordTokenizer(vocabs["wordpiece"], max_tokens=24)
    jax_tok = JaxSubword(vocabs["wordpiece"], max_tokens=24)
    want = jax_tok.encode_batch(batch)
    jax_tok.threads = 4
    np.testing.assert_array_equal(jax_tok.encode_batch(batch), want)
    port.threads = 4
    got = port.encode_batch(batch)
    assert port_subword._POOL is not None and port_subword._POOL_SIZE >= 4
    np.testing.assert_array_equal(got, want)
    # chunks of 256 or more: 1,100 texts take 4 chunks, 600 take 2
    np.testing.assert_array_equal(port.encode_batch(batch[:600]), want[:600])


def test_fused_jsonl_encode_equal_jax(vocabs):
    lines = [
        b'{"query": "q", "page": "hello world"}\n',
        b'{"query": "q", "page": "esc \\" aped"}\n',          # escape
        b'{"page": "first", "page": "second"}\n',             # duplicate
        b'{"obj": {"page": "inner"}, "page": "outer"}\n',     # nesting
        '{"page": "ünïcôdé wörds 日本語"}\n'.encode("utf-8"),
        b'{"page": "\\u00fcber \\ud800 x"}\n',               # \u escapes
        b'{"page":"   spaced   out   "}\n',
        b'{"page": ""}\n',
        b'{"query": "only a query"}\n',                       # no page
    ]
    port = SubwordTokenizer(vocabs["wordpiece"], max_tokens=24)
    jax_tok = JaxSubword(vocabs["wordpiece"], max_tokens=24)
    pages = lines[:-1]
    want = np.stack([jax_tok.encode(json.loads(ln)["page"]) for ln in pages])
    got = port.encode_jsonl_lines(pages, "page")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_tok.encode_jsonl_lines(pages,
                                                                  "page"))
    wantq = np.stack([jax_tok.encode(json.loads(ln).get("query", ""))
                      for ln in lines])
    np.testing.assert_array_equal(port.encode_jsonl_lines(lines, "query"),
                                  wantq)
    with pytest.raises(KeyError):       # a record without the page field
        port.encode_jsonl_lines(lines[-1:], "page")
    plain = SubwordTokenizer(vocabs["wordpiece"], max_tokens=24,
                             use_native=False)
    with pytest.raises(ValueError, match="use_native=False"):
        plain.encode_jsonl_lines(pages)


def test_random_unicode_fuzz_equal_jax(vocabs):
    texts = _fuzz_texts()
    port = TrigramTokenizer(512, max_words=16, k=4)
    jax_py = JaxTrigram(512, max_words=16, k=4, use_native=False)
    jax_c = JaxTrigram(512, max_words=16, k=4)
    want = np.stack([jax_py.encode(t) for t in texts])
    np.testing.assert_array_equal(port.encode_batch(texts), want)
    np.testing.assert_array_equal(jax_c.encode_batch(texts), want)
    sub = SubwordTokenizer(vocabs["sentencepiece"], style="sentencepiece",
                           max_tokens=24)
    jsub = JaxSubword(vocabs["sentencepiece"], style="sentencepiece",
                      max_tokens=24)
    want = np.stack([jsub.encode(t) for t in texts])
    np.testing.assert_array_equal(sub.encode_batch(texts), want)
    np.testing.assert_array_equal(jsub.encode_batch(texts), want)
    # the same texts as jsonl lines through the fused route
    lines = [json.dumps({"page": t}).encode("utf-8", "surrogatepass")
             + b"\n" for t in texts]
    np.testing.assert_array_equal(sub.encode_jsonl_lines(lines), want)


def test_library_lands_in_build_dir():
    lib = native.build()
    assert lib.parent == native.BUILD_DIR
    assert str(native.BUILD_DIR) == os.path.join(ROOT, "build",
                                                 "torch_native")
    assert lib.exists() and lib.suffix == ".so"
    pkg = os.path.join(ROOT, "dnn_page_vectors_tpu_torch", "native")
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    assert native.load() is native.load()
    # the key follows the sources: same tree, same name
    assert native.build() == lib


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {ROOT!r})
        from dnn_page_vectors_tpu_torch import native
        native.BUILD_DIR = Path(sys.argv[1])
        native.load()
        print(native.build().name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = {o[0].strip() for o in outs}
    files = sorted(os.listdir(tmp_path))
    assert len(names) == 1 and files == sorted(names), (names, files)
    check = textwrap.dedent(f"""
        import ctypes, sys
        lib = ctypes.CDLL(sys.argv[1])
        print(bool(lib.dpv_encode_trigrams_batch and lib.dpv_jsonl_index
                   and lib.dpv_bpe_encode_jsonl_batch))
    """)
    proc = subprocess.run([sys.executable, "-c", check,
                           str(tmp_path / files[0])],
                          capture_output=True, text=True, timeout=60)
    assert proc.stdout.strip() == "True", proc.stderr


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="false"):
        native.load()
    # a compiler that answers --version but fails to compile
    fake = tmp_path / "fake-cxx"
    fake.write_text('#!/bin/sh\nif [ "$1" = "--version" ]; then '
                    'echo fake 1.0; exit 0; fi\necho broken >&2; exit 1\n')
    fake.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(fake))
    with pytest.raises(RuntimeError, match="failed to build"):
        native.load()
    assert not list((tmp_path / "build").glob("*"))
    with pytest.raises(RuntimeError, match="failed to build"):
        TrigramTokenizer(64, max_words=4, k=2).encode_batch(["hello world"])
    from dnn_page_vectors_tpu_torch.native import subword_native
    monkeypatch.setattr(subword_native, "_CACHE", type(subword_native._CACHE)())
    with pytest.raises(RuntimeError, match="failed to build"):
        SubwordTokenizer({"ab": 2, "c": 3}).encode_batch(["abc"])
    corpus = tmp_path / "c.jsonl"
    corpus.write_text('{"query": "q", "page": "p"}\n')
    with pytest.raises(RuntimeError, match="failed to build"):
        JsonlCorpus(str(corpus))
    # the plain versions run only where a caller asks for them
    assert JsonlCorpus(str(corpus), use_native=False).num_pages == 1
    assert TrigramTokenizer(64, max_words=4, k=2, use_native=False
                            ).encode_batch(["hello world"]).shape == (1, 4, 2)
