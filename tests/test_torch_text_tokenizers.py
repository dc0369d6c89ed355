"""The port's trigram and word tokenizers (data/trigram.py, data/words.py)
and their place in data/loader.py (build_tokenizer, TrainBatcher) against
the JAX package's on the CPU: token ids, vocabs and train batches must be
byte-equal, and a vocab file saved by either package must load in the
other."""
import json
import os

import numpy as np
import pytest

from dnn_page_vectors_tpu.config import get_config as jax_get_config
from dnn_page_vectors_tpu.data.loader import TrainBatcher as JaxBatcher
from dnn_page_vectors_tpu.data.loader import build_tokenizer as jax_tokenizer
from dnn_page_vectors_tpu.data.toy import ToyCorpus as JaxCorpus
from dnn_page_vectors_tpu.data.trigram import TrigramTokenizer as JaxTrigram
from dnn_page_vectors_tpu.data.trigram import fnv1a as jax_fnv1a
from dnn_page_vectors_tpu.data.trigram import (
    word_trigrams as jax_word_trigrams)
from dnn_page_vectors_tpu.data.words import WordTokenizer as JaxWords
from dnn_page_vectors_tpu_torch.config import get_config
from dnn_page_vectors_tpu_torch.data.loader import (
    TrainBatcher, build_tokenizer)
from dnn_page_vectors_tpu_torch.data.toy import ToyCorpus
from dnn_page_vectors_tpu_torch.data.trigram import (
    TrigramTokenizer, fnv1a, word_trigrams)
from dnn_page_vectors_tpu_torch.data.words import WordTokenizer

CORPUS = dict(num_pages=400, seed=0, page_len=20, query_len=6)
# the JAX package's native self-check probe (data/trigram.py): Unicode
# whitespace (NBSP, LS), multi-byte words, a lone surrogate, a 300-char word
PROBE = ("ab cd ef " + "x" * 300 + " fin" + " 日本語 ünï " + chr(0xD800)
         + "g")
EDGE_TEXTS = [PROBE, "", "   ", "a", "a b c", "one two three",
              " ".join(f"w{i}" for i in range(80)),       # > max_words
              "supercalifragilistic ab"]                  # > k trigrams


def _texts():
    c = ToyCorpus(**CORPUS)
    return ([c.page_text(i) for i in range(100)]
            + [c.query_text(i) for i in range(100)] + EDGE_TEXTS)


def test_fnv1a_and_trigrams_match_jax():
    for word in ["", "a", "ab", "日本語", "x" * 40, chr(0xD800) + "g"]:
        assert word_trigrams(word) == jax_word_trigrams(word)
        for tg in word_trigrams(word):
            data = tg.encode("utf-8", "surrogatepass")
            assert fnv1a(data) == jax_fnv1a(data)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("buckets,max_words,k", [(16_384, 64, 8),
                                                 (4_096, 6, 3)])
def test_trigram_tokens_equal_jax(use_native, buckets, max_words, k):
    """Byte for byte against the JAX Python path and its C++ path, on toy
    pages and queries, the probe, the empty text, one-letter words and
    the max_words and k truncations."""
    texts = _texts()
    want_tok = JaxTrigram(buckets, max_words=max_words, k=k,
                          use_native=use_native)
    assert (want_tok._native is not None) == use_native
    tok = TrigramTokenizer(buckets, max_words=max_words, k=k)
    got, want = tok.encode_batch(texts), want_tok.encode_batch(texts)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == (len(texts), max_words, k)
    np.testing.assert_array_equal(got, want)
    for t in EDGE_TEXTS:
        np.testing.assert_array_equal(tok.encode(t), want_tok.encode(t))
    assert tok.vocab_size == want_tok.vocab_size == buckets + 1
    assert not tok.encode("").any()
    one = tok.encode("a")                   # "#a#": one trigram
    assert one[0, 0] > 0 and not one[0, 1:].any() and not one[1:].any()
    assert got.max() <= buckets and got.min() >= 0
    np.testing.assert_array_equal(tok.encode_batch([]),
                                  want_tok.encode_batch([]))


def _vocab_texts():
    return list(JaxCorpus(**CORPUS).all_texts())


def test_word_vocab_equals_jax(tmp_path):
    texts = _vocab_texts()
    want = JaxWords.train(texts, vocab_size=300, max_words=12,
                          strict_vocab=True)
    got = WordTokenizer.train(texts, vocab_size=300, max_words=12,
                              strict_vocab=True)
    assert got.vocab == want.vocab and got.vocab_size == 300
    sample = texts[:50] + ["", "zzz unknown words", " ".join(texts[:3])]
    np.testing.assert_array_equal(got.encode_batch(sample),
                                  want.encode_batch(sample))
    assert got.encode("zzzz")[0] == 1 and got.encode("")[0] == 0
    # a file saved by one loads in the other
    got.meta = {"vocab_size": 300, "corpus": "toy"}
    got.save(str(tmp_path / "port.json"))
    back = JaxWords.load(str(tmp_path / "port.json"))
    assert back.vocab == want.vocab and back.max_words == 12
    assert back.meta == got.meta
    want.save(str(tmp_path / "jax.json"))
    mine = WordTokenizer.load(str(tmp_path / "jax.json"))
    assert mine.vocab == want.vocab and mine.max_words == 12
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert set(json.load(f)) == set(json.load(g))
    # a vocab of more words than the corpus holds raises
    with pytest.raises(ValueError, match="unique words"):
        WordTokenizer.train(texts[:20], vocab_size=5_000, strict_vocab=True)
    small = WordTokenizer.train(texts[:20], vocab_size=5_000)
    assert small.vocab == JaxWords.train(texts[:20], vocab_size=5_000).vocab


def test_word_vocab_scan_stops_early():
    """The scan stops at 1.5 x vocab_size unique words (+ 1,000), as the
    JAX package's does: both read the same prefix of the corpus."""
    seen = {"port": 0, "jax": 0}

    def counted(key):
        for t in _vocab_texts():
            seen[key] += 1
            yield t
    got = WordTokenizer.train(counted("port"), vocab_size=200)
    want = JaxWords.train(counted("jax"), vocab_size=200)
    assert got.vocab == want.vocab
    assert seen["port"] == seen["jax"] < CORPUS["num_pages"] * 2


@pytest.mark.parametrize("tokenizer,extra", [
    ("trigram", {"data.trigram_buckets": 2_048,
                 "data.trigrams_per_word": 4}),
    ("word", {"data.vocab_size": 300})])
def test_build_tokenizer_and_batches_equal_jax(tmp_path, monkeypatch,
                                               tokenizer, extra):
    """build_tokenizer for trigram (stateless) and word (cached with its
    provenance), then the first 2 TrainBatcher batches, byte-equal to the
    JAX package's on the same seed."""
    ov = {"data.num_pages": 400, "data.page_len": 20, "data.query_len": 6,
          "data.tokenizer": tokenizer, **extra}
    jcfg = jax_get_config("cdssm_toy", ov)
    tcfg = get_config("cdssm_toy", ov)
    jc, tc = JaxCorpus(**CORPUS), ToyCorpus(**CORPUS)
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
    jq, jp = jax_tokenizer(jcfg, jc, cache_dir=str(tmp_path / "jax"))
    tq, tp = build_tokenizer(tcfg, tc, cache_dir=str(tmp_path / "port"))
    assert tp.vocab_size == jp.vocab_size
    cached = os.path.join(tmp_path, "port", f"tokenizer_{tokenizer}.json")
    assert os.path.exists(cached) == (tokenizer == "word")
    if tokenizer == "word":
        assert tp.meta == jp.meta and tp.vocab == jp.vocab
        assert (tq.max_words, tp.max_words) == (6, 20)
        # the cache is reused while its provenance holds; the JAX
        # package's cache file serves the port too
        monkeypatch.setattr(WordTokenizer, "train", None)
        again_q, again_p = build_tokenizer(
            tcfg, tc, cache_dir=str(tmp_path / "jax"))
        assert again_p.vocab == tp.vocab and again_p.meta == tp.meta
    jb = JaxBatcher(jc, jq, jp, batch_size=32, seed=5, process_index=0,
                    process_count=1)
    tb = TrainBatcher(tc, tq, tp, batch_size=32, seed=5)
    for (_, want), (_, got) in zip(zip(range(2), jb), zip(range(2), tb)):
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if tokenizer == "trigram":
        assert got["page"].shape == (32, 20, 4)
        assert got["query"].shape == (32, 6, 4)
