"""The port's attribute words and predicate language (index/attrs.py)
against the JAX package's on the same seeded inputs: the word codec, the
canonical forms, the host evaluator, the torch evaluator (on the CPU here;
tests/test_torch_filtered_cuda.py runs it on the card) against JAX's
``matches_device`` and the host, the rejection of malformed and fuzzed
predicates with the JAX package's FilterError text, ``--attrs``
assignments and the manifest section. Every comparison is exact: the
module is integer bit work and CRC32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.index import attrs as J
from dnn_page_vectors_tpu_torch.index import attrs as A

PREDICATES = (
    "lang==0", "lang==1", "lang == 255", "site in {0}", "site in {3, 1}",
    "site in {example.org, 7, wiki.org}", "recency>=0", "recency >= 3",
    "recency>=15", "site in {3,1} & lang==2 & recency >= 1",
    "recency>=1&lang == 2&site in {1,3}", "lang==1 & lang==1",
    "lang==1 & lang==2", "site in {a.b:c-d_e}")
BAD = ["", "lang", "lang==", "lang==999", "bogus==1", "site in {",
       "site in 3", "recency>=99", "lang==1 &", "lang=1", "site in {a b}",
       "site in {,}", "site in {" + ",".join(map(str, range(65))) + "}",
       " & ".join(["lang==1"] * 17), "x" * 600, "site in {70000}"]


def _words(n, seed):
    rng = np.random.default_rng(seed)
    return J.pack_words(lang=rng.integers(0, 4, n).astype(np.uint32),
                        site=rng.integers(0, 12, n).astype(np.uint32),
                        recency=rng.integers(0, 16, n).astype(np.uint32))


def _error(fn, *args):
    """The exception's type name and text, or None."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 -- compared across packages
        return type(e).__name__, str(e)
    return None


def test_word_codec_equals_jax():
    rng = np.random.default_rng(7)
    for _ in range(200):
        lang = int(rng.integers(0, A.LANG_MAX + 1))
        site = int(rng.integers(0, A.SITE_MAX + 1))
        rec = int(rng.integers(0, A.REC_MAX + 1))
        w = A.pack_word(lang=lang, site=site, recency=rec)
        assert w == J.pack_word(lang=lang, site=site, recency=rec)
        assert A.unpack_word(w) == J.unpack_word(w) == (lang, site, rec)
    langs = rng.integers(0, A.LANG_MAX + 1, 64).astype(np.uint32)
    sites = rng.integers(0, A.SITE_MAX + 1, 64).astype(np.uint32)
    recs = rng.integers(0, A.REC_MAX + 1, 64).astype(np.uint32)
    got = A.pack_words(lang=langs, site=sites, recency=recs)
    want = J.pack_words(lang=langs, site=sites, recency=recs)
    assert got.dtype == A.ATTR_DTYPE == J.ATTR_DTYPE
    assert got.tobytes() == want.tobytes()
    for name in ("example.org", "wiki.org", "a", "ünïcode.de", ""):
        assert A.site_bucket(name) == J.site_bucket(name)
        assert A.pack_word(site=name) == J.pack_word(site=name)
    assert A.site_bucket(np.int64(123)) == J.site_bucket(np.int64(123)) == 123
    # bits 28-31 stay zero: every word fits an int32
    assert int(A.pack_word(lang=255, site=65535, recency=15)) < 2 ** 28
    for kw in ({"lang": 256}, {"recency": 16}, {"site": 65536},
               {"lang": -1}):
        got = _error(lambda: A.pack_word(**kw))
        assert got is not None and got == _error(lambda: J.pack_word(**kw))
        assert got[0] == "FilterError"
    for arrs in ((np.array([256]), np.array([0]), np.array([0])),
                 (np.array([0]), np.array([65536]), np.array([0])),
                 (np.array([0]), np.array([0]), np.array([16]))):
        assert _error(A.pack_words, *arrs) == _error(J.pack_words, *arrs)
        assert _error(A.pack_words, *arrs)[0] == "FilterError"


def test_canonical_forms_and_host_matches_equal_jax():
    words = _words(5000, 3)
    for text in PREDICATES:
        p, q = A.Predicate.parse(text), J.Predicate.parse(text)
        assert p.text == q.text, text
        assert p.conjuncts == q.conjuncts, text
        assert p.encode() == q.encode()
        np.testing.assert_array_equal(p.matches(words), q.matches(words))
        # eq and hash follow the canonical text
        again = A.Predicate.parse(p.text)
        assert again == p and hash(again) == hash(p) and repr(p) == repr(q)
    p1 = A.Predicate.parse("site in {3, 1} & lang==2 & recency >= 1")
    p2 = A.Predicate.parse("recency>=1&lang == 2&site in {1,3}")
    assert p1 == p2 and p1.text == "lang==2&recency>=1&site in {1,3}"
    w = A.pack_words(lang=np.array([2, 2, 1, 2], np.uint32),
                     site=np.array([1, 5, 3, 3], np.uint32),
                     recency=np.array([1, 3, 2, 0], np.uint32))
    assert list(p1.matches(w)) == [True, False, False, False]
    # recency>=B is a lower bound, not an equality
    assert list(A.Predicate.parse("recency>=2").matches(w)) == \
        [False, True, True, False]
    # lang==1 & lang==2 matches nothing; the all-zero word matches the
    # default scenarios of the filtered load mix
    assert not A.Predicate.parse("lang==1 & lang==2").matches(words).any()
    zero = np.zeros(3, np.uint32)
    for text in ("lang==0", "site in {0}", "recency>=0"):
        assert A.Predicate.parse(text).matches(zero).all()


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_matches_device_equals_jax_and_the_host(dtype):
    words = _words(4096, 5)
    if dtype == "int32":
        t = A.words_tensor(words, torch.device("cpu"))
        assert t.dtype == torch.int32
        assert t.numpy().view(np.uint32).tobytes() == words.tobytes()
    else:
        t = torch.from_numpy(words.astype(np.int64))
    for text in PREDICATES:
        p = A.Predicate.parse(text)
        got = p.matches_device(t)
        assert got.dtype == torch.bool and got.shape == (4096,)
        want = np.asarray(J.Predicate.parse(text).matches_device(
            jnp.asarray(words)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), p.matches(words))


def test_rejects_malformed_and_fuzzed_predicates_as_jax_does():
    for text in BAD:
        got = _error(A.Predicate.parse, text)
        assert got is not None and got[0] == "FilterError", text
        assert got == _error(J.Predicate.parse, text), text
    assert _error(A.Predicate.parse, 3) == _error(J.Predicate.parse, 3)
    over = b"x" * (A.MAX_PREDICATE_BYTES + 1)
    assert _error(A.decode_predicate, over) == \
        _error(J.decode_predicate, over) == \
        ("FilterError", "predicate field too long")
    for text in PREDICATES:
        p = A.decode_predicate(A.Predicate.parse(text).encode())
        assert p.text == J.decode_predicate(
            J.Predicate.parse(text).encode()).text
    # seeded garbage: the same outcome in both, and only FilterError
    rng = np.random.default_rng(11)
    for _ in range(300):
        blob = rng.integers(0, 256, int(rng.integers(0, 80))).astype(
            np.uint8).tobytes()
        got = _error(A.decode_predicate, blob)
        assert got == _error(J.decode_predicate, blob)
        if got is None:
            assert A.decode_predicate(blob).text == \
                J.decode_predicate(blob).text
        else:
            assert got[0] == "FilterError"
    for spec in (None, "", "   ", "lang==1", A.Predicate.parse("lang==1")):
        got = A.compile_filters(spec)
        want = J.compile_filters(getattr(spec, "text", spec))
        assert (got is None) == (want is None)
        if got is not None:
            assert got.text == want.text
    assert _error(A.compile_filters, 5) == _error(J.compile_filters, 5)


def test_parse_attr_assignments_equals_jax():
    for toks in (["lang=3", "site=wiki.org", "recency=2"], ["site=7"], [],
                 ["recency=15", "lang=0"], ["site=65535"]):
        assert A.parse_attr_assignments(toks) == \
            J.parse_attr_assignments(toks)
    w = A.parse_attr_assignments(["lang=3", "site=wiki.org", "recency=2"])
    assert A.unpack_word(w) == (3, A.site_bucket("wiki.org"), 2)
    for bad in (["tag=1"], ["lang"], ["lang=x"], ["recency=99"],
                ["lang="], ["site=70000"], ["recency=a"]):
        got = _error(A.parse_attr_assignments, bad)
        assert got is not None and got[0] == "FilterError", bad
        assert got == _error(J.parse_attr_assignments, bad), bad


def test_manifest_section_equals_jax():
    assert A.attrs_manifest_section() == J.attrs_manifest_section()
    assert A.check_attrs_section(A.attrs_manifest_section()) is None
    for sec in ({"version": 2}, {}):
        got = _error(A.check_attrs_section, sec)
        assert got is not None and got[0] == "FilterError"
        assert got == _error(J.check_attrs_section, sec)
