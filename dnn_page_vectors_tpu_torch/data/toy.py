"""Deterministic synthetic query->page corpus: the port's own copy of the
JAX package's data/toy.py, kept byte-identical in every page and query text
it generates (tests/test_torch_serve.py pins that).

Pages and queries are generated on demand from the page id, so a 100M-page
corpus costs no storage. Every page belongs to a topic and is mostly topic
words plus a few page-unique "key" words; its query shares the key words and
some topic words, which makes Recall@10 learnable.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

_SYLLABLES = [
    "ba", "be", "bi", "bo", "bu", "da", "de", "di", "do", "du",
    "fa", "fe", "fi", "fo", "fu", "ga", "ge", "gi", "go", "gu",
    "ka", "ke", "ki", "ko", "ku", "la", "le", "li", "lo", "lu",
    "ma", "me", "mi", "mo", "mu", "na", "ne", "ni", "no", "nu",
    "pa", "pe", "pi", "po", "pu", "ra", "re", "ri", "ro", "ru",
    "sa", "se", "si", "so", "su", "ta", "te", "ti", "to", "tu",
    "va", "ve", "vi", "vo", "vu", "za", "ze", "zi", "zo", "zu",
]


def _make_word(rng: np.random.Generator, n_syll: int) -> str:
    idx = rng.integers(0, len(_SYLLABLES), size=n_syll)
    return "".join(_SYLLABLES[i] for i in idx)


class ToyCorpus:
    """Deterministic query->page corpus; page i's gold query is query_text(i).

    Multilingual mode (`languages` > 1, the config-5 cross-lingual eval,
    BASELINE.md:25): each language is a deterministic bijective permutation
    of the syllable inventory, applied to the same underlying content.
    Page i is written in language i % L while its query is written in
    language (i+1) % L — so retrieval only works if the model learns the
    cross-language syllable correspondences (pure lexical overlap is zero
    between different languages). Language 0 is the identity, so
    languages=1 reproduces the monolingual corpus exactly.
    """

    # its texts are made by Python code, which holds the GIL: reader
    # threads would contend, not overlap (data/loader.py read_workers)
    threaded_reads = False

    def __init__(self, num_pages: int = 10_000, seed: int = 0,
                 num_topics: int = 64, page_len: int = 48, query_len: int = 8,
                 languages: int = 1):
        self.num_pages = num_pages
        self.seed = seed
        self.num_topics = num_topics
        self.page_len = page_len
        self.query_len = query_len
        self.languages = max(1, languages)
        master = np.random.default_rng(seed)
        # Common words shared by all topics (noise floor).
        self.common_words: List[str] = sorted(
            {_make_word(master, 2) for _ in range(300)})
        # Per-topic vocabularies; each topic draws from its own syllable
        # subset so even character trigrams separate topics.
        self.topic_words: List[List[str]] = []
        for _ in range(num_topics):
            words = sorted({_make_word(master, 3) for _ in range(48)})
            self.topic_words.append(words)
        # Language l remaps syllable s -> _SYLLABLES[perm_l[s]]; language 0
        # is the identity.
        self._syll_index = {s: k for k, s in enumerate(_SYLLABLES)}
        self._lang_perm: List[np.ndarray] = [
            np.arange(len(_SYLLABLES))]
        for l in range(1, self.languages):
            lrng = np.random.default_rng(seed * 5_000_011 + l)
            self._lang_perm.append(lrng.permutation(len(_SYLLABLES)))

    def fingerprint(self) -> str:
        """Stable identity for tokenizer-cache invalidation."""
        return (f"toy:{self.num_pages}:{self.seed}:{self.num_topics}:"
                f"{self.page_len}:{self.query_len}:{self.languages}")

    # -- languages --------------------------------------------------------
    def page_language(self, i: int) -> int:
        return i % self.languages

    def query_language(self, i: int) -> int:
        return (i + 1) % self.languages

    def _translate_word(self, word: str, lang: int) -> str:
        if lang == 0:
            return word
        perm = self._lang_perm[lang]
        out = []
        for j in range(0, len(word) - 1, 2):
            syl = word[j: j + 2]
            k = self._syll_index.get(syl)
            out.append(_SYLLABLES[perm[k]] if k is not None else syl)
        if len(word) % 2:                   # key-word digit suffix survives
            out.append(word[-1])
        return "".join(out)

    def _translate(self, text: str, lang: int) -> str:
        if lang == 0:
            return text
        return " ".join(self._translate_word(w, lang) for w in text.split())

    # -- generation -------------------------------------------------------
    def _page_rng(self, i: int) -> np.random.Generator:
        return np.random.default_rng((self.seed * 1_000_003 + i) & 0x7FFFFFFF)

    def _key_words(self, i: int) -> List[str]:
        """Two words unique to page i, present in both page and query."""
        rng = np.random.default_rng((self.seed * 2_000_003 + i) & 0x7FFFFFFF)
        return [_make_word(rng, 4) + str(i % 10), _make_word(rng, 4)]

    def topic_of(self, i: int) -> int:
        return i % self.num_topics

    def page_text(self, i: int) -> str:
        rng = self._page_rng(i)
        topic = self.topic_words[self.topic_of(i)]
        n = self.page_len
        words = []
        for _ in range(n):
            if rng.random() < 0.75:
                words.append(topic[rng.integers(0, len(topic))])
            else:
                words.append(self.common_words[rng.integers(0, len(self.common_words))])
        keys = self._key_words(i)
        # plant key words at deterministic-but-spread positions
        for j, kw in enumerate(keys * 3):  # each key appears 3x
            words[(7 * (j + 1) + i) % n] = kw
        return self._translate(" ".join(words), self.page_language(i))

    def query_text(self, i: int) -> str:
        rng = np.random.default_rng((self.seed * 3_000_017 + i) & 0x7FFFFFFF)
        topic = self.topic_words[self.topic_of(i)]
        keys = self._key_words(i)
        words = list(keys)
        while len(words) < self.query_len:
            words.append(topic[rng.integers(0, len(topic))])
        order = rng.permutation(len(words))
        return self._translate(" ".join(words[k] for k in order),
                               self.query_language(i))

    # -- iteration --------------------------------------------------------
    def pairs(self, start: int = 0, stop: int | None = None
              ) -> Iterator[Tuple[int, str, str]]:
        stop = self.num_pages if stop is None else min(stop, self.num_pages)
        for i in range(start, stop):
            yield i, self.query_text(i), self.page_text(i)

    def all_texts(self, limit: int | None = None) -> Iterator[str]:
        """Text stream for vocab/subword training."""
        stop = self.num_pages if limit is None else min(limit, self.num_pages)
        for i in range(stop):
            yield self.page_text(i)
            yield self.query_text(i)
