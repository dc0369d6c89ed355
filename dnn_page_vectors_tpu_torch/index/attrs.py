"""Per-row attribute words and the filtered-retrieval predicate language:
the port's copy of the JAX package's index/attrs.py (pure numpy, with a
torch evaluator for words on the card).

  * one packed little-endian ``uint32`` attribute word per corpus row, the
    bit-field layout versioned in the store manifest (``ATTRS_VERSION``)
    and written through the store's CRC-recording shard writer
    (infer/vector_store.py), so appends, compaction and migration carry
    the words;
  * a predicate grammar (``lang==X``, ``site in {...}``, ``recency>=B``
    and ``&`` conjunctions) compiled to (mask, value) word tests, one
    bitwise-and and compare an alternative, the same on the host (numpy,
    the posting gather's prefilter) and on the card (torch, the hot set's
    mask);
  * a canonical form (sorted terms and set members, buckets resolved)
    whose text is the wire encoding (infer/transport.py ``FLAG_FILTERS``)
    and the result cache's key component: two spellings of one filter
    are one key.

Site strings map to buckets through CRC32; nothing here reads a clock, a
generator or a file.
"""
from __future__ import annotations

import re
import zlib
from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Attribute word layout (version 1)
#
#   bits  0..7   language id        (0..255)
#   bits  8..23  site-hash bucket   (0..65535)
#   bits 24..27  recency band       (0..15, higher = fresher)
#   bits 28..31  reserved, must be zero
# ---------------------------------------------------------------------------

ATTRS_VERSION = 1
ATTR_DTYPE = np.dtype("<u4")          # one little-endian word per row

LANG_SHIFT, LANG_BITS = 0, 8
SITE_SHIFT, SITE_BITS = 8, 16
REC_SHIFT, REC_BITS = 24, 4

LANG_MAX = (1 << LANG_BITS) - 1
SITE_MAX = (1 << SITE_BITS) - 1
REC_MAX = (1 << REC_BITS) - 1

_LANG_MASK = LANG_MAX << LANG_SHIFT
_SITE_MASK = SITE_MAX << SITE_SHIFT
_REC_MASK = REC_MAX << REC_SHIFT


class FilterError(ValueError):
    """A predicate string failed to parse or a field value is out of range."""


def site_bucket(site: Union[str, int]) -> int:
    """A site name's hash bucket (CRC32 mod 2^16). Integers pass through as
    explicit bucket ids."""
    if isinstance(site, (int, np.integer)):
        b = int(site)
        if not 0 <= b <= SITE_MAX:
            raise FilterError(f"site bucket {b} out of range 0..{SITE_MAX}")
        return b
    return zlib.crc32(str(site).encode("utf-8")) & SITE_MAX


def pack_word(lang: int = 0, site: Union[str, int] = 0,
              recency: int = 0) -> int:
    """One attribute word; `site` is a name (hashed) or a bucket."""
    lang = int(lang)
    recency = int(recency)
    if not 0 <= lang <= LANG_MAX:
        raise FilterError(f"lang {lang} out of range 0..{LANG_MAX}")
    if not 0 <= recency <= REC_MAX:
        raise FilterError(f"recency {recency} out of range 0..{REC_MAX}")
    return ((lang << LANG_SHIFT) | (site_bucket(site) << SITE_SHIFT)
            | (recency << REC_SHIFT))


def pack_words(lang, site, recency) -> np.ndarray:
    """Arrays (or scalars, broadcast) -> uint32 words."""
    lang = np.asarray(lang, np.uint32)
    site = np.asarray(site, np.uint32)
    recency = np.asarray(recency, np.uint32)
    if lang.size and int(lang.max(initial=0)) > LANG_MAX:
        raise FilterError(f"lang out of range 0..{LANG_MAX}")
    if site.size and int(site.max(initial=0)) > SITE_MAX:
        raise FilterError(f"site bucket out of range 0..{SITE_MAX}")
    if recency.size and int(recency.max(initial=0)) > REC_MAX:
        raise FilterError(f"recency out of range 0..{REC_MAX}")
    out = ((lang << LANG_SHIFT) | (site << SITE_SHIFT)
           | (recency << REC_SHIFT))
    return np.ascontiguousarray(out, ATTR_DTYPE)


def unpack_word(word: int) -> Tuple[int, int, int]:
    """Inverse of pack_word -> (lang, site_bucket, recency)."""
    w = int(word)
    return ((w & _LANG_MASK) >> LANG_SHIFT,
            (w & _SITE_MASK) >> SITE_SHIFT,
            (w & _REC_MASK) >> REC_SHIFT)


def words_tensor(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 words -> an int32 tensor on `device`, the same bits.

    torch has few bitwise kernels for uint32 on CUDA; int32 loses nothing,
    because bits 28-31 are reserved zero in layout v1, so every word, mask
    and value stays below 2^28."""
    arr = np.ascontiguousarray(words, ATTR_DTYPE).view(np.int32)
    t = torch.from_numpy(arr)
    return t if device.type == "cpu" else t.to(device)


# ---------------------------------------------------------------------------
# Predicate language
#
# Grammar (whitespace-tolerant):
#   predicate := term ('&' term)*
#   term      := 'lang' '==' INT
#              | 'site' 'in' '{' member (',' member)* '}'
#              | 'recency' '>=' INT
#   member    := INT | NAME          (names hash through site_bucket)
#
# A term compiles to a disjunction of (mask, value) word tests; a row
# matches when every term has an alternative with (word & mask) == value.
# `recency>=B` unrolls to one alternative a band B..15, so the evaluators
# need no ordered comparison.
# ---------------------------------------------------------------------------

MAX_PREDICATE_BYTES = 512         # the wire decode's cap (rejects fuzz)
_MAX_TERMS = 16
_MAX_SET_MEMBERS = 64

_LANG_RE = re.compile(r"^lang\s*==\s*(\d+)$")
_REC_RE = re.compile(r"^recency\s*>=\s*(\d+)$")
_SITE_RE = re.compile(r"^site\s+in\s+\{([^{}]*)\}$")
_NAME_RE = re.compile(r"^[A-Za-z0-9_.:\-]+$")

Alts = Tuple[Tuple[int, int], ...]          # ((mask, value), ...)


class Predicate:
    """A compiled filter predicate in canonical form. Immutable; equality
    and hash follow the canonical `text`."""

    __slots__ = ("text", "conjuncts", "_masks", "_values")

    def __init__(self, text: str, conjuncts: Tuple[Alts, ...]):
        self.text = text
        self.conjuncts = conjuncts
        # each conjunct's alternatives as arrays, for the host evaluator
        self._masks = tuple(
            np.asarray([m for m, _ in alts], ATTR_DTYPE)
            for alts in conjuncts)
        self._values = tuple(
            np.asarray([v for _, v in alts], ATTR_DTYPE)
            for alts in conjuncts)

    # -- construction -------------------------------------------------------

    @classmethod
    def parse(cls, text: str) -> "Predicate":
        """Parse and canonicalize; FilterError on anything malformed."""
        if not isinstance(text, str):
            raise FilterError("predicate must be a string")
        if len(text.encode("utf-8")) > MAX_PREDICATE_BYTES:
            raise FilterError(
                f"predicate longer than {MAX_PREDICATE_BYTES} bytes")
        terms = [t.strip() for t in text.split("&")]
        if not terms or any(not t for t in terms):
            raise FilterError(f"empty term in predicate {text!r}")
        if len(terms) > _MAX_TERMS:
            raise FilterError(f"more than {_MAX_TERMS} terms")
        parsed = []                      # (sort key, canonical term, alts)
        for term in terms:
            m = _LANG_RE.match(term)
            if m:
                lang = int(m.group(1))
                if lang > LANG_MAX:
                    raise FilterError(
                        f"lang {lang} out of range 0..{LANG_MAX}")
                parsed.append(((0, lang, ()), f"lang=={lang}",
                               ((_LANG_MASK, lang << LANG_SHIFT),)))
                continue
            m = _REC_RE.match(term)
            if m:
                band = int(m.group(1))
                if band > REC_MAX:
                    raise FilterError(
                        f"recency band {band} out of range 0..{REC_MAX}")
                alts = tuple((_REC_MASK, b << REC_SHIFT)
                             for b in range(band, REC_MAX + 1))
                parsed.append(((1, band, ()), f"recency>={band}", alts))
                continue
            m = _SITE_RE.match(term)
            if m:
                raw = [s.strip() for s in m.group(1).split(",")]
                if not raw or any(not s for s in raw):
                    raise FilterError(f"empty member in {term!r}")
                if len(raw) > _MAX_SET_MEMBERS:
                    raise FilterError(
                        f"more than {_MAX_SET_MEMBERS} site members")
                buckets = set()
                for s in raw:
                    if s.isdigit():
                        buckets.add(site_bucket(int(s)))
                    elif _NAME_RE.match(s):
                        buckets.add(site_bucket(s))
                    else:
                        raise FilterError(f"bad site member {s!r}")
                ordered = tuple(sorted(buckets))
                canon = "site in {%s}" % ",".join(str(b) for b in ordered)
                alts = tuple((_SITE_MASK, b << SITE_SHIFT) for b in ordered)
                parsed.append(((2, 0, ordered), canon, alts))
                continue
            raise FilterError(f"cannot parse predicate term {term!r}")
        # canonical: sorted unique terms (a conjunction either way)
        parsed.sort(key=lambda p: p[0])
        seen = set()
        canon_terms, conjuncts = [], []
        for _, canon, alts in parsed:
            if canon in seen:
                continue
            seen.add(canon)
            canon_terms.append(canon)
            conjuncts.append(alts)
        return cls("&".join(canon_terms), tuple(conjuncts))

    # -- evaluation ---------------------------------------------------------

    def matches(self, words: np.ndarray) -> np.ndarray:
        """Host evaluation: uint32 words [N] -> bool [N]."""
        words = np.asarray(words, ATTR_DTYPE)
        ok = np.ones(words.shape, bool)
        for masks, values in zip(self._masks, self._values):
            ok &= ((words[..., None] & masks) == values).any(axis=-1)
        return ok

    def matches_device(self, words: torch.Tensor) -> torch.Tensor:
        """Evaluation on any device: int32 (``words_tensor``) or int64
        words -> bool, the tests of `matches` (one and and one compare an
        alternative), so the host prefilter and the hot set's mask on the
        card agree bit for bit."""
        ok = torch.ones(words.shape, dtype=torch.bool, device=words.device)
        for alts in self.conjuncts:
            hit = (words & alts[0][0]) == alts[0][1]
            for mask, val in alts[1:]:
                hit |= (words & mask) == val
            ok &= hit
        return ok

    # -- wire / identity ----------------------------------------------------

    def encode(self) -> bytes:
        """Wire bytes: the canonical utf-8 text (decode re-parses it)."""
        return self.text.encode("utf-8")

    def __eq__(self, other):
        return isinstance(other, Predicate) and other.text == self.text

    def __hash__(self):
        return hash(self.text)

    def __repr__(self):
        return f"Predicate({self.text!r})"


def decode_predicate(data: bytes) -> Predicate:
    """Inverse of Predicate.encode; FilterError on malformed bytes."""
    if len(data) > MAX_PREDICATE_BYTES:
        raise FilterError("predicate field too long")
    try:
        text = bytes(data).decode("utf-8")
    except UnicodeDecodeError as e:
        raise FilterError(f"predicate not utf-8: {e}") from None
    return Predicate.parse(text)


def compile_filters(spec: Union[None, str, Predicate]) -> Optional[Predicate]:
    """A user-facing `filters` argument -> Predicate or None: None and ""
    are unfiltered, strings parse, Predicates pass."""
    if spec is None:
        return None
    if isinstance(spec, Predicate):
        return spec
    if isinstance(spec, str):
        if not spec.strip():
            return None
        return Predicate.parse(spec)
    raise FilterError(f"filters must be a string or Predicate, "
                      f"got {type(spec).__name__}")


def parse_attr_assignments(pairs: Iterable[str]) -> int:
    """`lang=3 site=wiki.org recency=2` (cli append --attrs) -> a word.
    Unknown keys and out-of-range values raise FilterError naming the
    token."""
    lang, site, recency = 0, 0, 0
    for tok in pairs:
        if "=" not in tok:
            raise FilterError(f"bad --attrs token {tok!r} (want key=value)")
        key, _, val = tok.partition("=")
        key, val = key.strip(), val.strip()
        if not val:
            raise FilterError(f"empty value in --attrs token {tok!r}")
        if key == "lang":
            if not val.isdigit():
                raise FilterError(f"lang must be an integer, got {val!r}")
            lang = int(val)
        elif key == "site":
            site = int(val) if val.isdigit() else val
        elif key == "recency":
            if not val.isdigit():
                raise FilterError(f"recency must be an integer, got {val!r}")
            recency = int(val)
        else:
            raise FilterError(f"unknown --attrs key {key!r} "
                              "(want lang/site/recency)")
    return pack_word(lang=lang, site=site, recency=recency)


def attrs_manifest_section() -> dict:
    """The manifest stanza recorded when a store's attribute table is
    initialized; readers reject unknown layout versions."""
    return {"version": ATTRS_VERSION, "dtype": str(ATTR_DTYPE.name),
            "fields": {"lang": [LANG_SHIFT, LANG_BITS],
                       "site": [SITE_SHIFT, SITE_BITS],
                       "recency": [REC_SHIFT, REC_BITS]}}


def check_attrs_section(section: dict) -> None:
    """Validate a manifest attrs stanza; FilterError on another version."""
    ver = int(section.get("version", -1))
    if ver != ATTRS_VERSION:
        raise FilterError(
            f"unsupported attrs layout version {ver} "
            f"(this build speaks {ATTRS_VERSION})")
