// Native path of the char-trigram hashing tokenizer (data/trigram.py). The
// tokenizer runs on the host for every page the bulk embed and the trainer
// read, and the per-character Python loop is the from-text path's host
// bottleneck; this C++ version is bound with ctypes (a plain C ABI, no
// PyTorch headers), which drops the GIL for the length of each call.
//
// Semantics mirror trigram.py exactly (tests assert bit-equality):
//   * words split on UNICODE whitespace — the same set as Python's
//     str.split() (ASCII ws, U+1C-1F, NEL, NBSP, U+1680, U+2000-200A,
//     LS/PS, U+202F, U+205F, U+3000)
//   * per word: "#" + word + "#", trigrams over UTF-8 *codepoints*
//   * id = 1 + FNV1a64(utf8 bytes of the trigram) % buckets, 0 = pad
//   * at most `k` trigrams per word, at most `max_words` words; words are
//     never length-truncated (Python doesn't truncate either).

#include <cstdint>
#include <cstring>
#include <string>

#include "unicode_util.h"

namespace {

using dpv::decode_cp;
using dpv::is_space_cp;
using dpv::utf8_len;

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;

inline uint64_t fnv1a(const char* data, int64_t n) {
  uint64_t h = kFnvOffset;
  for (int64_t i = 0; i < n; ++i) {
    h ^= static_cast<uint8_t>(data[i]);
    h *= kFnvPrime;
  }
  return h;
}

// Only the first k+2 codepoints of "#word#" can contribute trigrams, so
// offset bookkeeping is bounded even for unbounded word lengths. 512
// covers any practical k (trigram.py defaults k=8).
constexpr int kMaxWordCps = 512;

// Encode one word (already bracketed with '#') into out[0..k).
inline void encode_word(const char* w, int64_t wlen, int32_t buckets,
                        int32_t k, int32_t* out) {
  // codepoint start offsets
  int32_t offs[kMaxWordCps + 1];
  int ncp = 0;
  int64_t i = 0;
  while (i < wlen && ncp < kMaxWordCps) {
    offs[ncp++] = static_cast<int32_t>(i);
    i += utf8_len(static_cast<unsigned char>(w[i]));
  }
  offs[ncp] = static_cast<int32_t>(i < wlen ? i : wlen);
  if (ncp < 3) {  // word shorter than one trigram: hash the whole unit
    out[0] = 1 + static_cast<int32_t>(fnv1a(w, offs[ncp]) %
                                      static_cast<uint64_t>(buckets));
    return;
  }
  int n_tg = ncp - 2;
  if (n_tg > k) n_tg = k;
  for (int t = 0; t < n_tg; ++t) {
    const char* start = w + offs[t];
    int64_t len = offs[t + 3 <= ncp ? t + 3 : ncp] - offs[t];
    out[t] = 1 + static_cast<int32_t>(fnv1a(start, len) %
                                      static_cast<uint64_t>(buckets));
  }
}

}  // namespace

extern "C" {

// out must hold max_words * k int32, pre-zeroed by the caller.
void dpv_encode_trigrams(const char* text, int64_t text_len, int32_t buckets,
                         int32_t max_words, int32_t k, int32_t* out) {
  int64_t i = 0;
  int32_t wi = 0;
  std::string buf;  // reused "#word#" buffer; grows to the longest word
  while (i < text_len && wi < max_words) {
    int cl;
    while (i < text_len &&
           is_space_cp(decode_cp(text + i, text_len - i, &cl))) {
      i += cl;
    }
    if (i >= text_len) break;
    int64_t start = i;
    while (i < text_len &&
           !is_space_cp(decode_cp(text + i, text_len - i, &cl))) {
      i += cl;
    }
    buf.assign(1, '#');
    buf.append(text + start, static_cast<size_t>(i - start));
    buf.push_back('#');
    encode_word(buf.data(), static_cast<int64_t>(buf.size()), buckets, k,
                out + wi * k);
    ++wi;
  }
}

// Batch API: texts are concatenated; lens[j] is the byte length of text j.
// out holds n * max_words * k int32, pre-zeroed.
void dpv_encode_trigrams_batch(const char* texts, const int64_t* lens,
                               int64_t n, int32_t buckets, int32_t max_words,
                               int32_t k, int32_t* out) {
  int64_t off = 0;
  const int64_t stride = static_cast<int64_t>(max_words) * k;
  for (int64_t j = 0; j < n; ++j) {
    dpv_encode_trigrams(texts + off, lens[j], buckets, max_words, k,
                        out + j * stride);
    off += lens[j];
  }
}

}  // extern "C"
