// Native path of subword ENCODING (data/subword.py). Vocab training stays
// in Python (one-off, seconds); encoding runs per page on the host, where
// the Python greedy matcher is too slow to feed the card's bulk embed.
// ctypes drops the GIL during the call, so the tokenizer worker pool
// (data/loader.py) scales it across host cores.
//
// Semantics mirror SubwordTokenizer exactly (tests assert bit-equality):
//   * text split on UNICODE whitespace (unicode_util.h, Python str.split())
//   * per word: greedy longest-match over the piece vocab, matching
//     CODEPOINT substrings longest-first (word[i:j] in Python); on no
//     match, emit unk_id and advance one codepoint
//   * stop mid-word at max_tokens, exactly like SubwordTokenizer.encode
//
// Handle-based: dpv_bpe_new builds the piece hash map once per tokenizer
// (250,112 pieces for mT5 — far too costly per batch); encode calls share
// it. The handle owns a copy of the piece blob; map keys are string_views
// into that copy.

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

#include "unicode_util.h"

namespace {

using dpv::decode_cp;
using dpv::is_space_cp;
using dpv::utf8_len;

struct BpeVocab {
  std::string blob;  // '\n'-joined pieces (pieces never contain whitespace)
  std::unordered_map<std::string_view, int32_t> pieces;
  int32_t max_piece_cps = 1;  // longest piece in codepoints, bounds the scan
};

inline int count_cps(std::string_view s) {
  int n = 0;
  size_t i = 0;
  while (i < s.size()) {
    i += static_cast<size_t>(utf8_len(static_cast<unsigned char>(s[i])));
    ++n;
  }
  return n;
}

// Greedy longest-match of word into out ids; returns tokens written
// (stops at cap). `offs` is a reusable scratch buffer.
inline int32_t encode_word(const BpeVocab& v, const char* w, int64_t wlen,
                           int32_t unk_id, int32_t cap, int32_t* out,
                           std::vector<int32_t>& offs) {
  offs.clear();
  int64_t i = 0;
  while (i < wlen) {
    offs.push_back(static_cast<int32_t>(i));
    i += utf8_len(static_cast<unsigned char>(w[i]));
  }
  offs.push_back(static_cast<int32_t>(wlen));
  const int32_t ncp = static_cast<int32_t>(offs.size()) - 1;
  int32_t pos = 0;
  int32_t ci = 0;
  while (ci < ncp && pos < cap) {
    int32_t hi = ci + v.max_piece_cps;
    if (hi > ncp) hi = ncp;
    int32_t id = unk_id;
    int32_t next = ci + 1;
    for (int32_t cj = hi; cj > ci; --cj) {
      std::string_view piece(w + offs[ci],
                             static_cast<size_t>(offs[cj] - offs[ci]));
      auto it = v.pieces.find(piece);
      if (it != v.pieces.end()) {
        id = it->second;
        next = cj;
        break;
      }
    }
    out[pos++] = id;
    ci = next;
  }
  return pos;
}

}  // namespace

extern "C" {

// pieces_blob: '\n'-joined piece strings (blob_len bytes, no trailing
// separator); ids[j] is the id of the j-th piece. Returns an opaque handle
// (never null; allocation failure aborts, as all small mallocs here would).
void* dpv_bpe_new(const char* pieces_blob, int64_t blob_len,
                  const int32_t* ids, int64_t n_pieces) {
  auto* v = new BpeVocab();
  v->blob.assign(pieces_blob, static_cast<size_t>(blob_len));
  v->pieces.reserve(static_cast<size_t>(n_pieces) * 2);
  size_t start = 0;
  int64_t j = 0;
  const std::string_view blob(v->blob);
  while (j < n_pieces && start <= blob.size()) {
    size_t end = blob.find('\n', start);
    if (end == std::string_view::npos) end = blob.size();
    std::string_view piece = blob.substr(start, end - start);
    v->pieces.emplace(piece, ids[j]);
    int cps = count_cps(piece);
    if (cps > v->max_piece_cps) v->max_piece_cps = cps;
    start = end + 1;
    ++j;
  }
  return v;
}

void dpv_bpe_free(void* h) { delete static_cast<BpeVocab*>(h); }

// texts: concatenated; lens[j] = byte length of text j. out holds
// n * max_tokens int32, pre-zeroed (0 = pad, as in subword.py).
void dpv_bpe_encode_batch(void* h, const char* texts, const int64_t* lens,
                          int64_t n, int32_t max_tokens, int32_t unk_id,
                          int32_t* out) {
  const auto& v = *static_cast<BpeVocab*>(h);
  std::vector<int32_t> offs;  // reused codepoint-offset scratch
  int64_t off = 0;
  for (int64_t t = 0; t < n; ++t) {
    const char* text = texts + off;
    const int64_t text_len = lens[t];
    int32_t* row = out + t * max_tokens;
    int32_t pos = 0;
    int64_t i = 0;
    while (i < text_len && pos < max_tokens) {
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
      pos += encode_word(v, text + start, i - start, unk_id,
                         max_tokens - pos, row + pos, offs);
    }
    off += text_len;
  }
}

// Fused jsonl-extract + encode: the bulk embed's host producer otherwise
// spends much of its time on the per-record field extract and the UTF-8
// decode/re-encode round trip between the jsonl reader and this encoder.
// This entry point takes the RAW jsonl lines and does extract + greedy
// encode in one C++ pass, so the value bytes go straight from the line
// buffer into token ids. Extraction mirrors data/jsonl.py _extract's punt
// rules EXACTLY — any backslash, a '{' past index 0 (nesting), missing or
// duplicate key, non-string value, or no closing quote sets status[t] = 0
// and the caller parses that record with json.loads and encodes it with
// the batch encoder — so the ids never depend on which route a record took.
void dpv_bpe_encode_jsonl_batch(void* h, const char* lines,
                                const int64_t* lens, int64_t n,
                                const char* key, int64_t key_len,
                                int32_t max_tokens, int32_t unk_id,
                                int32_t* out, int8_t* status) {
  const auto& v = *static_cast<BpeVocab*>(h);
  std::vector<int32_t> offs;  // reused codepoint-offset scratch
  int64_t off = 0;
  const std::string_view k(key, static_cast<size_t>(key_len));
  for (int64_t t = 0; t < n; ++t) {
    const std::string_view line(lines + off, static_cast<size_t>(lens[t]));
    off += lens[t];
    status[t] = 0;
    if (line.find('\\') != std::string_view::npos) continue;
    if (line.find('{', 1) != std::string_view::npos) continue;
    size_t j = line.find(k);
    if (j == std::string_view::npos) continue;
    if (line.find(k, j + k.size()) != std::string_view::npos) continue;
    j += k.size();
    while (j < line.size() && (line[j] == ' ' || line[j] == '\t')) ++j;
    if (j >= line.size() || line[j] != '"') continue;
    ++j;
    const size_t e = line.find('"', j);
    if (e == std::string_view::npos) continue;
    status[t] = 1;
    const char* text = line.data() + j;
    const int64_t text_len = static_cast<int64_t>(e - j);
    int32_t* row = out + t * max_tokens;
    int32_t pos = 0;
    int64_t i = 0;
    while (i < text_len && pos < max_tokens) {
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
      pos += encode_word(v, text + start, i - start, unk_id,
                         max_tokens - pos, row + pos, offs);
    }
  }
}

}  // extern "C"
