// Jsonl line-offset indexer: the startup pass of data/jsonl.py.
//
// JsonlCorpus seeks records through an int64 offset index built by scanning
// the corpus once; in the interpreter that scan is several times slower.
// This is the same scan as a single buffered pass: record the byte offset
// of every line that contains a non-whitespace byte (exactly Python's
// `if line.strip()` — ASCII whitespace), including a final line with no
// trailing newline.
//
// C ABI (ctypes): dpv_jsonl_index allocates the offsets array and returns
// the count; the caller copies into numpy and frees via dpv_free_i64.
// Returns -1 when the file cannot be opened or read.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int64_t kBuf = 1 << 20;  // 1 MiB read buffer

inline bool is_space(unsigned char c) {
  // Python bytes.strip() whitespace: space, \t, \n, \r, \v, \f.
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

struct OffsetVec {
  int64_t* data = nullptr;
  int64_t size = 0;
  int64_t cap = 0;

  bool push(int64_t v) {
    if (size == cap) {
      int64_t next = cap ? cap * 2 : 4096;
      auto* p = static_cast<int64_t*>(
          std::realloc(data, static_cast<size_t>(next) * sizeof(int64_t)));
      if (!p) return false;
      data = p;
      cap = next;
    }
    data[size++] = v;
    return true;
  }
};

}  // namespace

extern "C" {

// Scans `path`, writes a malloc'd array of line-start offsets for every
// non-blank line into *out. Returns the line count, or -1 on I/O or
// allocation failure (*out is left null).
int64_t dpv_jsonl_index(const char* path, int64_t** out) {
  *out = nullptr;
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  OffsetVec offsets;
  char* buf = static_cast<char*>(std::malloc(kBuf));
  if (!buf) {
    std::fclose(f);
    return -1;
  }

  int64_t pos = 0;          // absolute offset of buf[i]
  int64_t line_start = 0;   // absolute offset of the current line's first byte
  bool has_content = false; // current line has a non-whitespace byte
  bool ok = true;

  for (;;) {
    size_t n = std::fread(buf, 1, kBuf, f);
    if (n == 0) break;
    for (size_t i = 0; i < n; ++i) {
      unsigned char c = static_cast<unsigned char>(buf[i]);
      if (c == '\n') {
        if (has_content && !offsets.push(line_start)) { ok = false; break; }
        line_start = pos + static_cast<int64_t>(i) + 1;
        has_content = false;
      } else if (!is_space(c)) {
        has_content = true;
      }
    }
    if (!ok) break;
    pos += static_cast<int64_t>(n);
  }
  // final line without trailing newline
  if (ok && has_content) ok = offsets.push(line_start);

  bool read_error = std::ferror(f) != 0;
  std::fclose(f);
  std::free(buf);
  if (!ok || read_error) {
    std::free(offsets.data);
    return -1;
  }
  *out = offsets.data;  // may be null when the file has no non-blank lines
  return offsets.size;
}

void dpv_free_i64(int64_t* p) { std::free(p); }

}  // extern "C"
