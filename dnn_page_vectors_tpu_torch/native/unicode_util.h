// Shared UTF-8 / whitespace helpers for the native host-side tokenizers.
// Semantics match Python: decode_cp mirrors str iteration over codepoints
// (invalid sequences decode as the single lead byte), is_space_cp is the
// exact str.split() whitespace set, so the C++ and the Python encoders
// tokenize multilingual text identically.
#ifndef DPV_NATIVE_UNICODE_UTIL_H_
#define DPV_NATIVE_UNICODE_UTIL_H_

#include <cstdint>

namespace dpv {

// Number of bytes in the UTF-8 sequence starting at lead byte `c`.
inline int utf8_len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c >> 5) == 0x6) return 2;
  if ((c >> 4) == 0xE) return 3;
  if ((c >> 3) == 0x1E) return 4;
  return 1;  // invalid lead byte: treat as one unit (matches Python repair)
}

// Decode the codepoint at s (n bytes left); *len gets bytes consumed.
// Invalid sequences decode as the single lead byte (inputs come from
// Python str.encode("utf-8") and are always valid in practice).
inline uint32_t decode_cp(const char* s, int64_t n, int* len) {
  unsigned char c = static_cast<unsigned char>(s[0]);
  int l = utf8_len(c);
  if (l == 1 || l > n) { *len = 1; return c; }
  uint32_t cp = c & (0xFF >> (l + 1));
  for (int i = 1; i < l; ++i) {
    unsigned char cc = static_cast<unsigned char>(s[i]);
    if ((cc >> 6) != 0x2) { *len = 1; return c; }
    cp = (cp << 6) | (cc & 0x3F);
  }
  *len = l;
  return cp;
}

// Python str.split() whitespace = Unicode WSpace (str.isspace()).
inline bool is_space_cp(uint32_t cp) {
  switch (cp) {
    case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D: case 0x20:
    case 0x1C: case 0x1D: case 0x1E: case 0x1F:
    case 0x85: case 0xA0: case 0x1680:
    case 0x2000: case 0x2001: case 0x2002: case 0x2003: case 0x2004:
    case 0x2005: case 0x2006: case 0x2007: case 0x2008: case 0x2009:
    case 0x200A: case 0x2028: case 0x2029: case 0x202F: case 0x205F:
    case 0x3000:
      return true;
    default:
      return false;
  }
}

}  // namespace dpv

#endif  // DPV_NATIVE_UNICODE_UTIL_H_
