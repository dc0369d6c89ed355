// The segment summary and the tile-visit rule shared by the bf16 kernels
// that skip tiles with segment ids (flash_fwd.cu's K1, flash_bwd.cu's K2
// and K3; sequence packing, 0 = pad).
//
// The summary of a batch row holds, for every 16 positions ("granule"),
// the smallest and largest segment id > 0 there, as an int2; a granule
// without one holds none_range(), which overlaps no range. Two ranges that
// do not overlap hold no equal id, so a pair of tiles whose ranges miss
// each other holds no allowed pair, whatever the ids' order (nothing
// assumes that pages are contiguous or ids ascending). flash_fwd.cu's
// summary kernel writes it once per forward; the backward takes the same
// summary.
#pragma once

#include <cuda_runtime.h>

namespace segskip {

constexpr int kGranule = 16;             // positions of one summary entry

// A segment range (smallest, largest id > 0); none_range() holds no id and
// overlaps no range, itself included (ids are > 0). So does (0, 0), what a
// zero-filled copy past the row reads.
__device__ __forceinline__ int2 none_range() {
  return make_int2(0x7fffffff, 0);
}

__device__ __forceinline__ bool overlap(int2 a, int2 b) {
  return a.x <= b.y && b.x <= a.y;
}

// The range of positions [p0, p0 + n) of a batch row (p0 and n multiples of
// 16) from its summary `sum` of `ng` granules.
__device__ __forceinline__ int2 span(const int2* __restrict__ sum, int ng,
                                     int p0, int n) {
  int2 r = none_range();
  const int g1 = min(ng, (p0 + n) / kGranule);
  for (int i = p0 / kGranule; i < g1; ++i) {
    const int2 x = __ldg(sum + i);
    r.x = min(r.x, x.x);
    r.y = max(r.y, x.y);
  }
  return r;
}

// The first of `ntiles` tiles of n positions after tile t whose range
// overlaps `range`, or ntiles: each lane tests one tile, 32 at a time. The
// whole warp calls it; every warp of a block gets the same answer.
__device__ __forceinline__ int next_tile(const int2* __restrict__ sum, int ng,
                                         int t, int ntiles, int n,
                                         int2 range) {
  const int lane = threadIdx.x & 31;
  for (int base = t + 1; base < ntiles; base += 32) {
    const int c = base + lane;
    const bool hit = c < ntiles && overlap(span(sum, ng, c * n, n), range);
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (m != 0u) return base + __ffs(m) - 1;
  }
  return ntiles;
}

// The summary of one batch row: sum[i] = the range of positions
// [16 i, 16 i + 16) of `srow` (L segment ids), threads tid, tid + nthr, ...
// of the calling block each writing their granules.
__device__ __forceinline__ void write_summary(const int* __restrict__ srow,
                                              int L, int2* __restrict__ sum,
                                              int tid, int nthr) {
  const int ng = (L + kGranule - 1) / kGranule;
  for (int i = tid; i < ng; i += nthr) {
    int2 r = none_range();
    const int end = min(L, (i + 1) * kGranule);
    for (int l = i * kGranule; l < end; ++l) {
      const int s = srow[l];
      if (s > 0) {
        r.x = min(r.x, s);
        r.y = max(r.y, s);
      }
    }
    sum[i] = r;
  }
}

}  // namespace segskip
