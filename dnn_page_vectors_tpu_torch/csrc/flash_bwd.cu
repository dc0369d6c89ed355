// Flash-attention backward (kernels K2, K3 and K4 of the port) for
// Hopper, sm_90a.
//
// Replace the Pallas TPU kernels `_flash_dq_kernel` (K2),
// `_flash_dkv_kernel` (K3) and `_flash_dq_dbias_kernel` (K4) of
// dnn_page_vectors_tpu/ops/flash_attention.py (launched by
// `_flash_backward`). With the row terms
//   p[l,s]  = exp(scale * q[l].k[s] + bias[h,l,s] - lse[l])
//                                    (0 for a masked key, a key past S or,
//                                     with segment ids, a key of another
//                                     segment; no bias term without a bias)
//   dp[l,s] = g[l] . v[s]
//   delta[l] = sum_d g[l,d] * out[l,d]
//   ds[l,s] = p[l,s] * (dp[l,s] - delta[l])
// they compute, per (batch row, head),
//   K2: dq[l] = scale * sum_s ds[l,s] k[s]           (and writes delta)
//   K4: K2's dq and delta with the bias, and dbias[h,l,s] = sum_b ds[b,h,l,s]
//   K3: dk[s] = scale * sum_l ds[l,s] q[l],  dv[s] = sum_l p[l,s] g[l]
//       (with the bias when the forward had one)
// q [B,H,L,Dh], k/v [B,H,S,Dh] in bf16 or f32, g [B,H,L,Dh] f32, all with
// any strides over (batch, head, row) and unit stride on Dh; out [B,H,L,Dh]
// f32 and lse [B,H,L] f32 from K1 (contiguous); kv_mask [B,S] uint8;
// bias [H,L,S] f32 (contiguous), as K1 adds it (flash_fwd.cu); segment ids
// seg [B,L] int32 (contiguous, L == S; 0 = pad), as K1 takes them: a pair
// (l, s) counts only when kv_mask[s] holds and seg[l] == seg[s] > 0 (the
// Pallas kernels' `_tile_mask`), tested per tile, so no [B,L,S] mask exists.
// dq, dk, dv are written in the inputs' dtype with their own strides (the
// wrapper allocates them like q, k, v, so the towers' transposed views
// need no copy on the way back); dbias [H,L,S] f32.
//
// A fully masked query row (no allowed key) returned mean(V) in the
// forward: every score is -1e30, so the softmax is uniform over the S
// keys. Its lse is -1e30 + log(S), which rounds to -1e30 in f32. The
// gradient of that forward is p = 1/S for every key (dv gets g/S) and
// ds = 0 (the masked scores depend on neither q, k nor the bias). The
// rows are recognised by lse <= -1e29. (The TPU kernels rebuild p =
// exp(0) = 1 there, an S-times too large dv, and leave that row's ds
// unmasked, which also reaches dbias.)
//
// Design. None of the kernels carries the TPU blocking over (a Q block
// against the whole KV slice in VMEM). K2 is gridded over (Q tile, head,
// batch row) with a loop over KV tiles; K3 over (KV tile, head, batch row)
// with a loop over Q tiles, in order.
// The TPU's K4 sums dbias over the batch by running the batch innermost in
// a grid that executes in order; GPU blocks have no order. K4 is gridded
// over (Q tile, head, group of G batch rows): each block runs K2's work
// for its G rows in order and adds each row's ds tile into a partial
// dbias [L,S] of its own (part[group, h]), and a second launch sums the
// partials over the groups in order. Each output element has exactly one
// writer and each sum runs in a fixed order: no atomics, no [B,H,L,S]
// array, and the results are bitwise equal from run to run.
// K2 and K4 also compute delta for their rows (from out and g, once per
// row) and write it out for K3, which runs after them on the same stream:
// there is no separate preprocess kernel.
//
// Each kernel has two versions, chosen by the dtype of q, k and v: bf16
// (every launch of the training paths) on the tensor cores, f32 (whose
// 1e-4 / 1e-5 gradient tolerances bf16 operands cannot meet) on the CUDA
// cores.
//
// Segment ids (sequence packing, train.pack_pages). The tensor-core kernels
// take them as a template flag, so the unsegmented instantiations keep
// their code and registers: K2 and K4 stage each KV tile's key segments by
// cp.async beside its mask bytes and read each query row's segment once;
// K3 stages each Q tile's row segments beside its lse and delta and reads
// each key's segment once. Each folds the segment into the value it already
// tested (a dead row's segment, or a masked key's, is -1), so the test stays
// one compare. The f32 kernels test the segments at run time. A pad row of a
// packed row (seg 0) sees no key: it is a fully masked row (below).
//
// A packed row of 1,024 tokens holding 4 pages allows about a fifth of its
// pairs, so the bf16 K2, K3 and K4 with segment ids visit only the tiles
// that share a segment, by the segment summary (seg_skip.cuh: for every 16
// positions of every batch row the range of segment ids > 0 there), which
// the forward's summary kernel (flash_fwd.cu) wrote once for K1 and the
// backward takes over. K2 (a Q tile of up to 64 rows) and K4 (32 rows, for
// each batch row of its group) walk only the KV tiles whose range overlaps
// the rows' range, and K3 (a block of 64 keys) only the Q tiles that
// overlap its keys' range; the two-stage ring fetches the next tile
// visited, found by one warp-wide ballot over the summary, so a skipped
// tile costs no load (K4's ring runs on across its batch rows: the last
// tile of a row fetches the next row's first visited one). Inside a
// visited tile each warp skips the 16 x 16 chunks whose two granules miss
// each other (a branch that is uniform over the warp). Skipped pairs had
// p = ds = 0: dq is what visiting every tile gave, up to the sign of a
// zero, and K4's partial dbias, which starts at +0 and never becomes -0,
// is bitwise what it was. A dead row (no allowed key) gives dv its g / S
// at every key, which would send K3 to every Q tile that holds a pad row;
// a small kernel (flash_bwd_gdead_kernel) therefore sums g over the dead
// rows of each (batch row, head) first, gdead [B, H, Dh] f32 (one block
// per pair, in row order, no atomics), and K3 takes p = 0 at dead rows in
// its tiles and adds gdead / S to the f32 dv of each of its keys below S
// before the bf16 store. (A dead row adds nothing to dq or dbias.) The
// f32 kernels, and a bf16 K4 over more than 512 keys (on f32 copies),
// still visit every tile.
//
// K2, K4, and K3 for f32 inputs, stage their tiles in shared memory
// widened to f32 and multiply on the CUDA cores. As in K1's f32 kernel,
// four threads share one row (a query row in K2/K4, a key in K3): each
// scores 16 of the tile's 64 partners and owns a quarter of the Dh output
// columns; the p and ds values reach the owners of the columns by warp
// shuffle. The bias and the partial dbias are read and written in global
// memory (L2-resident: [H,L,S] f32 is 0.8 MB at mT5's training shape, a
// block's partial 32 KB).
//
// K2 and K4 for bf16 inputs (flash_bwd_dq_tc_kernel and
// flash_bwd_dq_dbias_tc_kernel, one body) run on the tensor cores
// (mma.sync m16n8k16, f32 sums), a FlashAttention-2 dq loop:
// - each warp owns 16 query rows; a K2 block has 1, 2 or 4 warps, chosen
//   from L so that the query tower's L=16 runs one warp per block. The Q
//   tile (q in bf16; g, out in f32; lse) comes in by 16-byte cp.async;
//   then, once per element, g becomes a hi + lo pair of bf16 A fragments
//   held in registers and delta = g.out is summed in f32 from the same
//   elements (written for K3); q is read by ldmatrix at each use;
// - k, v (bf16) and the kv mask bytes come through a two-stage cp.async
//   ring of 16- or 32-key tiles, each tile fetched while the previous one
//   is computed; per 16
//   keys: s = q.k^T and dp = (g_hi + g_lo).v^T from ldmatrix fragments,
//   p = exp(scale s + bias - lse) and ds = p (dp - delta) in registers (the
//   mask, keys past S and rows past L tested in one place), then dq +=
//   ds.k with ds as a hi + lo pair (ldmatrix.trans of the k tile); with g
//   or ds rounded once, dq leaves the 2e-2 tolerance where attention is
//   peaked (tests/test_torch_flash_rounding.py);
// - scale * dq goes out in bf16 through shared memory as 16-byte stores;
// - K2 holds 54 KB of shared memory a block at a head dim of 64 (the ring's
//   second slot lies over the f32 g and out, free once the fragments are
//   built) and at most 128 registers a thread: 4 blocks of 4 warps an SM;
// - K4 keeps its block's bias tile [Q tile, S] f32 in shared memory, loaded
//   once for every batch row of the group, and its partial dbias there too:
//   each thread adds its own ds elements (f32), the same elements in batch-
//   row order, and the partial goes out once, when the group is done. The
//   bias and the partial take Q tiles of at most 32 rows; two warps share
//   each 16 rows, each taking half of every 32-key tile, and the second's
//   dq is added to the first's (in that order) at the row's end: 3 blocks
//   of 4 warps an SM at mT5's shape (74 KB, at most 168 registers). While
//   one batch row is computed, the next row's g, out, lse and first KV
//   tiles are fetched (its q once the row is done). S is at most 512 (the
//   wrapper sends a longer S to the f32 K4). K4 is bound by latency more
//   than by bytes: it sums its batch rows one after another. With segment
//   ids the tiles a row visits follow from that row's summary: the last
//   pass of a row finds the next row's first tile (so that the ring
//   fetches it), and the row's end writes the next row's ranges over its
//   own once every warp is done with them, all in shared memory. A row
//   whose Q tile visits nothing (a pad tail) still takes one pass: delta,
//   dq = 0, and the next row's fetches.
//
// K3 for bf16 inputs (flash_bwd_dkv_tc_kernel: every K3 launch of the
// training paths) runs on the tensor cores (mma.sync m16n8k16, f32 sums):
// - each warp owns 16 keys; a block has 1, 2 or 4 warps, chosen from S so
//   that the query tower's S=16 runs one warp per block. The block's K and
//   V rows are loaded once (bf16, 16-byte cp.async) and held as A
//   fragments (re-read from shared memory at a head dim above 64);
// - the loop runs over Q tiles (up to 64 rows; 32 with the bias, which
//   halves the shared memory a block takes) through a two-stage ring:
//   each tile brings q, g (f32), lse, delta and the bias tile by cp.async
//   while the previous tile is computed, and g is split into bf16 hi and
//   lo halves once per element as it is staged (no pass over it in device
//   memory);
// - per 16 query rows: s^T = k.q^T, p^T = exp(scale s^T + bias - lse)
//   (1/S at a fully masked row), dp^T = v.g^T, ds^T = p^T (dp^T - delta),
//   then dv += p^T.g and dk += ds^T.q, in registers, keys past S and rows
//   past L masked here;
// - g, p and ds enter their products as hi + lo pairs of bf16 (two
//   products each), which carry about 16 bits: dp - delta cancels where p
//   is peaked, and with g rounded once the gradient of a one-key row is
//   off by 4e-2 (tests/test_torch_flash_rounding.py); with p rounded once,
//   dv left the 2e-2 tolerance at BERT-mini's training shape (chip_smoke's
//   k23_check);
// - dk and dv go out through the warp's own k and v rows in shared memory
//   as 16-byte stores. One writer per element, a fixed order over the Q
//   tiles, no atomics: runs are bitwise equal.
//
// Bounds on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores):
// - BERT-mini page tower, training (B=8192, H=4, L=S=64, Dh=64, bf16
//   q/k/v, f32 g): K2 must move q, k, v (805 MB bf16), g and out (1.07 GB
//   f32) and write dq (268 MB) and delta: about 2.15 GB, 0.64 ms, against
//   52 GFLOP (s, dp, dq), 0.05 ms. K3 must move q, k, v (805 MB), g (537
//   MB), lse and delta, and write dk, dv (537 MB): about 1.90 GB, 0.57 ms,
//   against 69 GFLOP (s, dp, dk, dv), 0.07 ms; the hi + lo pairs double
//   the products, still under the bytes.
// - mT5 page tower, training (B=512, H=12, L=S=128, Dh=64): K4 moves q, k,
//   v (302 MB), g and out (403 MB), dq (101 MB), lse, delta, the bias and
//   dbias: about 0.81 GB, 0.24 ms, against 39 GFLOP, 0.04 ms. The biased K3
//   moves about 0.71 GB, 0.21 ms.
// All are memory-bound. The query tower's launches (L=S=16) move about a
// quarter of the page tower's bytes: K2 about 0.54 GB (0.16 ms), K4 about
// 0.09 GB (0.03 ms).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm80.cuh"
#include "per_device.cuh"
#include "seg_skip.cuh"

namespace {

using namespace segskip;

constexpr int kBQ = 64;                  // query rows per tile
constexpr int kBK = 64;                  // keys per tile
constexpr int kTPR = 4;                  // threads per row (query or key)
constexpr int kThreads = kBQ * kTPR;     // 256; also kBK * kTPR
constexpr int kCols = kBK / kTPR;        // partners scored per thread
constexpr int kDhMax = 128;
constexpr int kChunks = kDhMax / 4 / kTPR;  // float4 output chunks per thread
constexpr float kMaskedRowLse = -1e29f;  // lse of a fully masked row

// Row pitch of a staged tile: 16-byte aligned rows.
__host__ __device__ __forceinline__ int pitch(int Dh) { return Dh + 4; }

// Stages rows [r0, r0 + 64) of a strided [rows, Dh] f32 matrix (row
// stride `sl`) into `dst`, multiplied by `mul`; rows past `n` are zero.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long sl, int r0, int n, int Dh,
                                      float mul) {
  const int ld = pitch(Dh);
  for (int i = threadIdx.x; i < 64 * Dh; i += kThreads) {
    const int rr = i / Dh, d = i % Dh;
    const int gr = r0 + rr;
    dst[rr * ld + d] = gr < n ? src[gr * sl + d] * mul : 0.f;
  }
}

// acc[4i..4i+3] += sum over the 64 tile partners c of w(c) * rows[c, chunk
// sub + kTPR*i], where w(c) is held by thread (row_lane0 | c % kTPR) in
// its slot w[c / kTPR].
__device__ __forceinline__ void accumulate(float* acc, const float* w,
                                           const float* rows, int ld,
                                           int sub, int row_lane0,
                                           int nchunk) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
#pragma unroll
    for (int src = 0; src < kTPR; ++src) {
      const float x = __shfl_sync(0xffffffffu, w[j], row_lane0 | src);
      const float* row = rows + (src + kTPR * j) * ld;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int ch = sub + kTPR * i;
        if (ch < nchunk) {
          const float4 r = *reinterpret_cast<const float4*>(row + 4 * ch);
          acc[4 * i + 0] = fmaf(x, r.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(x, r.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(x, r.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(x, r.w, acc[4 * i + 3]);
        }
      }
    }
  }
}

// a[j] = mine . pa[c_j],  b[j] = mine2 . pb[c_j] for c_j = sub + kTPR*j:
// the two dot products of one row against this thread's 16 partners.
__device__ __forceinline__ void dots(float* a, float* b, const float* mine,
                                     const float* pa, const float* mine2,
                                     const float* pb, int ld, int sub,
                                     int Dh) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) a[j] = b[j] = 0.f;
  for (int d = 0; d < Dh; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(mine + d);
    const float4 y = *reinterpret_cast<const float4*>(mine2 + d);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + kTPR * j;
      const float4 u = *reinterpret_cast<const float4*>(pa + c * ld + d);
      const float4 w = *reinterpret_cast<const float4*>(pb + c * ld + d);
      a[j] = fmaf(x.x, u.x, a[j]);
      a[j] = fmaf(x.y, u.y, a[j]);
      a[j] = fmaf(x.z, u.z, a[j]);
      a[j] = fmaf(x.w, u.w, a[j]);
      b[j] = fmaf(y.x, w.x, b[j]);
      b[j] = fmaf(y.y, w.y, b[j]);
      b[j] = fmaf(y.z, w.z, b[j]);
      b[j] = fmaf(y.w, w.w, b[j]);
    }
  }
}

struct Strides {
  long long q[3], k[3], v[3], g[3], dq[3], dk[3], dv[3];  // (b, h, row)
};

// The f32 K2's work for rows [q0, q0 + 64) of batch row b, head h: dq,
// and delta for K3. K2 runs it once per block, K4 once per batch row of its
// group.
// With `bias` the scores are rebuilt with it; with `seg` a pair counts only
// within one segment, as in K1; with `part` (K4) the tile's
// ds is added into this group's partial dbias [L,S] of head h (stored,
// not added, when `first`). Each (row, key) of `part` belongs to one
// thread, the same one in every call.
__device__ __forceinline__ void dq_tile(
    float* smem, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    const int* __restrict__ seg, const float* __restrict__ bias,
    const float* __restrict__ g, const float* __restrict__ out,
    const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ dq, float* __restrict__ part,
    bool first, int b, int h, int q0, int H, int L, int S, int Dh,
    float scale, const Strides& st) {
  const int ld = pitch(Dh);
  float* qs = smem;                      // [kBQ][ld] scale * q
  float* gs = qs + kBQ * ld;             // [kBQ][ld] g
  float* ks = gs + kBQ * ld;             // [kBK][ld] k (out, first)
  float* vs = ks + kBK * ld;             // [kBK][ld] v
  int* key_ok = reinterpret_cast<int*>(vs + kBK * ld);  // [kBK]
  int* key_seg = key_ok + kBK;                          // [kBK]

  const int tid = threadIdx.x;
  const int r = tid / kTPR, sub = tid % kTPR;
  const int row_lane0 = (tid & 31) & ~(kTPR - 1);
  const int row = q0 + r;
  const bool row_ok = row < L;
  // this row's segment; without seg every row and key is in segment 1. A
  // live row's segment is > 0 (a pad row, seg 0, has no allowed key, so its
  // lse marks it fully masked), so the equality below also drops pad keys
  const int row_seg =
      seg == nullptr ? 1 : (row_ok ? seg[(long long)b * L + row] : 0);
  const int nchunk = Dh / 4;
  const long long bh = (long long)b * H + h;

  __syncthreads();                       // a previous call's tiles consumed
  stage(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, L, Dh, scale);
  stage(gs, g + b * st.g[0] + h * st.g[1], st.g[2], q0, L, Dh, 1.f);
  stage(ks, out + bh * L * Dh, (long long)Dh, q0, L, Dh, 1.f);
  __syncthreads();

  // delta of this row: each of its four threads sums a quarter of Dh
  float part_sum = 0.f;
  for (int ch = sub; ch < nchunk; ch += kTPR) {
    const float4 x = *reinterpret_cast<const float4*>(gs + r * ld + 4 * ch);
    const float4 y = *reinterpret_cast<const float4*>(ks + r * ld + 4 * ch);
    part_sum = fmaf(x.x, y.x, part_sum);
    part_sum = fmaf(x.y, y.y, part_sum);
    part_sum = fmaf(x.z, y.z, part_sum);
    part_sum = fmaf(x.w, y.w, part_sum);
  }
  part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 1);
  part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 2);
  const float row_delta = part_sum;
  const float row_lse = row_ok ? lse[bh * L + row] : 0.f;
  // a row past L or a fully masked row adds nothing to dq or dbias
  const bool live = row_ok && row_lse > kMaskedRowLse;
  if (row_ok && sub == 0) delta[bh * L + row] = row_delta;

  float acc[kChunks * 4];
#pragma unroll
  for (int i = 0; i < kChunks * 4; ++i) acc[i] = 0.f;

  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const float* bias_row =
      (bias != nullptr && row_ok) ? bias + ((long long)h * L + row) * S
                                  : nullptr;
  float* part_row = (part != nullptr && row_ok) ? part + (long long)row * S
                                                : nullptr;
  for (int kv0 = 0; kv0 < S; kv0 += kBK) {
    __syncthreads();                     // previous tile (or out) consumed
    stage(ks, kb, st.k[2], kv0, S, Dh, 1.f);
    stage(vs, vb, st.v[2], kv0, S, Dh, 1.f);
    for (int i = tid; i < kBK; i += kThreads) {
      const int gs_ = kv0 + i;
      key_ok[i] = gs_ < S && kv_mask[(long long)b * S + gs_] ? 1 : 0;
      key_seg[i] =
          seg == nullptr ? 1 : (gs_ < S ? seg[(long long)b * S + gs_] : 0);
    }
    __syncthreads();

    float s[kCols], ds[kCols];
    dots(s, ds, qs + r * ld, ks, gs + r * ld, vs, ld, sub, Dh);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = kv0 + sub + kTPR * j;
      const bool ok = live && key_ok[sub + kTPR * j] &&
                      key_seg[sub + kTPR * j] == row_seg;
      const float x = (bias_row != nullptr && ok) ? s[j] + bias_row[c] : s[j];
      const float p = ok ? expf(x - row_lse) : 0.f;
      ds[j] = ok ? p * (ds[j] - row_delta) : 0.f;
    }
    if (part_row != nullptr) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = kv0 + sub + kTPR * j;
        if (c < S) part_row[c] = first ? ds[j] : part_row[c] + ds[j];
      }
    }
    accumulate(acc, ds, ks, ld, sub, row_lane0, nchunk);
  }

  if (row_ok) {
    float* drow = dq + b * st.dq[0] + h * st.dq[1] + row * st.dq[2];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int ch = sub + kTPR * i;
      if (ch < nchunk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) drow[4 * ch + e] = acc[4 * i + e] * scale;
      }
    }
  }
}

// K2 for f32 inputs: one block per (Q tile, head, batch row).
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ kv_mask,
                    const int* __restrict__ seg,
                    const float* __restrict__ g, const float* __restrict__ out,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int H, int L, int S, int Dh,
                    float scale, Strides st) {
  extern __shared__ float4 smem4[];
  dq_tile(reinterpret_cast<float*>(smem4), q, k, v, kv_mask, seg, nullptr, g,
             out, lse, delta, dq, nullptr, false, blockIdx.z, blockIdx.y,
             blockIdx.x * kBQ, H, L, S, Dh, scale, st);
}

// K4 for f32 inputs, first launch: one block per (Q tile, head, group of
// `group` batch rows), K2's work for each row of the group in order, its ds
// summed into part[group index, h] ([groups, H, L, S] f32).
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_dbias_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const uint8_t* __restrict__ kv_mask,
                          const int* __restrict__ seg,
                          const float* __restrict__ bias,
                          const float* __restrict__ g,
                          const float* __restrict__ out,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, float* __restrict__ dq,
                          float* __restrict__ part, int B, int H, int L,
                          int S, int Dh, float scale, int group,
                          Strides st) {
  extern __shared__ float4 smem4[];
  const int h = blockIdx.y;
  const int b0 = blockIdx.z * group;
  const int b1 = min(B, b0 + group);
  float* my_part = part + ((long long)blockIdx.z * H + h) * L * S;
  for (int b = b0; b < b1; ++b)
    dq_tile(reinterpret_cast<float*>(smem4), q, k, v, kv_mask, seg, bias, g,
               out, lse, delta, dq, my_part, b == b0, b, h, blockIdx.x * kBQ,
               H, L, S, Dh, scale, st);
}

// K4, second launch: dbias[i] = sum over the groups, in order, of
// part[group][i], for the n = H*L*S elements.
__global__ void __launch_bounds__(256)
flash_bwd_dbias_sum_kernel(const float* __restrict__ part,
                           float* __restrict__ dbias, int groups,
                           long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int gr = 0; gr < groups; ++gr) acc += part[gr * n + i];
  dbias[i] = acc;
}

// K3 for f32 inputs: one block per (KV tile, head, batch row). kBias is a
// template parameter, not a run-time test: this K3 holds two accumulators
// at the edge of the register file, and the unbiased path keeps its code
// without the bias. `seg` (null without it) is a run-time test on one
// register and a shared row of the Q tile's segments.
template <bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ kv_mask,
                     const int* __restrict__ seg,
                     const float* __restrict__ bias,
                     const float* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int L, int S, int Dh,
                     float scale, Strides st) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = pitch(Dh);
  float* ks = smem;                      // [kBK][ld] scale * k
  float* vs = ks + kBK * ld;             // [kBK][ld] v
  float* qs = vs + kBK * ld;             // [kBQ][ld] q
  float* gs = qs + kBQ * ld;             // [kBQ][ld] g
  float* row_lse = gs + kBQ * ld;        // [kBQ]
  float* row_delta = row_lse + kBQ;      // [kBQ]
  // [kBQ]: -1 past L, 0 fully masked (p = 1/S, ds = 0), 1 a live row
  int* row_state = reinterpret_cast<int*>(row_delta + kBQ);
  int* row_seg = row_state + kBQ;        // [kBQ]; 1 for every row without seg

  const int b = blockIdx.z, h = blockIdx.y;
  const int c0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const int r = tid / kTPR, sub = tid % kTPR;
  const int row_lane0 = (tid & 31) & ~(kTPR - 1);
  const int key = c0 + r;
  const bool key_in = key < S;
  const bool key_ok = key_in && kv_mask[(long long)b * S + key] != 0;
  // a live row's segment is > 0, so a pad key (seg 0) matches none
  const int key_seg =
      seg == nullptr ? 1 : (key_in ? seg[(long long)b * S + key] : 0);
  const int nchunk = Dh / 4;
  const long long bh = (long long)b * H + h;
  const float inv_s = 1.f / (float)S;

  stage(ks, k + b * st.k[0] + h * st.k[1], st.k[2], c0, S, Dh, scale);
  stage(vs, v + b * st.v[0] + h * st.v[1], st.v[2], c0, S, Dh, 1.f);

  float acc_k[kChunks * 4], acc_v[kChunks * 4];
#pragma unroll
  for (int i = 0; i < kChunks * 4; ++i) acc_k[i] = acc_v[i] = 0.f;

  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* gb = g + b * st.g[0] + h * st.g[1];
  for (int q0 = 0; q0 < L; q0 += kBQ) {
    __syncthreads();                     // previous Q tile consumed
    stage(qs, qb, st.q[2], q0, L, Dh, 1.f);
    stage(gs, gb, st.g[2], q0, L, Dh, 1.f);
    for (int i = tid; i < kBQ; i += kThreads) {
      const int gr = q0 + i;
      if (gr < L) {
        const float x = lse[bh * L + gr];
        row_lse[i] = x;
        row_delta[i] = delta[bh * L + gr];
        row_state[i] = x > kMaskedRowLse ? 1 : 0;
        row_seg[i] = seg == nullptr ? 1 : seg[(long long)b * L + gr];
      } else {
        row_lse[i] = row_delta[i] = 0.f;
        row_state[i] = -1;
        row_seg[i] = 0;
      }
    }
    __syncthreads();

    float p[kCols], ds[kCols];
    dots(p, ds, ks + r * ld, qs, vs + r * ld, gs, ld, sub, Dh);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int i = sub + kTPR * j;
      const int state = key_in ? row_state[i] : -1;
      float pj = 0.f, dsj = 0.f;
      if (state > 0 && key_ok && row_seg[i] == key_seg) {
        float x = p[j];
        if (kBias) x += bias[((long long)h * L + q0 + i) * S + key];
        pj = expf(x - row_lse[i]);
        dsj = pj * (ds[j] - row_delta[i]);
      } else if (state == 0) {
        pj = inv_s;                      // uniform softmax, no score grad
      }
      p[j] = pj;
      ds[j] = dsj;
    }
    accumulate(acc_v, p, gs, ld, sub, row_lane0, nchunk);
    accumulate(acc_k, ds, qs, ld, sub, row_lane0, nchunk);
  }

  if (key_in) {
    float* krow = dk + b * st.dk[0] + h * st.dk[1] + key * st.dk[2];
    float* vrow = dv + b * st.dv[0] + h * st.dv[1] + key * st.dv[2];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int ch = sub + kTPR * i;
      if (ch < nchunk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          krow[4 * ch + e] = acc_k[4 * i + e] * scale;
          vrow[4 * ch + e] = acc_v[4 * i + e];
        }
      }
    }
  }
}

size_t smem_bytes(int Dh, int extra_floats) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * 2 * pitch(Dh) + extra_floats);
}

Strides unpack(const long long* s) {
  Strides st;
  long long* dst[7] = {st.q, st.k, st.v, st.g, st.dq, st.dk, st.dv};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = s[3 * t + i];
  return st;
}

// 0, or the error of a shape the kernels do not take; segment ids need
// L == S.
int check_shape(int B, int H, int L, int S, int Dh,
                const void* seg = nullptr) {
  if (Dh <= 0 || Dh > kDhMax || Dh % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || L <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (seg != nullptr && L != S) return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

// Extra shared floats of the f32 kernels beside their four tiles: K2 and
// K4 hold the KV tile's key states and segments, K3 the Q tile's lse,
// delta, row states and segments.
constexpr int kDqExtra = 2 * kBK;
constexpr int kDkvExtra = 4 * kBQ;

// The f32 kernels' dynamic shared memory is granted once per kernel and
// device, at the largest head dim; a launch asks for what its head dim
// needs.
template <typename Kernel>
cudaError_t allow_f32_smem(per_device::PerDevice& grants, Kernel kernel,
                           int extra_floats) {
  return grants.get([&] {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_bytes(kDhMax, extra_floats));
  });
}

cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* kv_mask, const void* seg, const void* g,
                          const void* out, const void* lse, void* delta,
                          void* dq, int B, int H, int L, int S, int Dh,
                          float scale, const Strides& st,
                          cudaStream_t stream) {
  static per_device::PerDevice grants;
  const cudaError_t allowed =
      allow_f32_smem(grants, flash_bwd_dq_kernel, kDqExtra);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<<<grid, kThreads, smem_bytes(Dh, kDqExtra), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(seg),
      static_cast<const float*>(g), static_cast<const float*>(out),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(dq), H, L, S, Dh, scale, st);
  return cudaGetLastError();
}

// K4's second launch, after either first launch: dbias from the groups'
// partials, summed in order.
cudaError_t sum_partials(const void* part, void* dbias, int groups, int H,
                         int L, int S, cudaStream_t stream) {
  const long long n = (long long)H * L * S;
  flash_bwd_dbias_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                               stream>>>(static_cast<const float*>(part),
                                         static_cast<float*>(dbias), groups,
                                         n);
  return cudaGetLastError();
}

cudaError_t launch_dq_dbias_f32(const void* q, const void* k, const void* v,
                                const void* kv_mask, const void* bias,
                                const void* seg, const void* g,
                                const void* out, const void* lse, void* delta,
                                void* dq, void* part, void* dbias, int B,
                                int H, int L, int S, int Dh, float scale,
                                int group, const Strides& st,
                                cudaStream_t stream) {
  static per_device::PerDevice grants;
  const cudaError_t allowed =
      allow_f32_smem(grants, flash_bwd_dq_dbias_kernel, kDqExtra);
  if (allowed != cudaSuccess) return allowed;
  const int groups = (B + group - 1) / group;
  const dim3 grid((L + kBQ - 1) / kBQ, H, groups);
  flash_bwd_dq_dbias_kernel<<<grid, kThreads, smem_bytes(Dh, kDqExtra),
                              stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(seg),
      static_cast<const float*>(bias), static_cast<const float*>(g),
      static_cast<const float*>(out), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq),
      static_cast<float*>(part), B, H, L, S, Dh, scale, group, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, dbias, groups, H, L, S, stream);
}

cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* kv_mask, const void* bias,
                           const void* seg, const void* g, const void* lse,
                           const void* delta, void* dk, void* dv, int B,
                           int H, int L, int S, int Dh, float scale,
                           const Strides& st, cudaStream_t stream) {
  static per_device::PerDevice grants[2];
  const bool biased = bias != nullptr;
  auto kernel = biased ? flash_bwd_dkv_kernel<true>
                       : flash_bwd_dkv_kernel<false>;
  const cudaError_t allowed =
      allow_f32_smem(grants[biased], kernel, kDkvExtra);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((S + kBK - 1) / kBK, H, B);
  kernel<<<grid, kThreads, smem_bytes(Dh, kDkvExtra), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const int*>(seg),
      static_cast<const float*>(bias), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, L, S, Dh, scale,
      st);
  return cudaGetLastError();
}

// ---- The dead rows' sum (bf16 K3 with seg) --------------------------------

constexpr int kSumThreads = 128;

// One block per (head, batch row): gdead[b, h] = the sum over the dead rows
// (lse <= kMaskedRowLse) of g[b, h, row], in f32 and in row order (thread d
// owns column d).
__global__ void __launch_bounds__(kSumThreads)
flash_bwd_gdead_kernel(const float* __restrict__ lse,
                       const float* __restrict__ g,
                       float* __restrict__ gdead, int H, int L, int Dh,
                       long long gs_b, long long gs_h, long long gs_l) {
  __shared__ int dead[kSumThreads];      // a chunk's dead rows, in order
  __shared__ int warp_dead[kSumThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long bh = (long long)b * H + h;
  const float* gb = g + b * gs_b + h * gs_h;
  float acc = 0.f;
  for (int r0 = 0; r0 < L; r0 += kSumThreads) {
    const int l = r0 + tid;
    const bool is_dead = l < L && lse[bh * L + l] <= kMaskedRowLse;
    const unsigned m = __ballot_sync(0xffffffffu, is_dead);
    if (lane == 0) warp_dead[warp] = __popc(m);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kSumThreads / 32; ++w) {
      before += w < warp ? warp_dead[w] : 0;
      n += warp_dead[w];
    }
    if (is_dead) dead[before + __popc(m & ((1u << lane) - 1u))] = l;
    __syncthreads();
    if (tid < Dh) {
#pragma unroll 8
      for (int j = 0; j < n; ++j) acc += gb[dead[j] * gs_l + tid];
    }
    __syncthreads();                     // dead and warp_dead read
  }
  if (tid < Dh) gdead[bh * Dh + tid] = acc;
}

// ---- K3 on the tensor cores (bf16 q/k/v) -----------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kMaxKeys = 64;             // keys per block (4 warps)
constexpr int kMaxRows = 64;             // query rows per Q tile
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* kv_mask;
  const float* bias;
  const int* seg;                        // [B, L] segment ids, or null
  const float* g;
  const float* lse;
  const float* delta;
  bf16* dk;
  bf16* dv;
  int H, L, S, Dh;
  int keys;                              // keys per block: 16, 32, 48, 64
  int bm;                                // query rows per Q tile: 16..64
  int stages;                            // Q tiles in the ring: 1 or 2
  float scale;
  Strides st;
  // with seg (last, so the other instantiations' parameters keep their
  // places): the segment summary and the dead rows' g sum
  const int2* sum;
  const float* gdead;
};

// Byte offsets of the shared-memory buffers (all 16-byte aligned).
struct Layout {
  int k, v, q, g32, g, g_lo, bias, lse, delta, seg, total;
};

__host__ __device__ __forceinline__ Layout layout(int dp, int keys, int bm,
                                                  int stages, bool bias,
                                                  bool seg) {
  const int row_bytes = (dp + 8) * 2;    // bf16 row padded by 16 bytes
  Layout s;
  s.k = 0;                                         // [keys][dp + 8]
  s.v = s.k + keys * row_bytes;                    // [keys][dp + 8]
  s.q = s.v + keys * row_bytes;                    // [stages][bm][dp + 8]
  s.g32 = s.q + stages * bm * row_bytes;           // [bm][dp + 4] f32
  s.g = s.g32 + bm * (dp + 4) * 4;                 // [bm][dp + 8] bf16(g)
  s.g_lo = s.g + bm * row_bytes;                   // [bm][dp + 8] the rest
  s.bias = s.g_lo + bm * row_bytes;                // [stages][bm][keys + 4]
  s.lse = s.bias + (bias ? stages * bm * (keys + 4) * 4 : 0);
  s.delta = s.lse + stages * kMaxRows * 4;         // [stages][64] f32
  s.seg = s.delta + stages * kMaxRows * 4;         // [stages][64] int
  s.total = s.seg + (seg ? stages * kMaxRows * 4 : 0);
  return s;
}

// One block per (`keys` keys, head, batch row); each warp owns 16 keys and
// accumulates their dk and dv over every Q tile, in order. DP is the head
// dim the fragments cover (64 or 128), Dh <= DP the real one. kSeg: segment
// ids restrict the pairs (a compile-time flag, so the other instantiations
// keep their code and registers); the block then walks only the Q tiles
// that share a segment with its keys, and the dead rows' dv comes from
// gdead (see the head of this file).
template <int DP, bool kBias, bool kSeg>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_tc_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = DP + 8;              // bf16 shared row pitch
  constexpr int GP = DP + 4;             // f32 shared row pitch of g
  constexpr int KC = DP / 16;            // k-steps of k.q^T and v.g^T
  constexpr int DT = DP / 8;             // 8-column tiles of dk, dv
  constexpr int CH = DP / 8;             // 16-byte bf16 chunks of a row
  // k and v fragments live in registers at DP = 64; at 128 they are read
  // from shared memory at each use, to stay clear of the 255 registers
  constexpr bool kKeep = DP <= 64;
  const Layout lay = layout(DP, a.keys, a.bm, a.stages, kBias, kSeg);
  bf16* ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  float* g32 = reinterpret_cast<float*>(smem + lay.g32);
  bf16* gs = reinterpret_cast<bf16*>(smem + lay.g);
  bf16* gl = reinterpret_cast<bf16*>(smem + lay.g_lo);
  float* bs = reinterpret_cast<float*>(smem + lay.bias);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* delta_s = reinterpret_cast<float*>(smem + lay.delta);
  int* seg_s = reinterpret_cast<int*>(smem + lay.seg);

  const int b = blockIdx.z, h = blockIdx.y, c0 = blockIdx.x * a.keys;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tq = lane & 3;
  const int L = a.L, S = a.S, bm = a.bm, BP = a.keys + 4;
  const int dch = a.Dh / 8;              // real 16-byte chunks of a row
  const Strides& st = a.st;
  const bf16* qb = a.q + b * st.q[0] + h * st.q[1];
  const bf16* kb = a.k + b * st.k[0] + h * st.k[1];
  const bf16* vb = a.v + b * st.v[0] + h * st.v[1];
  const float* gb = a.g + b * st.g[0] + h * st.g[1];
  const long long bh = (long long)b * a.H + h;
  const float* bias_h = kBias ? a.bias + (long long)h * L * S : nullptr;
  const int ntiles = (L + bm - 1) / bm;
  // kSeg: the batch row's summary (L == S), the ranges of this block's keys
  // and of this warp's 16, and the first Q tile that overlaps the block's
  const int ng = (L + kGranule - 1) / kGranule;
  const int2* sum = kSeg ? a.sum + (long long)b * ng : nullptr;
  int2 keys_range = none_range(), warp_range = none_range();
  int first = 0;
  if constexpr (kSeg) {
    keys_range = span(sum, ng, c0, a.keys);
    warp_range = span(sum, ng, c0 + warp * 16, 16);
    first = next_tile(sum, ng, -1, ntiles, bm, keys_range);
  }

  // this block's keys; rows past S and columns past Dh are zero
  mma::stage_rows(ks, P, kb, st.k[2], c0, a.keys, S, a.Dh, DP);
  mma::stage_rows(vs, P, vb, st.v[2], c0, a.keys, S, a.Dh, DP);
  // Q tile `t` (q, g in f32, lse, delta, the bias and the rows' segments)
  // into ring slot `sl` (g32 has one slot: it is converted before the next
  // tile is issued)
  auto issue = [&](int t, int sl) {
    const int r0 = t * bm;
    mma::stage_rows(qs + sl * bm * P, P, qb, st.q[2], r0, bm, L, a.Dh, DP);
    mma::stage_tile(g32, GP, gb, st.g[2], r0, bm, L, 0, DP, a.Dh, true);
    for (int i = tid; i < bm; i += nthr) {
      const bool ok = r0 + i < L;
      mma::cp_async4(lse_s + sl * kMaxRows + i,
                     ok ? a.lse + bh * L + r0 + i : a.lse, ok);
      mma::cp_async4(delta_s + sl * kMaxRows + i,
                     ok ? a.delta + bh * L + r0 + i : a.delta, ok);
      if (kSeg)
        mma::cp_async4(seg_s + sl * kMaxRows + i,
                       ok ? a.seg + (long long)b * L + r0 + i : a.seg, ok);
    }
    if (kBias)                           // 16-byte pieces when rows allow
      mma::stage_tile(bs + sl * bm * BP, BP, bias_h, S, r0, bm, L, c0,
                      a.keys, S, (S & 3) == 0);
  };
  if (!kSeg || first < ntiles) issue(first, 0);
  mma::cp_async_commit();

  // this lane's keys: rows grp and grp + 8 of the warp's 16
  const int lkey = warp * 16 + grp;
  bool key_in[2], key_ok[2];
  // kSeg: the key's segment where the key is real (mask and seg > 0), else
  // -1, which no row's segment equals: one compare tests all three
  int key_seg[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = c0 + lkey + 8 * hi;
    key_in[hi] = key < S;
    key_ok[hi] = key_in[hi] && a.kv_mask[(long long)b * S + key] != 0;
    if (kSeg) {
      const int sg = key_in[hi] ? a.seg[(long long)b * S + key] : 0;
      key_seg[hi] = key_ok[hi] && sg > 0 ? sg : -1;
    }
  }
  const float inv_s = 1.f / (float)S;
  const bf16* kw = ks + warp * 16 * P;   // this warp's k and v rows
  const bf16* vw = vs + warp * 16 * P;
  uint32_t kf[kKeep ? KC : 1][4], vf[kKeep ? KC : 1][4];
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  // kSeg: tn the next Q tile visited, n the tiles done
  int tn = 0;
  for (int t = first, n = 0; t < ntiles; t = kSeg ? tn : t + 1, ++n) {
    if constexpr (kSeg) tn = next_tile(sum, ng, t, ntiles, bm, keys_range);
    const int sl = (kSeg ? n : t) & 1;   // stages == 2 after the first tile
    mma::cp_async_wait_all();
    __syncthreads();                     // tile t landed; the last consumed
    if (kKeep && (kSeg ? n : t) == 0) {
#pragma unroll
      for (int kc = 0; kc < (kKeep ? KC : 1); ++kc) {
        const int off = (lane & 15) * P + kc * 16 + (lane >> 4) * 8;
        mma::ldmatrix_x4(kf[kc], kw + off);
        mma::ldmatrix_x4(vf[kc], vw + off);
      }
    }
    // g to a hi + lo pair of bf16, once per element, as it is staged
    for (int i = tid; i < bm * CH; i += nthr) {
      const int r = i / CH, c = i % CH;
      const float4 x = *reinterpret_cast<const float4*>(g32 + r * GP + c * 8);
      const float4 y =
          *reinterpret_cast<const float4*>(g32 + r * GP + c * 8 + 4);
      uint4 hi, lo;
      mma::split_bf16(x.x, x.y, hi.x, lo.x);
      mma::split_bf16(x.z, x.w, hi.y, lo.y);
      mma::split_bf16(y.x, y.y, hi.z, lo.z);
      mma::split_bf16(y.z, y.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(gs + r * P + c * 8) = hi;
      *reinterpret_cast<uint4*>(gl + r * P + c * 8) = lo;
    }
    __syncthreads();                     // gs, gl written; g32 free
    if ((kSeg ? tn : t + 1) < ntiles) {  // overlaps this tile's compute
      issue(kSeg ? tn : t + 1, sl ^ 1);
      mma::cp_async_commit();
    }
    const bf16* qt = qs + sl * bm * P;
    const float* bt = bs + sl * bm * BP;
    const float* lt = lse_s + sl * kMaxRows;
    const float* dt = delta_s + sl * kMaxRows;
    const int* sgt = seg_s + sl * kMaxRows;
    const int r0 = t * bm;

    // 16 query rows at a time: s^T = k.q^T and dp^T = v.g^T (16 keys x 16
    // rows), then p^T and ds^T, then dv += p^T.g and dk += ds^T.q
#pragma unroll
    for (int qc = 0; qc < kMaxRows / 16; ++qc) {
      if (qc * 16 >= bm) break;
      if constexpr (kSeg) {              // 16 rows sharing no segment with
        const int gi = r0 / kGranule + qc;  // this warp's keys add nothing
        if (gi >= ng || !overlap(warp_range, __ldg(sum + gi))) continue;
      }
      float sT[2][4], dpT[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
      const int boff = (qc * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ka[4], va[4], bq[4], bg[4];
        if constexpr (kKeep) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kc][e];
            va[e] = vf[kc][e];
          }
        } else {
          const int off = (lane & 15) * P + kc * 16 + (lane >> 4) * 8;
          mma::ldmatrix_x4(ka, kw + off);
          mma::ldmatrix_x4(va, vw + off);
        }
        mma::ldmatrix_x4(bq, qt + boff + kc * 16);
        mma::mma_bf16(sT[0], ka, bq[0], bq[1]);
        mma::mma_bf16(sT[1], ka, bq[2], bq[3]);
        mma::ldmatrix_x4(bg, gs + boff + kc * 16);
        mma::mma_bf16(dpT[0], va, bg[0], bg[1]);
        mma::mma_bf16(dpT[1], va, bg[2], bg[3]);
        mma::ldmatrix_x4(bg, gl + boff + kc * 16);
        mma::mma_bf16(dpT[0], va, bg[0], bg[1]);
        mma::mma_bf16(dpT[1], va, bg[2], bg[3]);
      }
      // element (n, e): key lkey + 8 * (e >> 1), query row
      // r0 + qc * 16 + n * 8 + 2 * tq + (e & 1)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1;
          const int lq = qc * 16 + n * 8 + 2 * tq + (e & 1);
          const float ls = lt[lq];
          float p = 0.f, ds = 0.f;
          // kSeg: a dead row takes p = 0 here (its g / S comes from gdead)
          if (r0 + lq < L && key_in[hi]) {
            if (!kSeg && ls <= kMaskedRowLse) {
              p = inv_s;                 // uniform softmax, no score grad
            } else if (kSeg ? ls > kMaskedRowLse && sgt[lq] == key_seg[hi]
                            : key_ok[hi]) {
              float x = sT[n][e] * a.scale;
              if (kBias) x += bt[lq * BP + lkey + 8 * hi];
              p = exp2f((x - ls) * kLog2e);
              ds = p * (dpT[n][e] - dt[lq]);
            }
          }
          sT[n][e] = p;
          dpT[n][e] = ds;
        }
      }
      // p^T and ds^T as A fragments, each a hi + lo pair of bf16
      uint32_t pa[4], pl[4], da[4], dl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = j >> 1, e = (j & 1) * 2;
        mma::split_bf16(sT[n][e], sT[n][e + 1], pa[j], pl[j]);
        mma::split_bf16(dpT[n][e], dpT[n][e + 1], da[j], dl[j]);
      }
      const int toff = (qc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                       (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        // dv += p.g as p_hi.g_hi + p_lo.g_hi + p_hi.g_lo (p_lo.g_lo is
        // below f32's rounding); dk += ds_hi.q + ds_lo.q (q is exact)
        uint32_t bg[4], bq[4];
        mma::ldmatrix_x4_trans(bg, gs + toff + dp * 16);
        mma::mma_bf16(dv[2 * dp], pa, bg[0], bg[1]);
        mma::mma_bf16(dv[2 * dp + 1], pa, bg[2], bg[3]);
        mma::mma_bf16(dv[2 * dp], pl, bg[0], bg[1]);
        mma::mma_bf16(dv[2 * dp + 1], pl, bg[2], bg[3]);
        mma::ldmatrix_x4_trans(bg, gl + toff + dp * 16);
        mma::mma_bf16(dv[2 * dp], pa, bg[0], bg[1]);
        mma::mma_bf16(dv[2 * dp + 1], pa, bg[2], bg[3]);
        mma::ldmatrix_x4_trans(bq, qt + toff + dp * 16);
        mma::mma_bf16(dk[2 * dp], da, bq[0], bq[1]);
        mma::mma_bf16(dk[2 * dp + 1], da, bq[2], bq[3]);
        mma::mma_bf16(dk[2 * dp], dl, bq[0], bq[1]);
        mma::mma_bf16(dk[2 * dp + 1], dl, bq[2], bq[3]);
      }
    }
  }

  if constexpr (kSeg) {
    // the K and V rows landed (no tile may have waited for them), and the
    // dead rows' p = 1/S at every key: dv += gdead / S, in f32
    mma::cp_async_wait_all();
    __syncthreads();
    const float* gd = a.gdead + bh * a.Dh;
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = d * 8 + 2 * tq + (e & 1);
        if (col < a.Dh) dv[d][e] += __ldg(gd + col) * inv_s;
      }
  }

  // dk and dv through this warp's own k and v rows (no other warp reads
  // them), then 16-byte stores
  bf16* kr = ks + warp * 16 * P;
  bf16* vr = vs + warp * 16 * P;
  __syncwarp();
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = d * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(kr + grp * P + c) =
        mma::pack_bf16(dk[d][0] * a.scale, dk[d][1] * a.scale);
    *reinterpret_cast<uint32_t*>(kr + (grp + 8) * P + c) =
        mma::pack_bf16(dk[d][2] * a.scale, dk[d][3] * a.scale);
    *reinterpret_cast<uint32_t*>(vr + grp * P + c) =
        mma::pack_bf16(dv[d][0], dv[d][1]);
    *reinterpret_cast<uint32_t*>(vr + (grp + 8) * P + c) =
        mma::pack_bf16(dv[d][2], dv[d][3]);
  }
  __syncwarp();
  bf16* dkb = a.dk + b * st.dk[0] + h * st.dk[1];
  bf16* dvb = a.dv + b * st.dv[0] + h * st.dv[1];
  for (int i = lane; i < 16 * dch; i += 32) {
    const int r = i / dch, c = i % dch;
    const int key = c0 + warp * 16 + r;
    if (key < S) {
      *reinterpret_cast<uint4*>(dkb + key * st.dk[2] + c * 8) =
          *reinterpret_cast<const uint4*>(kr + r * P + c * 8);
      *reinterpret_cast<uint4*>(dvb + key * st.dv[2] + c * 8) =
          *reinterpret_cast<const uint4*>(vr + r * P + c * 8);
    }
  }
}

// The largest shared memory a launch of the instantiation can ask for,
// granted once per instantiation and device.
template <int DP, bool kBias, bool kSeg>
cudaError_t allow_smem() {
  static per_device::PerDevice grants;
  return grants.get([] {
    return cudaFuncSetAttribute(
        flash_bwd_dkv_tc_kernel<DP, kBias, kSeg>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        layout(DP, kMaxKeys, kMaxRows, 2, kBias, kSeg).total);
  });
}

template <int DP, bool kBias, bool kSeg>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const cudaError_t err = allow_smem<DP, kBias, kSeg>();
  if (err != cudaSuccess) return err;
  const int smem = layout(DP, a.keys, a.bm, a.stages, kBias, kSeg).total;
  const dim3 grid((a.S + a.keys - 1) / a.keys, a.H, B);
  flash_bwd_dkv_tc_kernel<DP, kBias, kSeg>
      <<<grid, a.keys * 2, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation for `a`'s bias and seg.
template <int DP>
cudaError_t launch_dp(const Args& a, int B, cudaStream_t stream) {
  if (a.bias != nullptr)
    return a.seg != nullptr ? launch<DP, true, true>(a, B, stream)
                            : launch<DP, true, false>(a, B, stream);
  return a.seg != nullptr ? launch<DP, false, true>(a, B, stream)
                          : launch<DP, false, false>(a, B, stream);
}

}  // namespace tc

// ---- K2 and K4 on the tensor cores (bf16 q/k/v) ----------------------------

namespace tcq {

using bf16 = __nv_bfloat16;

constexpr int kMaxRows = 64;             // query rows per block: K2, 4 warps
constexpr int kBiasRows = 32;            // K4 (its bias tile and partial)
constexpr int kMaxKeys = 32;             // keys per KV tile
constexpr int kMaxBiasKeys = 512;        // K4's S: bias tile + partial fit
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets of the shared-memory buffers (all 16-byte aligned).
struct Layout {
  int q, g32, o32, kv0, kv1, bias, part, lse, mask, seg, ranges, chunks,
      next, total;
};

// Row pitch (floats) of K4's bias tile and partial: every key of the
// tiles that cover S, plus 16 bytes.
__host__ __device__ __forceinline__ int bias_pitch(int S, int bn) {
  return (S + bn - 1) / bn * bn + 4;
}

__host__ __device__ __forceinline__ Layout layout(int dp, int rows, int bn,
                                                  int S, bool dbias,
                                                  bool seg) {
  const int row_bytes = (dp + 8) * 2;    // bf16 row padded by 16 bytes
  const int f32_row = (dp + 4) * 4;      // f32 row padded by 16 bytes
  const int kv_bytes = 2 * bn * row_bytes;  // a ring slot: K rows, V rows
  const int bias_bytes = dbias ? rows * bias_pitch(S, bn) * 4 : 0;
  Layout s;
  s.q = 0;                                         // [rows][dp + 8] bf16
  s.g32 = s.q + rows * row_bytes;                  // [rows][dp + 4] f32
  s.o32 = s.g32 + rows * f32_row;                  // [rows][dp + 4] f32
  s.kv0 = s.o32 + rows * f32_row;                  // ring slot 0
  int next = s.kv0 + kv_bytes;
  // K2 has one batch row a block: slot 1 lies over g32 and o32, which are
  // free once the row's g fragments and delta are built. K4 fetches the
  // next batch row's g and out into them, so its slot 1 is its own.
  if (!dbias && kv_bytes <= 2 * rows * f32_row) {
    s.kv1 = s.g32;
  } else {
    s.kv1 = next;
    next += kv_bytes;
  }
  s.bias = next;                                   // [rows][bias_pitch] f32
  s.part = s.bias + bias_bytes;                    // [rows][bias_pitch] f32
  s.lse = s.part + bias_bytes;                     // [rows] f32
  s.mask = s.lse + rows * 4;                       // [2][bn] kv mask bytes
  s.seg = s.mask + 2 * bn;                         // [2][bn] key segments
  // With seg, in shared memory (K2 is at its 128-register cap, K4 at 168:
  // held in registers across the tile loop, these spilled): the segment
  // ranges (int2) of the block's rows and of each warp's 16 ([1 + 4]), of
  // the 16-key chunks of each ring slot's tile, the next tile visited after
  // each slot's, and K2's batch row's summary pointer or K4's first tile
  // visited and first tile count of a batch row
  s.ranges = s.seg + (seg ? 2 * bn * 4 : 0);       // 48 bytes
  s.chunks = s.ranges + (seg ? 48 : 0);            // [2][2] int2
  s.next = s.chunks + (seg ? 32 : 0);              // [2] int, then 8 bytes
  s.total = s.next + (seg ? 16 : 0);
  return s;
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* kv_mask;
  const float* bias;                     // K4 only
  const int* seg;                        // [B, L] segment ids, or null
  const int2* sum;                       // with seg: the segment summary
  const float* g;
  const float* out;
  const float* lse;
  float* delta;
  bf16* dq;
  float* part;                           // K4 only: [groups, H, L, S]
  int B, H, L, S, Dh;
  int rows;                              // query rows per block: 16, 32, 64
  int bn;                                // keys per KV tile: 16 or 32
  int group;                             // K4: batch rows per block
  int split;                             // warps sharing 16 query rows
  Layout lay;                            // shared memory, set by launch()
  float scale;
  Strides st;
};

// One block per (`rows` query rows, head, batch row) for K2, or per
// (`rows` query rows, head, group of `group` batch rows) for K4, which
// runs the rows of its group in order and sums their ds into its partial
// dbias. Each warp owns 16 query rows. DP is the head dim the fragments
// cover (64 or 128), Dh <= DP the real one. kSeg: segment ids restrict the
// pairs (a compile-time flag, so the other instantiations keep their code
// and registers); each batch row then walks only the KV tiles that share a
// segment with its Q tile (kSkip; see the head of this file).
template <int DP, bool kDbias, bool kSeg>
__device__ __forceinline__ void dq_body(const Args& a) {
  constexpr bool kSkip = kSeg;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = DP + 8;              // bf16 shared row pitch
  constexpr int GP = DP + 4;             // f32 shared row pitch
  constexpr int KC = DP / 16;            // k-steps of q.k^T and g.v^T
  constexpr int DT = DP / 8;             // 8-column tiles of dq
  // q is read from shared memory at each use (as fragments it would take
  // 16 more registers: K4 spilled at 3 blocks an SM), so K4 fetches the
  // next batch row's q once this row is done
  const Layout& lay = a.lay;             // read from the parameters
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  float* g32 = reinterpret_cast<float*>(smem + lay.g32);
  float* o32 = reinterpret_cast<float*>(smem + lay.o32);
  // ring slot 0 or 1 (a select, not an array in local memory)
  auto ring = [&](int sl) {
    return reinterpret_cast<bf16*>(smem + (sl ? lay.kv1 : lay.kv0));
  };
  float* bs = reinterpret_cast<float*>(smem + lay.bias);
  float* ps = reinterpret_cast<float*>(smem + lay.part);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  uint8_t* mask_s = smem + lay.mask;
  int* seg_s = reinterpret_cast<int*>(smem + lay.seg);

  const int h = blockIdx.y, q0 = blockIdx.x * a.rows;
  const int b0 = kDbias ? blockIdx.z * a.group : blockIdx.z;
  const int b1 = kDbias ? min(a.B, b0 + a.group) : b0 + 1;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tq = lane & 3;
  const int L = a.L, S = a.S, bn = a.bn, rows = a.rows;
  const int BP = bias_pitch(S, bn);
  const int dch = a.Dh / 8;              // real 16-byte chunks of a row
  const Strides& st = a.st;
  const int ntiles = (S + bn - 1) / bn;
  // K4 over more than 16 keys splits each KV tile's keys between two warps
  // of the same query rows (warp = rw + nrw * kh: rows rw, key half kh),
  // which doubles its warps without growing the bias tile or the partial
  const int split = blockDim.x / (rows * 2), nrw = rows / 16;
  const int rw = warp % nrw, kh = warp / nrw;
  const int lrow = rw * 16 + grp;        // this lane's rows: lrow, lrow + 8
  // the kv mask comes in 4-byte pieces when its rows allow
  const bool mask4 =
      (reinterpret_cast<uintptr_t>(a.kv_mask) & 3) == 0 && (S & 3) == 0;
  // kSkip: summary(b) batch row b's summary of ng granules (L == S);
  // ranges[0] the range of this block's rows, ranges[1 + w] warp w's 16
  // (K4: of the batch row being computed); chunk_ranges[2 sl + c] 16-key
  // chunk c of slot sl's tile; next[sl] the next tile visited after slot
  // sl's; K2's `first` the first KV tile that overlaps the block's rows
  // (ntiles if none), K4's first_s the same of the row computed or, from
  // that row's last pass on, the next row, and it0_s the row's first `it`
  // (in shared memory: K4 is at its 168-register cap, where these spilled)
  const int ng = (L + kGranule - 1) / kGranule;
  auto summary = [&](int b) {
    if constexpr (kDbias) return a.sum + (long long)b * ng;
    return *reinterpret_cast<const int2* const*>(smem + lay.next + 8);
  };
  int2* ranges = reinterpret_cast<int2*>(smem + lay.ranges);
  const int2* chunk_ranges = reinterpret_cast<const int2*>(smem + lay.chunks);
  int* next = reinterpret_cast<int*>(smem + lay.next);
  int* first_s = next + 2;
  int* it0_s = next + 3;
  // the ranges of a batch row's rows from its summary `sb`, by warp 0
  auto row_ranges = [&](const int2* sb) {
    if (tid <= nrw)
      ranges[tid] = tid == 0 ? span(sb, ng, q0, rows)
                             : span(sb, ng, q0 + (tid - 1) * 16, 16);
  };
  int first = 0;
  if constexpr (kSkip) {
    const int2* sum0 = a.sum + (long long)b0 * ng;
    row_ranges(sum0);
    if constexpr (!kDbias) {
      if (tid == 0)
        *reinterpret_cast<const int2**>(smem + lay.next + 8) = sum0;
    }
    __syncthreads();
    first = next_tile(sum0, ng, -1, ntiles, bn, ranges[0]);
    if constexpr (kDbias) *first_s = first;  // every thread the same
  }

  auto issue_q = [&](int b) {            // q rows past L, cols past Dh: 0
    mma::stage_rows(qs, P, a.q + b * st.q[0] + h * st.q[1], st.q[2], q0,
                    rows, L, a.Dh, DP);
  };
  auto issue_rows = [&](int b) {         // g, out and lse of the Q tile
    const long long bh = (long long)b * a.H + h;
    mma::stage_tile(g32, GP, a.g + b * st.g[0] + h * st.g[1], st.g[2], q0,
                    rows, L, 0, DP, a.Dh, true);
    mma::stage_tile(o32, GP, a.out + bh * L * a.Dh, a.Dh, q0, rows, L, 0, DP,
                    a.Dh, true);
    for (int i = tid; i < rows; i += nthr) {
      const bool ok = q0 + i < L;
      mma::cp_async4(lse_s + i, ok ? a.lse + bh * L + q0 + i : a.lse, ok);
    }
  };
  auto issue_kv = [&](int b, int t, int sl) {  // KV tile t into slot sl
    const int kv0 = t * bn;
    bf16* ks = ring(sl);
    mma::stage_rows(ks, P, a.k + b * st.k[0] + h * st.k[1], st.k[2], kv0, bn,
                    S, a.Dh, DP);
    mma::stage_rows(ks + bn * P, P, a.v + b * st.v[0] + h * st.v[1],
                    st.v[2], kv0, bn, S, a.Dh, DP);
    // the tile's kv mask bytes (0 past S): nonzero = a real key
    uint8_t* ms = mask_s + sl * bn;
    const uint8_t* mrow = a.kv_mask + (long long)b * S;
    if (mask4) {
      for (int i = 4 * tid; i < bn; i += 4 * nthr) {
        const bool ok = kv0 + i < S;
        mma::cp_async4(ms + i, ok ? mrow + kv0 + i : a.kv_mask, ok);
      }
    } else {
      for (int i = tid; i < bn; i += nthr)
        ms[i] = kv0 + i < S ? mrow[kv0 + i] : 0;
    }
    if constexpr (kSeg) {                // the tile's key segments (0 past S)
      const int* srow = a.seg + (long long)b * S;
      for (int i = tid; i < bn; i += nthr) {
        const bool ok = kv0 + i < S;
        mma::cp_async4(seg_s + sl * bn + i, ok ? srow + kv0 + i : a.seg, ok);
      }
    }
    if constexpr (kSkip) {               // its chunks' ranges; past the row
      const int* src =                   // (0, 0), which overlaps no range
          reinterpret_cast<const int*>(summary(b) + kv0 / kGranule);
      int* dst = reinterpret_cast<int*>(smem + lay.chunks) + 4 * sl;
      for (int i = tid; i < 2 * bn / kGranule; i += nthr) {
        const bool ok = kv0 / kGranule + i / 2 < ng;
        mma::cp_async4(dst + i, ok ? src + i : src - kv0 / 8, ok);
      }
    }
  };

  issue_q(b0);
  issue_rows(b0);
  if (!kSkip || first < ntiles) issue_kv(b0, first, 0);
  if constexpr (kDbias) {
    // the block's bias tile, once for every batch row of the group (16-byte
    // pieces when rows allow); the partial starts at 0
    mma::stage_tile(bs, BP, a.bias + (long long)h * L * S, S, q0, rows, L, 0,
                    BP - 4, S, (S & 3) == 0);
    for (int i = tid; i < rows * BP; i += nthr) ps[i] = 0.f;
  }
  mma::cp_async_commit();

  uint32_t gh[KC][4], gl[KC][4];         // g as hi + lo A fragments
  int it = 0;                            // KV tiles consumed: slot it & 1
  for (int b = b0; b < b1; ++b) {
    const long long bh = (long long)b * a.H + h;
    float dq[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
    float row_lse[2], row_delta[2];
    bool live[2];
    // kSeg: a live row's segment, -1 for a dead row (no key's segment
    // equals it). A live row's segment is > 0 (a pad row, seg 0, has no
    // allowed key, so its lse marks it fully masked), so the one compare
    // also drops pad keys and keys past S (segment 0)
    int qseg[2];

    // With kSkip, t walks the KV tiles visited: the next one is kept in
    // next[] (in shared memory: no register holds it across the tile).
    // `it` counts the tiles done over the group's rows; a row's first
    // pass (`it` at the row's start) always runs: it builds the row's
    // fragments and writes delta, and K4's issues the next row's g, out
    // and lse, for a Q tile that visits no KV tile too. Such a pass
    // consumes no ring slot (it ends before ++it), so the next row's
    // first tile, which it issues, goes into its own slot, and the dq
    // epilogue stages through the other, the last tile's of the row
    // before
    if constexpr (kSkip && kDbias) {
      first = *first_s;                // every thread the same
      *it0_s = it;
    }
    auto row_it0 = [&] { return kDbias ? *it0_s : 0; };
    for (int t = first; kSkip ? it == row_it0() || t < ntiles : t < ntiles;
         t = kSkip ? next[it & 1] : t + 1, ++it) {
      int tn = t + 1;                    // kSkip: the next tile visited
      if constexpr (kSkip) {
        tn = next_tile(summary(b), ng, t, ntiles, bn, ranges[0]);
        next[it & 1] = tn;             // every thread writes the same tile
      }
      const int sl = it & 1;
      mma::cp_async_wait_all();
      __syncthreads();                   // tile landed; the last consumed
      // the next KV tile (this row's, or the next row's first visited)
      // overlaps this tile's compute; K4 issues it at once, K2 (whose
      // second slot lies over g32 and o32) once the row's fragments are
      // built
      auto issue_next = [&] {
        if ((kSkip ? tn : t + 1) < ntiles) {
          issue_kv(b, kSkip ? tn : t + 1, sl ^ 1);
        } else if (kDbias && b + 1 < b1) {
          int f = 0;
          if constexpr (kSkip) {         // every warp finds the same tile
            f = next_tile(summary(b + 1), ng, -1, ntiles, bn,
                          span(summary(b + 1), ng, q0, rows));
            *first_s = f;
          }
          if (!kSkip || f < ntiles)
            issue_kv(b + 1, f, !kSkip || t < ntiles ? sl ^ 1 : sl);
        }
      };
      if constexpr (kDbias) issue_next();
      if (kSkip ? it == row_it0() : t == 0) {
        // g to a hi + lo pair of bf16 fragments, once per element, and
        // delta = g.out in f32 from the same elements: the four lanes of a
        // quad hold rows lrow and lrow + 8 whole
        float dsum[2] = {0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // a_j: row + 8 (j & 1), col + 8 (j >> 1)
            const int r = lrow + 8 * (j & 1);
            const int c = kc * 16 + 2 * tq + 8 * (j >> 1);
            const float2 x = *reinterpret_cast<const float2*>(g32 + r * GP + c);
            const float2 y = *reinterpret_cast<const float2*>(o32 + r * GP + c);
            dsum[j & 1] = fmaf(x.y, y.y, fmaf(x.x, y.x, dsum[j & 1]));
            mma::split_bf16(x.x, x.y, gh[kc][j], gl[kc][j]);
          }
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          dsum[hi] += __shfl_xor_sync(0xffffffffu, dsum[hi], 1);
          dsum[hi] += __shfl_xor_sync(0xffffffffu, dsum[hi], 2);
          const int row = q0 + lrow + 8 * hi;
          row_delta[hi] = dsum[hi];
          row_lse[hi] = lse_s[lrow + 8 * hi];
          // a row past L or a fully masked row adds nothing to dq or dbias
          live[hi] = row < L && row_lse[hi] > kMaskedRowLse;
          if constexpr (kSeg)
            qseg[hi] = live[hi] ? a.seg[(long long)b * L + row] : -1;
          if (kh == 0 && tq == 0 && row < L)
            a.delta[bh * L + row] = dsum[hi];
        }
        __syncthreads();                 // every warp's g, out, lse read
        if constexpr (kDbias) {          // the next batch row's, but q
          if (b + 1 < b1) issue_rows(b + 1);
        }
      }
      if constexpr (!kDbias) issue_next();
      mma::cp_async_commit();
      if (kSkip && t >= ntiles) break;   // no KV tile shares a segment

      const bf16* kt = ring(sl);
      const bf16* vt = kt + bn * P;
      const int kv0 = t * bn;
      // 16 keys at a time: s = q.k^T and dp = g.v^T (16 rows x 16 keys),
      // then p and ds, then dq += ds.k
#pragma unroll
      for (int c = 0; c < kMaxKeys / 16; ++c) {
        if (c * 16 >= bn) break;
        if (split == 2 && c != kh) continue;  // the other warp's keys
        if constexpr (kSkip) {           // 16 keys sharing no segment with
          if (!overlap(ranges[1 + rw], chunk_ranges[2 * sl + c]))
            continue;                    // this warp's rows add nothing
        }
        // this lane's mask bytes: keys 2 tq, 2 tq + 1 of 8-key tile n
        const uint8_t* mc = mask_s + sl * bn + c * 16 + 2 * tq;
        const uchar2 mk[2] = {*reinterpret_cast<const uchar2*>(mc),
                              *reinterpret_cast<const uchar2*>(mc + 8)};
        // and their segments
        int2 sk[2];
        if constexpr (kSeg) {
          const int* sc = seg_s + sl * bn + c * 16 + 2 * tq;
          sk[0] = *reinterpret_cast<const int2*>(sc);
          sk[1] = *reinterpret_cast<const int2*>(sc + 8);
        }
        float s[2][4], dp[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;

        const int koff = (c * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t qa[4], kb[4], vb[4];
          mma::ldmatrix_x4(qa, qs + (rw * 16 + (lane & 15)) * P + kc * 16 +
                                   (lane >> 4) * 8);
          mma::ldmatrix_x4(kb, kt + koff + kc * 16);
          mma::mma_bf16(s[0], qa, kb[0], kb[1]);
          mma::mma_bf16(s[1], qa, kb[2], kb[3]);
          mma::ldmatrix_x4(vb, vt + koff + kc * 16);
          mma::mma_bf16(dp[0], gh[kc], vb[0], vb[1]);
          mma::mma_bf16(dp[1], gh[kc], vb[2], vb[3]);
          mma::mma_bf16(dp[0], gl[kc], vb[0], vb[1]);
          mma::mma_bf16(dp[1], gl[kc], vb[2], vb[3]);
        }
        // element (n, e): tile row lrow + 8 * (e >> 1), key
        // kv0 + c * 16 + n * 8 + 2 * tq + (e & 1). The mask test lives
        // here, once per tile element (keys past S read 0).
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            // K4: this lane's bias pair (row lrow + 8 hi, keys 2 tq,
            // 2 tq + 1 of 8-key tile n)
            float2 bias2 = make_float2(0.f, 0.f);
            if constexpr (kDbias)
              bias2 = *reinterpret_cast<const float2*>(
                  bs + (lrow + 8 * hi) * BP + kv0 + c * 16 + n * 8 + 2 * tq);
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const int e = 2 * hi + e1;
              const bool real = (e1 ? mk[n].y : mk[n].x) != 0;
              const bool ok =
                  kSeg ? real && (e1 ? sk[n].y : sk[n].x) == qseg[hi]
                       : live[hi] && real;
              const float x = s[n][e] * a.scale + (e1 ? bias2.y : bias2.x);
              const float p = exp2f((x - row_lse[hi]) * kLog2e);
              s[n][e] = ok ? p * (dp[n][e] - row_delta[hi]) : 0.f;
            }
          }
        }
        // dbias from ds in f32; each (row, key) of the partial has this one
        // thread as its writer, in batch-row order
        if constexpr (kDbias) {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              float2* pp = reinterpret_cast<float2*>(
                  ps + (lrow + 8 * hi) * BP + kv0 + c * 16 + n * 8 + 2 * tq);
              const float2 old = *pp;
              *pp = make_float2(old.x + s[n][2 * hi], old.y + s[n][2 * hi + 1]);
            }
        }
        // ds as A fragments, a hi + lo pair of bf16 (rounded once, dq left
        // the tolerance where attention is peaked:
        // tests/test_torch_flash_rounding.py)
        uint32_t da[4], dl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = j >> 1, e = (j & 1) * 2;
          mma::split_bf16(s[n][e], s[n][e + 1], da[j], dl[j]);
        }
        const int toff = (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                         (lane >> 4) * 8;
#pragma unroll
        for (int d2 = 0; d2 < DT / 2; ++d2) {
          uint32_t kb[4];
          mma::ldmatrix_x4_trans(kb, kt + toff + d2 * 16);
          mma::mma_bf16(dq[2 * d2], da, kb[0], kb[1]);
          mma::mma_bf16(dq[2 * d2 + 1], da, kb[2], kb[3]);
          mma::mma_bf16(dq[2 * d2], dl, kb[0], kb[1]);
          mma::mma_bf16(dq[2 * d2 + 1], dl, kb[2], kb[3]);
        }
      }
    }

    // scale * dq through shared memory, then 16-byte stores into q's
    // strides: K2 through this warp's own q rows (no other warp reads
    // them), K4 through the last KV tile's slot once every warp is done
    // with it (the q buffer may hold the next row's q; with kSkip, the slot
    // before `it`, which no fetch for the next row lies under). With the
    // keys split, the second warp's dq goes through the slot in f32 first
    // and is added to the first's, in that order.
    bf16* stage;
    if constexpr (kDbias) {
      bf16* last = ring((it - 1) & 1);
      __syncthreads();
      // every warp is done with this row's q and ranges. With kSkip the
      // next row's q is fetched now, not after the dq stores (a row that
      // visits one tile or none waits for it), and its ranges go over this
      // row's, published by the barriers below (split == 1 only with L <=
      // 16, where the block is one warp: the one barrier here)
      if constexpr (kSkip) {
        if (b + 1 < b1) {
          issue_q(b + 1);
          mma::cp_async_commit();
          row_ranges(summary(b + 1));
        }
        if (split == 1) __syncthreads();
      }
      if (split == 2) {
        float* comb = reinterpret_cast<float*>(last) + rw * DT * 4 * 32;
        if (kh == 1) {
#pragma unroll
          for (int d = 0; d < DT; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e) comb[(d * 4 + e) * 32 + lane] = dq[d][e];
        }
        __syncthreads();
        if (kh == 0) {
#pragma unroll
          for (int d = 0; d < DT; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e) dq[d][e] += comb[(d * 4 + e) * 32 + lane];
        }
        __syncthreads();                 // comb read before it is staged over
      }
      stage = last + rw * 16 * P;
    } else {
      __syncwarp();
      stage = qs + rw * 16 * P;
    }
    if (kh == 0) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int c = d * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(stage + grp * P + c) =
            mma::pack_bf16(dq[d][0] * a.scale, dq[d][1] * a.scale);
        *reinterpret_cast<uint32_t*>(stage + (grp + 8) * P + c) =
            mma::pack_bf16(dq[d][2] * a.scale, dq[d][3] * a.scale);
      }
      __syncwarp();
      bf16* dqb = a.dq + b * st.dq[0] + h * st.dq[1];
      for (int i = lane; i < 16 * dch; i += 32) {
        const int r = i / dch, c = i % dch;
        const int row = q0 + rw * 16 + r;
        if (row < L)
          *reinterpret_cast<uint4*>(dqb + row * st.dq[2] + c * 8) =
              *reinterpret_cast<const uint4*>(stage + r * P + c * 8);
      }
    }
    if constexpr (kDbias && !kSkip) {    // q was read to the row's end
      if (b + 1 < b1) {
        issue_q(b + 1);
        mma::cp_async_commit();
      }
    }
  }

  if constexpr (kDbias) {                // the partial, once per block
    __syncthreads();
    float* pg = a.part + ((long long)blockIdx.z * a.H + h) * L * S;
    const int nr = min(rows, L - q0);
    if ((S & 3) == 0) {
      const int per_row = S / 4;
      for (int i = tid; i < nr * per_row; i += nthr) {
        const int r = i / per_row, c = i % per_row * 4;
        *reinterpret_cast<float4*>(pg + (long long)(q0 + r) * S + c) =
            *reinterpret_cast<const float4*>(ps + r * BP + c);
      }
    } else {
      for (int i = tid; i < nr * S; i += nthr) {
        const int r = i / S, c = i % S;
        pg[(long long)(q0 + r) * S + c] = ps[r * BP + c];
      }
    }
  }
}

// K2 for bf16 q/k/v. 4 blocks of 4 warps fit an SM at a head dim of 64
// (54 KB of shared memory, at most 128 registers a thread).
template <int DP, bool kSeg>
__global__ void __launch_bounds__(kMaxRows * 2, DP <= 64 ? 4 : 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ Args a) {
  dq_body<DP, false, kSeg>(a);
}

// K4 for bf16 q/k/v, first launch (the second is flash_bwd_dbias_sum_kernel).
// 3 blocks of 4 warps fit an SM at mT5's shape (74 KB of shared memory, at
// most 168 registers a thread).
template <int DP, bool kSeg>
__global__ void __launch_bounds__(kBiasRows * 4, DP <= 64 ? 3 : 1)
flash_bwd_dq_dbias_tc_kernel(const __grid_constant__ Args a) {
  dq_body<DP, true, kSeg>(a);
}

// The largest shared memory a launch of the instantiation can ask for,
// granted once per instantiation and device.
template <int DP, bool kDbias, bool kSeg>
cudaError_t allow_smem() {
  static per_device::PerDevice grants;
  return grants.get([] {
    int most = 0;
    for (int rows = 16; rows <= (kDbias ? kBiasRows : kMaxRows); rows *= 2)
      for (int bn = 16; bn <= kMaxKeys; bn *= 2)
      {
        const int bytes =
            layout(DP, rows, bn, kMaxBiasKeys, kDbias, kSeg).total;
        most = bytes > most ? bytes : most;
      }
    auto kernel = kDbias ? flash_bwd_dq_dbias_tc_kernel<DP, kSeg>
                         : flash_bwd_dq_tc_kernel<DP, kSeg>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    // all of the SM's unified memory that blocks can use as shared memory
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) cudaGetLastError();  // not left for a launch
    return e;
  });
}

// Blocks of the instantiation resident on one SM at its launch for `a`
// (0 when the query fails).
template <int DP, bool kDbias, bool kSeg>
int blocks_per_sm(const Args& a) {
  if (allow_smem<DP, kDbias, kSeg>() != cudaSuccess) return 0;
  int n = 0;
  auto kernel = kDbias ? flash_bwd_dq_dbias_tc_kernel<DP, kSeg>
                       : flash_bwd_dq_tc_kernel<DP, kSeg>;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, a.rows * 2 * a.split,
          layout(DP, a.rows, a.bn, a.S, kDbias, kSeg).total) != cudaSuccess)
    return 0;
  return n;
}

template <int DP, bool kDbias, bool kSeg>
cudaError_t launch(Args a, int blocks_z, cudaStream_t stream) {
  const cudaError_t err = allow_smem<DP, kDbias, kSeg>();
  if (err != cudaSuccess) return err;
  a.lay = layout(DP, a.rows, a.bn, a.S, kDbias, kSeg);
  const int smem = a.lay.total;
  const dim3 grid((a.L + a.rows - 1) / a.rows, a.H, blocks_z);
  auto kernel = kDbias ? flash_bwd_dq_dbias_tc_kernel<DP, kSeg>
                       : flash_bwd_dq_tc_kernel<DP, kSeg>;
  kernel<<<grid, a.rows * 2 * a.split, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation for the head dim, `kDbias` and `a`'s seg, launched on
// `blocks_z` batch rows or groups; with `blocks`, the occupancy query
// instead of a launch (its result in *blocks).
template <bool kDbias>
cudaError_t dispatch(const Args& a, int blocks_z, cudaStream_t stream,
                     int* blocks = nullptr) {
  const bool seg = a.seg != nullptr;
  if (blocks != nullptr) {
    *blocks = a.Dh <= 64
                  ? (seg ? blocks_per_sm<64, kDbias, true>(a)
                         : blocks_per_sm<64, kDbias, false>(a))
                  : (seg ? blocks_per_sm<128, kDbias, true>(a)
                         : blocks_per_sm<128, kDbias, false>(a));
    return cudaSuccess;
  }
  if (a.Dh <= 64)
    return seg ? launch<64, kDbias, true>(a, blocks_z, stream)
               : launch<64, kDbias, false>(a, blocks_z, stream);
  return seg ? launch<128, kDbias, true>(a, blocks_z, stream)
             : launch<128, kDbias, false>(a, blocks_z, stream);
}

// The arguments K2 and K4 share; the Q tile from L (16, 32 or 64 rows; 32
// at most with the bias, whose tile and partial would otherwise halve the
// blocks an SM holds), the KV tile from S (one 16-key step at the query
// tower's S=16), and K4's two warps a 16 rows over 32-key tiles.
Args make_args(const void* q, const void* k, const void* v,
               const void* kv_mask, const void* bias, const void* seg,
               const void* sum, const void* g, const void* out,
               const void* lse, void* delta, void* dq, void* part, int B,
               int H, int L, int S, int Dh, float scale, int group,
               const long long* strides) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  a.bias = static_cast<const float*>(bias);
  a.seg = static_cast<const int*>(seg);
  a.sum = static_cast<const int2*>(sum);
  a.g = static_cast<const float*>(g);
  a.out = static_cast<const float*>(out);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.part = static_cast<float*>(part);
  a.B = B;
  a.H = H;
  a.L = L;
  a.S = S;
  a.Dh = Dh;
  const int most = bias != nullptr ? kBiasRows : kMaxRows;
  a.rows = L <= 16 ? 16 : (L <= 32 || most == 32 ? 32 : kMaxRows);
  a.bn = S <= 16 ? 16 : kMaxKeys;
  a.split = bias != nullptr && a.bn > 16 ? 2 : 1;
  a.group = group;
  a.scale = scale;
  a.st = unpack(strides);
  return a;
}

}  // namespace tcq

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the CUDA error
// code of its launch (0 = launched). `strides` holds 21 element strides:
// (batch, head, row) of q, k, v, g, dq, dk, dv in that order. `seg` may be
// null; otherwise [B, L] int32 segment ids (0 = pad), contiguous, with
// L == S, as K1 takes them.

// The dead rows' sum that the bf16 K3 takes with segment ids, once per
// backward: gdead [B, H, Dh] f32, the sum of g over the rows with lse <=
// -1e29, in row order. lse [B, H, L] f32 contiguous; g [B, H, L, Dh] f32
// with the (batch, head, row) element strides `g_strides` and unit stride
// on Dh.
extern "C" int flash_bwd_gdead(const void* lse, const void* g, void* gdead,
                               int B, int H, int L, int Dh,
                               const long long* g_strides, void* stream) {
  const int bad = check_shape(B, H, L, L, Dh);
  if (bad) return bad;
  flash_bwd_gdead_kernel<<<dim3(H, B), kSumThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<float*>(gdead), H, L, Dh, g_strides[0], g_strides[1],
      g_strides[2]);
  return (int)cudaGetLastError();
}

// K2 for bf16 q/k/v, on the tensor cores: dq (bf16), and delta [B,H,L]
// f32 for K3. q, k, v, g and dq must be 16-byte aligned, and so must each
// of their strides (the wrapper makes a view that is not contiguous first).
// With `seg`, `summary` is the segment summary of the same seg
// (flash_fwd.cu's flash_fwd_seg_summary).
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* kv_mask, const void* seg,
                                 const void* summary, const void* g,
                                 const void* out, const void* lse,
                                 void* delta, void* dq, int B, int H, int L,
                                 int S, int Dh, float scale,
                                 const long long* strides, void* stream) {
  const int bad = check_shape(B, H, L, S, Dh, seg);
  if (bad) return bad;
  if (seg != nullptr && summary == nullptr) return (int)cudaErrorInvalidValue;
  const tcq::Args a = tcq::make_args(q, k, v, kv_mask, nullptr, seg, summary,
                                     g, out, lse, delta, dq, nullptr, B, H, L,
                                     S, Dh, scale, 1, strides);
  return (int)tcq::dispatch<false>(a, B, static_cast<cudaStream_t>(stream));
}

// K2 for f32 q/k/v, on the CUDA cores: dq (f32) and delta.
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* kv_mask, const void* seg,
                                const void* g, const void* out,
                                const void* lse, void* delta, void* dq, int B,
                                int H, int L, int S, int Dh, float scale,
                                const long long* strides, void* stream) {
  const int bad = check_shape(B, H, L, S, Dh, seg);
  if (bad) return bad;
  return (int)launch_dq_f32(q, k, v, kv_mask, seg, g, out, lse, delta, dq, B,
                            H, L, S, Dh, scale, unpack(strides),
                            static_cast<cudaStream_t>(stream));
}

// K4 for bf16 q/k/v, on the tensor cores: dq (bf16), delta [B,H,L] f32 for
// K3, and dbias [H,L,S] f32, through the scratch `part` [ceil(B / group),
// H, L, S] f32. Alignment as K2's; S at most tcq::kMaxBiasKeys (the
// wrapper sends a longer S to the f32 kernel). With `seg`, `summary` as
// K2's.
extern "C" int flash_bwd_dq_dbias_bf16(const void* q, const void* k,
                                       const void* v, const void* kv_mask,
                                       const void* bias, const void* seg,
                                       const void* summary, const void* g,
                                       const void* out, const void* lse,
                                       void* delta, void* dq, void* part,
                                       void* dbias, int B, int H, int L,
                                       int S, int Dh, float scale, int group,
                                       const long long* strides,
                                       void* stream) {
  const int bad = check_shape(B, H, L, S, Dh, seg);
  if (bad) return bad;
  if (S > tcq::kMaxBiasKeys) return (int)cudaErrorInvalidValue;
  if (seg != nullptr && summary == nullptr) return (int)cudaErrorInvalidValue;
  if (group <= 0 || (B + group - 1) / group > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const tcq::Args a = tcq::make_args(q, k, v, kv_mask, bias, seg, summary, g,
                                     out, lse, delta, dq, part, B, H, L, S,
                                     Dh, scale, group, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (B + group - 1) / group;
  const cudaError_t err = tcq::dispatch<true>(a, groups, s);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_partials(part, dbias, groups, H, L, S, s);
}

// K4 for f32 q/k/v, on the CUDA cores: dq (f32), delta and dbias, through
// `part` as above.
extern "C" int flash_bwd_dq_dbias_f32(const void* q, const void* k,
                                      const void* v, const void* kv_mask,
                                      const void* bias, const void* seg,
                                      const void* g, const void* out,
                                      const void* lse, void* delta, void* dq,
                                      void* part, void* dbias, int B, int H,
                                      int L, int S, int Dh, float scale,
                                      int group, const long long* strides,
                                      void* stream) {
  const int bad = check_shape(B, H, L, S, Dh, seg);
  if (bad) return bad;
  if (group <= 0 || (B + group - 1) / group > 65535)
    return (int)cudaErrorInvalidConfiguration;
  return (int)launch_dq_dbias_f32(q, k, v, kv_mask, bias, seg, g, out, lse,
                                  delta, dq, part, dbias, B, H, L, S, Dh,
                                  scale, group, unpack(strides),
                                  static_cast<cudaStream_t>(stream));
}

// Blocks an SM holds of the bf16 K2 (`dbias` 0) or K4 (1), with segment ids
// when `seg` is 1, at this shape on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 when the query fails).
extern "C" int flash_bwd_dq_tc_blocks_per_sm(int dbias, int seg, int L,
                                             int S, int Dh) {
  if (check_shape(1, 1, L, S, Dh, seg ? &seg : nullptr) ||
      (dbias && S > tcq::kMaxBiasKeys))
    return 0;
  const long long strides[21] = {};
  // only the pointers' presence counts here
  const tcq::Args a = tcq::make_args(nullptr, nullptr, nullptr, nullptr,
                                     dbias ? strides : nullptr,
                                     seg ? strides : nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, 1, 1, L, S, Dh, 1.f,
                                     1, strides);
  int blocks = 0;
  if (dbias)
    tcq::dispatch<true>(a, 0, nullptr, &blocks);
  else
    tcq::dispatch<false>(a, 0, nullptr, &blocks);
  return blocks;
}

// K3's tiles at this shape: `bm` query rows by `keys` keys. The key tile
// from S: one warp (16 keys) at the query tower's S=16. The Q tile from L;
// with the bias, 32 rows: a block's buffers then take 63 KB of shared
// memory instead of 106 at a head dim of 64, so 3 blocks fit an SM
// instead of 2.
static void dkv_tiles(int L, int S, bool bias, int* bm, int* keys) {
  *keys = S <= 16 ? 16 : (S <= 32 ? 32 : tc::kMaxKeys);
  *bm = bias && L > 32
            ? 32
            : (L >= tc::kMaxRows ? tc::kMaxRows : (L + 15) / 16 * 16);
}

// The tiles the bf16 K3 (with the bias when `bias` is 1), K2 and K4 take
// at this shape, as (query rows, keys): tiles[0], tiles[1] K3's Q tile and
// key block; tiles[2], tiles[3] K2's Q tile and KV tile; tiles[4],
// tiles[5] K4's. The seg kernels' visit shares are counted on the host at
// these tiles.
extern "C" void flash_bwd_tc_tiles(int L, int S, int bias, int* tiles) {
  dkv_tiles(L, S, bias != 0, &tiles[0], &tiles[1]);
  const long long strides[21] = {};
  for (int k4 = 0; k4 < 2; ++k4) {
    // only the bias pointer's presence counts here
    const tcq::Args a = tcq::make_args(nullptr, nullptr, nullptr, nullptr,
                                       k4 ? strides : nullptr, nullptr,
                                       nullptr, nullptr, nullptr, nullptr,
                                       nullptr, nullptr, nullptr, 1, 1, L, S,
                                       64, 1.f, 1, strides);
    tiles[2 + 2 * k4] = a.rows;
    tiles[3 + 2 * k4] = a.bn;
  }
}

// K3 for bf16 q/k/v, on the tensor cores: dk and dv (bf16), reading the
// delta K2 or K4 wrote; `bias` may be null. q, k, v, g, dk and dv must be
// 16-byte aligned, and so must each of their strides (the wrapper makes a
// view that is not contiguous first). With `seg`, `summary` is the segment
// summary of the same seg (flash_fwd.cu's flash_fwd_seg_summary) and
// `gdead` flash_bwd_gdead's, for the same lse and g.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* kv_mask,
                                  const void* bias, const void* seg,
                                  const void* summary, const void* gdead,
                                  const void* g, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int B, int H, int L, int S, int Dh,
                                  float scale, const long long* strides,
                                  void* stream) {
  const int bad = check_shape(B, H, L, S, Dh, seg);
  if (bad) return bad;
  if (seg != nullptr && (summary == nullptr || gdead == nullptr))
    return (int)cudaErrorInvalidValue;
  tc::Args a;
  a.q = static_cast<const tc::bf16*>(q);
  a.k = static_cast<const tc::bf16*>(k);
  a.v = static_cast<const tc::bf16*>(v);
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  a.bias = static_cast<const float*>(bias);
  a.seg = static_cast<const int*>(seg);
  a.sum = static_cast<const int2*>(summary);
  a.gdead = static_cast<const float*>(gdead);
  a.g = static_cast<const float*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<tc::bf16*>(dk);
  a.dv = static_cast<tc::bf16*>(dv);
  a.H = H;
  a.L = L;
  a.S = S;
  a.Dh = Dh;
  dkv_tiles(L, S, bias != nullptr, &a.bm, &a.keys);
  a.stages = L > a.bm ? 2 : 1;
  a.scale = scale;
  a.st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(Dh <= 64 ? tc::launch_dp<64>(a, B, s)
                        : tc::launch_dp<128>(a, B, s));
}

// K3 for f32 q/k/v, on the CUDA cores: dk and dv (f32).
extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* kv_mask, const void* bias,
                                 const void* seg, const void* g,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, int B, int H, int L, int S, int Dh,
                                 float scale, const long long* strides,
                                 void* stream) {
  const int bad = check_shape(B, H, L, S, Dh, seg);
  if (bad) return bad;
  return (int)launch_dkv_f32(q, k, v, kv_mask, bias, seg, g, lse, delta, dk,
                             dv, B, H, L, S, Dh, scale, unpack(strides),
                             static_cast<cudaStream_t>(stream));
}
