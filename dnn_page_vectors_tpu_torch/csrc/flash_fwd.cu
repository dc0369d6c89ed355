// Flash-attention forward (kernel K1 of the port) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (dnn_page_vectors_tpu/ops/flash_attention.py, launched by
// `_flash_forward`). Same contract:
//   out[b,h,l,:] = softmax_s(scale * q[b,h,l,:] . k[b,h,s,:] + bias[h,l,s],
//                            masked) @ v[b,h,:,:]          (float32)
//   lse[b,h,l]   = log-sum-exp of the masked scores       (float32)
// q [B,H,L,Dh], k/v [B,H,S,Dh] in bf16 or f32 (any strides, unit stride on
// Dh); kv_mask [B,S] uint8; optional bias [H,L,S] f32 (T5 relative
// positions); optional seg [B,L] int32 packed-page segment ids (0 = pad,
// requires L == S). Disallowed scores take the FINITE value -1e30, never
// -inf: a row with every score masked then sees exp(0) = 1 for every key
// and returns mean(V), as the TPU kernel does (with -inf it would be NaN).
// Keys past S are no keys at all (probability exactly 0): ragged edges are
// masked here, not padded by the caller.
//
// The TPU kernel holds the whole KV slice in VMEM and has no KV loop
// (capped at 8,192 tokens). Here it is the FlashAttention-2 loop over key
// tiles: each query row keeps a running max and sum in f32 and rescales
// its accumulator as the max moves. Bias and segment ids are applied per
// score tile, so no [B,L,S] mask and no [B,H,L,S] score array exists in
// device memory. Two kernels, chosen by the inputs' dtype:
//
// flash_fwd_tc_kernel (bf16 q/k/v; every launch of the serving and
// training paths). What bounds it on an H100 SXM is bytes: at mT5's page
// shape (B=512, H=12, L=S=128, Dh=64, f32 bias) it must move about 507 MB
// (q, k, v in bf16, out in f32, lse), 0.151 ms at 3.35 TB/s, against 25.8
// GFLOP, 0.026 ms on the bf16 tensor cores. So the products run on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums) and the
// design keeps 16-byte loads in flight:
// - each warp owns 16 query rows, held in registers as mma A fragments
//   (at a head dim above 64 read from shared memory at each use instead,
//   which keeps the kernel clear of spills); a block has 1, 2 or 4 warps,
//   chosen from L so that the query tower's L=16 runs one warp per block
//   with no rows past L;
// - K and V tiles (16..64 keys, chosen from S; 32 with the bias, which
//   nearly halves the shared memory a block takes) stay bf16 in shared
//   memory in a two-stage ring filled by 16-byte cp.async while the
//   previous tile is computed; the bias tile rides in the same ring;
//   ldmatrix reads K as B fragments and V, transposed, as B fragments of
//   P.V; rows are padded by 16 bytes, so ldmatrix hits no bank twice;
// - a head dim that is not a multiple of 16 (or below 64) is zero-filled
//   to the kernel's width (64 or 128) in shared memory;
// - scale, bias, mask, segment test and the online softmax (base 2) work
//   on the score fragments in registers, with max and sum reduced across
//   the four lanes of a row; P is rounded to bf16 for P.V, as the plain
//   version rounds p to v's dtype (tests/test_torch_flash_rounding.py
//   rehearses this rounding against the JAX package);
// - out is written as f32 with 16-byte stores (lane pairs swap halves).
//
// Segment ids (sequence packing) are a template flag of the tensor-core
// kernel, flash_fwd_tc_kernel<DP, kSeg>, so the unsegmented instantiations
// carry no segment code. A packed row of 1,024 tokens holding 4 pages
// allows about a fifth of its pairs (bert_long_sp's packed shape, B=256,
// H=8, L=S=1024, Dh=64: the bytes K1 must move take 0.27 ms at 3.35 TB/s;
// walking every 64 x 64 tile took 5.9 ms on an H100), so with segment ids
// the kernel visits only the KV tiles whose segment range overlaps its Q
// tile's, by the segment summary (seg_skip.cuh), which a small kernel
// (flash_fwd_seg_summary_kernel) writes once per call and the backward
// takes over: the two-stage ring fetches the next tile visited, found by
// one warp-wide ballot over the summary, so a skipped tile costs no load,
// and inside a visited tile each warp skips the 16-key chunks whose range
// misses its 16 rows'. A skipped score was masked: for a row that sees a
// key it gave p = 0 and a correction of 1, so such a row's out and lse are
// what visiting every tile gave, up to the sign of a zero. A dead row (no
// allowed key: a pad row, or one of a segment whose keys are all masked)
// saw every key below S at the masked score and returned mean(V); with the
// skip it would average only the keys visited. So the summary kernel also
// writes vmean [B, H, Dh], the mean of V over the keys below S, reading V
// once per (batch row, head), and only for the batch rows that can hold a
// dead row; after the loop a row whose max is still the masked score (or
// -inf: it visited no tile) writes vmean and the lse it had before,
// -1e30 + log(S). A Q tile that shares no segment visits no tile and writes
// only that.
//
// flash_fwd_kernel (f32 q/k/v: the f32 checks, whose 2e-5 tolerance bf16
// operands cannot meet). One block per (64 query rows, head, batch row);
// K/V tiles of 64 rows staged in shared memory in f32; four threads share
// one query row, each scoring 16 of the tile's 64 keys on the CUDA cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm80.cuh"
#include "per_device.cuh"
#include "seg_skip.cuh"

namespace {

using namespace segskip;

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // keys per shared-memory tile
constexpr int kTPR = 4;                  // threads per query row
constexpr int kThreads = kBQ * kTPR;     // 256
constexpr int kCols = kBK / kTPR;        // keys scored per thread per tile
constexpr int kDhMax = 128;
constexpr int kChunks = kDhMax / 4 / kTPR;  // float4 output chunks per thread
constexpr float kMasked = -1e30f;

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ kv_mask,
                 const float* __restrict__ bias, const int* __restrict__ seg,
                 float* __restrict__ out, float* __restrict__ lse,
                 int H, int L, int S, int Dh, float scale,
                 long long q_sb, long long q_sh, long long q_sl,
                 long long k_sb, long long k_sh, long long k_sl,
                 long long v_sb, long long v_sh, long long v_sl) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = Dh + 4;                 // row pitch: 16-byte aligned rows
  float* qs = smem;                      // [kBQ][ld] scaled q, f32
  float* ks = qs + kBQ * ld;             // [kBK][ld]
  float* vs = ks + kBK * ld;             // [kBK][ld]
  int* key_ok = reinterpret_cast<int*>(vs + kBK * ld);  // [kBK]
  int* key_seg = key_ok + kBK;                          // [kBK]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;              // query row within the tile
  const int sub = tid % kTPR;            // which quarter of the row
  const int lane = tid & 31;
  const int row_lane0 = lane & ~(kTPR - 1);
  const int row = q0 + r;
  const bool row_ok = row < L;
  const int nchunk = Dh / 4;             // float4 chunks in one row

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < kBQ * Dh; i += kThreads) {
    const int rr = i / Dh, d = i % Dh;
    const int gr = q0 + rr;
    qs[rr * ld + d] = gr < L ? qb[gr * q_sl + d] * scale : 0.f;
  }
  const int q_seg =
      (seg != nullptr && row_ok) ? seg[(long long)b * L + row] : 0;

  float m = -INFINITY;                   // running max (finite after tile 0)
  float l = 0.f;                         // running sum of exp(s - m)
  float acc[kChunks * 4];
#pragma unroll
  for (int i = 0; i < kChunks * 4; ++i) acc[i] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += kBK) {
    __syncthreads();                     // previous tile fully consumed
    for (int i = tid; i < kBK * Dh; i += kThreads) {
      const int rr = i / Dh, d = i % Dh;
      const int gs = kv0 + rr;
      const bool in = gs < S;
      ks[rr * ld + d] = in ? kb[gs * k_sl + d] : 0.f;
      vs[rr * ld + d] = in ? vb[gs * v_sl + d] : 0.f;
    }
    for (int i = tid; i < kBK; i += kThreads) {
      const int gs = kv0 + i;
      // -1: past S (no key at all); 0: padding key; 1: real key
      key_ok[i] = gs < S ? (kv_mask[(long long)b * S + gs] ? 1 : 0) : -1;
      key_seg[i] =
          (seg != nullptr && gs < S) ? seg[(long long)b * S + gs] : 0;
    }
    __syncthreads();

    // scores of this thread's keys c = sub + kTPR * j
    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    const float* qrow = qs + r * ld;
    for (int d = 0; d < Dh; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (sub + kTPR * j) * ld + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + kTPR * j;
      const int ok = key_ok[c];
      if (ok < 0) {                      // past S: probability exactly 0
        s[j] = -INFINITY;
        continue;
      }
      float x = s[j];
      if (bias != nullptr && row_ok)
        x += bias[((long long)h * L + row) * S + kv0 + c];
      bool allowed = ok > 0;
      if (seg != nullptr)
        allowed = allowed && key_seg[c] > 0 && key_seg[c] == q_seg;
      x = allowed ? x : kMasked;
      s[j] = x;
      tile_max = fmaxf(tile_max, x);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // key kv0 is always < S, so tile_max is finite: m_new is finite too
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[j] = expf(s[j] - m_new);         // -inf (past S) -> 0
      psum += s[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kChunks * 4; ++i) acc[i] *= corr;

    // acc[chunk sub + kTPR*i] += sum_c p[c] * v[c, chunk]
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int src = 0; src < kTPR; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[j], row_lane0 | src);
        const float* vrow = vs + (src + kTPR * j) * ld;
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
          const int ch = sub + kTPR * i;
          if (ch < nchunk) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * ch);
            acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
            acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
            acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
            acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
          }
        }
      }
    }
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = out + (((long long)b * H + h) * L + row) * Dh;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int ch = sub + kTPR * i;
      if (ch < nchunk) {
        float4 o;
        o.x = acc[4 * i + 0] / den;
        o.y = acc[4 * i + 1] / den;
        o.z = acc[4 * i + 2] / den;
        o.w = acc[4 * i + 3] / den;
        *reinterpret_cast<float4*>(orow + 4 * ch) = o;
      }
    }
    if (sub == 0) lse[((long long)b * H + h) * L + row] = m + logf(den);
  }
}


// ---- the tensor-core kernel (bf16 q/k/v) ---------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kMaxRows = 64;             // query rows per block (4 warps)
constexpr int kMaxKeys = 64;             // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked2 = -1e30f * kLog2e;  // the masked score, base 2

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* kv_mask;
  const float* bias;
  const int* seg;
  float* out;
  float* lse;
  int H, L, S, Dh;
  int rows;                              // query rows per block: 16, 32, 64
  int bn;                                // keys per tile: 16, 32, 48, 64
  int stages;                            // tiles in the ring: 1 or 2
  float scale_log2;                      // scale * log2(e)
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl;
  // with seg (last, so the other instantiations' parameters keep their
  // places): the segment summary and the dead rows' output, mean(V)
  const int2* sum;
  const float* vmean;
};

// Byte offsets of the shared-memory buffers (all 16-byte aligned).
struct Layout {
  int q, k, v, bias, key_ok, key_seg, chunks, ranges, total;
};

__host__ __device__ __forceinline__ Layout layout(int dp, int rows, int bn,
                                                  int stages, bool bias,
                                                  bool seg) {
  const int row_bytes = (dp + 8) * 2;    // bf16 row padded by 16 bytes
  Layout s;
  s.q = 0;                                         // [rows][dp + 8]
  s.k = s.q + rows * row_bytes;                    // [stages][bn][dp + 8]
  s.v = s.k + stages * bn * row_bytes;             // [stages][bn][dp + 8]
  s.bias = s.v + stages * bn * row_bytes;          // [stages][rows][bn + 4]
  s.key_ok = s.bias + (bias ? stages * rows * (bn + 4) * 4 : 0);
  s.key_seg = s.key_ok + stages * bn * 4;          // [stages][bn] int
  // with seg (in shared memory: held in registers across the tile loop,
  // they spilled at a head dim of 64): the ranges of each ring slot's
  // 16-key chunks, [stages][4] int2, and of the block's rows and each
  // warp's 16, [1 + 4] int2
  s.chunks = s.key_seg + (seg ? stages * bn * 4 : 0);
  s.ranges = s.chunks + (seg ? stages * (kMaxKeys / 16) * 8 : 0);
  s.total = s.ranges + (seg ? 48 : 0);
  return s;
}

// One block per (`rows` query rows, head, batch row); DP is the head dim
// the fragments cover (64 or 128), Dh <= DP the real one. kSeg: segment ids
// restrict the pairs (a compile-time flag, so the unsegmented
// instantiations keep their code and registers); the block then walks only
// the KV tiles whose segment range overlaps its rows' (see the head of
// this file), and its dead rows take mean(V) from the summary kernel.
template <int DP, bool kSeg>
__global__ void __launch_bounds__(128)
flash_fwd_tc_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = DP + 8;              // shared row pitch, bf16 elements
  constexpr int KC = DP / 16;            // k-steps of q.k^T
  constexpr int DT = DP / 8;             // 8-column tiles of out
  constexpr int NT = kMaxKeys / 8;       // 8-key tiles of a score tile
  const bool has_bias = a.bias != nullptr;
  const Layout lay = layout(DP, a.rows, a.bn, a.stages, has_bias, kSeg);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.v);
  float* bs = reinterpret_cast<float*>(smem + lay.bias);
  int* key_ok = reinterpret_cast<int*>(smem + lay.key_ok);
  int* key_seg = reinterpret_cast<int*>(smem + lay.key_seg);
  const int2* chunk_rng = reinterpret_cast<const int2*>(smem + lay.chunks);
  int2* ranges = reinterpret_cast<int2*>(smem + lay.ranges);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * a.rows;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tq = lane & 3;
  const int L = a.L, S = a.S, bn = a.bn, BP = bn + 4;
  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + h * a.v_sh;
  const float* bias_h = has_bias ? a.bias + (long long)h * L * S : nullptr;
  const int ntiles = (S + bn - 1) / bn;
  // kSeg: the batch row's summary (L == S); ranges[0] the range of the
  // block's rows, ranges[1 + w] warp w's 16; the first KV tile that
  // overlaps the block's rows
  const int ng = (L + kGranule - 1) / kGranule;
  const int2* sum = kSeg ? a.sum + (long long)b * ng : nullptr;
  int first = 0;
  if constexpr (kSeg) {
    if (tid <= a.rows / 16)
      ranges[tid] = tid == 0 ? span(sum, ng, q0, a.rows)
                             : span(sum, ng, q0 + (tid - 1) * 16, 16);
    __syncthreads();
    first = next_tile(sum, ng, -1, ntiles, bn, ranges[0]);
  }

  // tile `t` of K, V, the bias, the key states (and with seg the key
  // segments and the chunks' ranges) into ring slot `st`
  auto issue = [&](int t, int st) {
    const int kv0 = t * bn;
    mma::stage_rows(ks + st * bn * P, P, kb, a.k_sl, kv0, bn, S, a.Dh, DP);
    mma::stage_rows(vs + st * bn * P, P, vb, a.v_sl, kv0, bn, S, a.Dh, DP);
    if (has_bias)                        // 16-byte pieces when rows allow
      mma::stage_tile(bs + st * a.rows * BP, BP, bias_h, S, q0, a.rows, L,
                      kv0, bn, S, (S & 3) == 0);
    for (int i = tid; i < bn; i += nthr) {
      const int s = kv0 + i;
      // -1: past S (no key at all); 0: padding key; 1: real key
      key_ok[st * bn + i] =
          s < S ? (a.kv_mask[(long long)b * S + s] ? 1 : 0) : -1;
      if (kSeg) key_seg[st * bn + i] = s < S ? a.seg[(long long)b * S + s] : 0;
    }
    if constexpr (kSeg) {                // past the row: (0, 0), no overlap
      const int* src = reinterpret_cast<const int*>(sum + kv0 / kGranule);
      int* dst = reinterpret_cast<int*>(smem + lay.chunks) + 8 * st;
      for (int i = tid; i < 2 * bn / kGranule; i += nthr) {
        const bool ok = kv0 / kGranule + i / 2 < ng;
        mma::cp_async4(dst + i, ok ? src + i : a.seg, ok);
      }
    }
  };
  // q rows past L and columns past Dh are zero; a Q tile that shares no
  // segment with any KV tile loads nothing
  if (!kSeg || first < ntiles) {
    mma::stage_rows(qs, P, qb, a.q_sl, q0, a.rows, L, a.Dh, DP);
    issue(first, 0);
  }
  mma::cp_async_commit();

  const int lrow = warp * 16 + grp;      // this lane's rows: lrow, lrow + 8
  const int row0 = q0 + lrow, row1 = row0 + 8;
  int qseg[2] = {0, 0};
  if constexpr (kSeg) {
    if (row0 < L) qseg[0] = a.seg[(long long)b * L + row0];
    if (row1 < L) qseg[1] = a.seg[(long long)b * L + row1];
  }

  constexpr bool kKeepQ = DP <= 64;      // q fragments in registers
  uint32_t qf[kKeepQ ? KC : 1][4];
  float m[2] = {-INFINITY, -INFINITY};   // running max, base 2
  float l[2] = {0.f, 0.f};               // this lane's share of the sum
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  // kSeg: t walks the KV tiles visited, tn the next one, n the tiles done
  int tn = 0;
  for (int t = first, n = 0; t < ntiles; t = kSeg ? tn : t + 1, ++n) {
    if constexpr (kSeg) tn = next_tile(sum, ng, t, ntiles, bn, ranges[0]);
    const int st = (kSeg ? n : t) & 1;   // stages == 2 after the first tile
    mma::cp_async_wait_all();
    __syncthreads();                     // tile t landed; the last consumed
    if (kKeepQ && (kSeg ? n : t) == 0) {
#pragma unroll
      for (int kc = 0; kc < (kKeepQ ? KC : 1); ++kc)
        mma::ldmatrix_x4(qf[kc], qs + (warp * 16 + (lane & 15)) * P +
                                     kc * 16 + (lane >> 4) * 8);
    }
    if ((kSeg ? tn : t + 1) < ntiles) {  // overlaps this tile's compute
      issue(kSeg ? tn : t + 1, st ^ 1);
      mma::cp_async_commit();
    }
    const bf16* kt = ks + st * bn * P;
    const bf16* vt = vs + st * bn * P;
    const float* bt = bs + st * a.rows * BP;
    const int* okt = key_ok + st * bn;
    const int* sgt = key_seg + st * bn;
    // kSeg: 16 keys sharing no segment with this warp's rows hold no
    // allowed pair: their scores stay masked below and their p.v is
    // skipped (p is 0 there for a row with a key, and a row without one
    // so far is reset by a later key or is dead)
    bool chunk_on[NT / 2];
#pragma unroll
    for (int c = 0; c < NT / 2; ++c)
      chunk_on[c] = c * 16 < bn &&
                    (!kSeg ||
                     overlap(ranges[1 + warp], chunk_rng[4 * st + c]));

    // scores: s = q . k^T over this tile's keys
    float s[NT][4];
#pragma unroll
    for (int n8 = 0; n8 < NT; ++n8)
      s[n8][0] = s[n8][1] = s[n8][2] = s[n8][3] = 0.f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (chunk_on[np]) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t qa[4], kf[4];
          if constexpr (kKeepQ) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qa[e] = qf[kc][e];
          } else {
            mma::ldmatrix_x4(qa, qs + (warp * 16 + (lane & 15)) * P +
                                     kc * 16 + (lane >> 4) * 8);
          }
          mma::ldmatrix_x4(
              kf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                      kc * 16 + ((lane >> 3) & 1) * 8);
          mma::mma_bf16(s[2 * np], qa, kf[0], kf[1]);
          mma::mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        }
      }
    }

    // scale, bias, mask (base 2); the tile's row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n8 = 0; n8 < NT; ++n8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n8 * 8 + 2 * tq + (e & 1), hi = e >> 1;
        float x = -INFINITY;             // past S or past the tile
        if (n8 * 8 < bn) {
          const int ok = okt[c];
          if (ok >= 0) {
            bool allowed = ok > 0;
            if constexpr (kSeg)
              allowed = allowed && sgt[c] > 0 && sgt[c] == qseg[hi];
            x = s[n8][e] * a.scale_log2;
            if (has_bias) x = fmaf(bt[(lrow + 8 * hi) * BP + c], kLog2e, x);
            x = allowed ? x : kMasked2;
          }
        }
        s[n8][e] = x;
        mx[hi] = fmaxf(mx[hi], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      // key t*bn < S (a tile visited lies below S), so mx is finite, and
      // so is the new max
      const float m_new = fmaxf(m[hi], mx[hi]);
      corr[hi] = exp2f(m[hi] - m_new);   // 0 on the first tile visited
      m[hi] = m_new;
      l[hi] *= corr[hi];
    }
#pragma unroll
    for (int n8 = 0; n8 < NT; ++n8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n8][e] - m[e >> 1]);  // -inf -> 0
        s[n8][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }

    // o += bf16(p) . v
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      if (chunk_on[kc]) {
        const uint32_t pa[4] = {
            mma::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
            mma::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
            mma::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
            mma::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t vf[4];
          mma::ldmatrix_x4_trans(
              vf, vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                      dp * 16 + (lane >> 4) * 8);
          mma::mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          mma::mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
  }
  // the row max contributes exp2(0) = 1, so l >= 1 at a row that visited a
  // tile. kSeg: a dead row (no allowed key: its max is still masked, or
  // -inf where it visited no tile) takes mean(V) and the lse of a row that
  // saw every key below S at the masked score, as without the skip
  bool dead[2] = {false, false};
  const float* vm = nullptr;
  if constexpr (kSeg) {
    dead[0] = m[0] <= kMasked2;
    dead[1] = m[1] <= kMasked2;
    vm = a.vmean + ((long long)b * a.H + h) * a.Dh;
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  float* ob = a.out + ((long long)b * a.H + h) * L * a.Dh;
  // lanes 2j and 2j+1 swap halves: the even lane writes 4 columns of row0,
  // the odd one 4 columns of row1, each as one 16-byte store
  const bool even = (tq & 1) == 0;
  const int orow = even ? row0 : row1;
  const int ocol = even ? 2 * tq : 2 * tq - 2;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    float x0 = o[d][0] * inv0, x1 = o[d][1] * inv0;
    float x2 = o[d][2] * inv1, x3 = o[d][3] * inv1;
    if constexpr (kSeg) {
      if (d * 8 < a.Dh) {
        const float2 mv =
            __ldg(reinterpret_cast<const float2*>(vm + d * 8 + 2 * tq));
        if (dead[0]) {
          x0 = mv.x;
          x1 = mv.y;
        }
        if (dead[1]) {
          x2 = mv.x;
          x3 = mv.y;
        }
      }
    }
    const float y0 = __shfl_xor_sync(0xffffffffu, even ? x2 : x0, 1);
    const float y1 = __shfl_xor_sync(0xffffffffu, even ? x3 : x1, 1);
    if (d * 8 < a.Dh && orow < L) {
      const float4 val = even ? make_float4(x0, x1, y0, y1)
                              : make_float4(y0, y1, x2, x3);
      *reinterpret_cast<float4*>(ob + (long long)orow * a.Dh + d * 8 + ocol) =
          val;
    }
  }
  if (tq == 0) {
    // m ln2 + log(l), the product and the sum each rounded (no fused
    // multiply-add, which the compiler applies to some instantiations
    // only): the same lse with and without segment ids, with and without
    // the skip
    auto row_lse = [](float mx, float sum) {
      return __fadd_rn(__fmul_rn(mx, kLn2), logf(sum));
    };
    float* lb = a.lse + ((long long)b * a.H + h) * L;
    const float dead_lse = row_lse(kMasked2, (float)S);
    if (row0 < L) lb[row0] = dead[0] ? dead_lse : row_lse(m[0], l[0]);
    if (row1 < L) lb[row1] = dead[1] ? dead_lse : row_lse(m[1], l[1]);
  }
}

// The largest shared memory a launch of flash_fwd_tc_kernel<DP, kSeg> can
// ask for, granted once per instantiation and device.
template <int DP, bool kSeg>
cudaError_t allow_smem() {
  static per_device::PerDevice grants;
  return grants.get([] {
    return cudaFuncSetAttribute(
        flash_fwd_tc_kernel<DP, kSeg>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        layout(DP, kMaxRows, kMaxKeys, 2, true, kSeg).total);
  });
}

template <int DP, bool kSeg>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const cudaError_t err = allow_smem<DP, kSeg>();
  if (err != cudaSuccess) return err;
  const int smem =
      layout(DP, a.rows, a.bn, a.stages, a.bias != nullptr, kSeg).total;
  const dim3 grid((a.L + a.rows - 1) / a.rows, a.H, B);
  flash_fwd_tc_kernel<DP, kSeg><<<grid, a.rows * 2, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation for the head dim and `a`'s seg.
cudaError_t dispatch(const Args& a, int B, cudaStream_t stream) {
  if (a.Dh <= 64)
    return a.seg != nullptr ? launch<64, true>(a, B, stream)
                            : launch<64, false>(a, B, stream);
  return a.seg != nullptr ? launch<128, true>(a, B, stream)
                          : launch<128, false>(a, B, stream);
}

// The tiles at this shape: `rows` query rows by `bn` keys. The query tile
// from L: one warp (16 rows) at the query tower's L=16. The key tile from
// S; with the bias, 32 keys: the ring (K, V and the bias tile) then takes
// 45 KB of shared memory instead of 80 at a head dim of 64, so 4 blocks fit
// an SM instead of 2.
void tiles(int L, int S, bool bias, int* rows, int* bn) {
  *rows = L <= 16 ? 16 : (L <= 32 ? 32 : kMaxRows);
  *bn = bias && S > 32 ? 32 : (S >= kMaxKeys ? kMaxKeys : (S + 15) / 16 * 16);
}

// ---- the segment summary and the dead rows' mean(V) (bf16 K1 with seg) ---

constexpr int kSumThreads = 128;
constexpr int kSumWarps = kSumThreads / 32;

// One block per (head, batch row). The blocks of head 0 write the summary
// of their batch row (seg_skip.cuh); every block writes vmean[b, h] = the
// mean of v[b, h] over the keys below S (= L), in f32,
// where batch row b can hold a dead row: a position with seg 0, or with a
// masked key (a row of a segment whose keys are all masked sees no key);
// elsewhere no row is dead, nothing reads it and it is 0. Warp w sums the
// rows w, w + 4, ... in order (lane j owning columns 2j, 2j + 1 of each 64),
// then the four sums are added in warp order and divided by S, so the
// result is bitwise fixed (ops/flash_attention.py: value_mean).
__global__ void __launch_bounds__(kSumThreads)
flash_fwd_seg_summary_kernel(const int* __restrict__ seg,
                             const uint8_t* __restrict__ kv_mask,
                             const bf16* __restrict__ v,
                             int2* __restrict__ sum,
                             float* __restrict__ vmean, int H, int L, int Dh,
                             long long v_sb, long long v_sh, long long v_sl) {
  __shared__ float part[kSumWarps][kDhMax];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* srow = seg + (long long)b * L;
  if (h == 0)
    write_summary(srow, L, sum + (long long)b * ((L + kGranule - 1) / kGranule),
                  tid, kSumThreads);
  const uint8_t* mrow = kv_mask + (long long)b * L;
  bool can_die = false;
  for (int i = tid; i < L; i += kSumThreads)
    can_die = can_die || srow[i] <= 0 || mrow[i] == 0;
  can_die = __syncthreads_or(can_die);
  float* out = vmean + ((long long)b * H + h) * Dh;
  if (!can_die) {
    for (int d = tid; d < Dh; d += kSumThreads) out[d] = 0.f;
    return;
  }
  const bf16* vb = v + b * v_sb + h * v_sh;
  for (int c = 2 * lane; c < Dh; c += 64) {
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int s = warp; s < L; s += kSumWarps) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vb + s * v_sl + c));
      acc.x += x.x;
      acc.y += x.y;
    }
    part[warp][c] = acc.x;
    part[warp][c + 1] = acc.y;
  }
  __syncthreads();
  for (int d = tid; d < Dh; d += kSumThreads) {
    float t = part[0][d];
#pragma unroll
    for (int w = 1; w < kSumWarps; ++w) t += part[w][d];
    out[d] = t / (float)L;
  }
}

}  // namespace tc

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

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the CUDA error
// code of its launch (0 = launched). `strides` holds the element strides
// of q, k, v over (batch, head, row): 9 values. bias and seg may be null;
// seg is [B, L] int32 (contiguous, L == S; 0 = pad).

// The segment summary of `seg` [B, L] int32 (contiguous), summary [B,
// ceil(L/16)] int2: the smallest and largest segment id > 0 of each 16
// positions of each batch row, (INT_MAX, 0) where there is none; the bf16
// K1, K2 and K3 with seg take it. And the dead rows' output, vmean [B, H,
// Dh] f32: the mean of v [B, H, L, Dh] bf16 (16-byte aligned, (batch,
// head, row) element strides `v_strides`, unit stride on Dh) over its L
// keys where the batch row can hold a row that sees no key (kv_mask [B, L]
// uint8 holds a 0 there, or seg a 0), else 0.
extern "C" int flash_fwd_seg_summary(const void* seg, const void* kv_mask,
                                     const void* v, void* summary,
                                     void* vmean, int B, int H, int L,
                                     int Dh, const long long* v_strides,
                                     void* stream) {
  if (seg == nullptr || kv_mask == nullptr || v == nullptr)
    return (int)cudaErrorInvalidValue;
  const int bad = check_shape(B, H, L, L, Dh, seg);
  if (bad) return bad;
  tc::flash_fwd_seg_summary_kernel<<<dim3(H, B), tc::kSumThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), static_cast<const uint8_t*>(kv_mask),
      static_cast<const tc::bf16*>(v), static_cast<int2*>(summary),
      static_cast<float*>(vmean), H, L, Dh, v_strides[0], v_strides[1],
      v_strides[2]);
  return (int)cudaGetLastError();
}

// The tiles the bf16 K1 (with the bias when `bias` is 1) takes at this
// shape: tiles[0] query rows, tiles[1] keys. The seg kernels' visit shares
// are counted on the host at these tiles.
extern "C" void flash_fwd_tc_tiles(int L, int S, int bias, int* tiles) {
  tc::tiles(L, S, bias != 0, &tiles[0], &tiles[1]);
}

// bf16 q/k/v: the tensor-core kernel. q, k and v must be 16-byte aligned,
// and so must each of their strides (the wrapper makes a view that is not
// contiguous first). With `seg`, `summary` and `vmean` are
// flash_fwd_seg_summary's for the same seg, kv_mask and v: the kernel
// visits only the KV tiles that share a segment with its Q tile, and its
// rows that see no key take vmean.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* kv_mask, const void* bias,
                              const void* seg, const void* summary,
                              const void* vmean, void* out, void* lse, int B,
                              int H, int L, int S, int Dh, float scale,
                              const long long* strides, void* stream) {
  const int bad = check_shape(B, H, L, S, Dh, seg);
  if (bad) return bad;
  if (seg != nullptr && (summary == nullptr || vmean == nullptr))
    return (int)cudaErrorInvalidValue;
  tc::Args a;
  a.q = static_cast<const tc::bf16*>(q);
  a.k = static_cast<const tc::bf16*>(k);
  a.v = static_cast<const tc::bf16*>(v);
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  a.bias = static_cast<const float*>(bias);
  a.seg = static_cast<const int*>(seg);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.L = L;
  a.S = S;
  a.Dh = Dh;
  tc::tiles(L, S, bias != nullptr, &a.rows, &a.bn);
  a.stages = S > a.bn ? 2 : 1;
  a.scale_log2 = scale * tc::kLog2e;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_sl = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_sl = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_sl = strides[8];
  a.sum = static_cast<const int2*>(summary);
  a.vmean = static_cast<const float*>(vmean);
  return (int)tc::dispatch(a, B, static_cast<cudaStream_t>(stream));
}

// f32 q/k/v: the CUDA-core kernel.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* kv_mask, const void* bias,
                             const void* seg, void* out, void* lse, int B,
                             int H, int L, int S, int Dh, float scale,
                             const long long* strides, void* stream) {
  const int bad = check_shape(B, H, L, S, Dh, seg);
  if (bad) return bad;
  const size_t smem = sizeof(float) * (size_t)(kBQ + 2 * kBK) * (Dh + 4) +
                      sizeof(int) * 2 * kBK;
  // granted once per device, at the largest head dim
  static per_device::PerDevice grants;
  const cudaError_t attr = grants.get([] {
    return cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * (size_t)(kBQ + 2 * kBK) * (kDhMax + 4) +
              sizeof(int) * 2 * kBK));
  });
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  const long long* st = strides;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_fwd_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const float*>(bias), static_cast<const int*>(seg),
      static_cast<float*>(out), static_cast<float*>(lse), H, L, S, Dh, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}
