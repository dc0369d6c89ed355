// Flash-attention backward (kernels K2, K3 and K4 of the port) for
// Hopper, sm_90a.
//
// Replace the Pallas TPU kernels `_flash_dq_kernel` (K2),
// `_flash_dkv_kernel` (K3) and `_flash_dq_dbias_kernel` (K4) of
// dnn_page_vectors_tpu/ops/flash_attention.py (launched by
// `_flash_backward`). With the row terms
//   p[l,s]  = exp(scale * q[l].k[s] + bias[h,l,s] - lse[l])
//                                    (0 for a masked key or a key past S;
//                                     no bias term without a bias)
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
// bias [H,L,S] f32 (contiguous), as K1 adds it (flash_fwd.cu).
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
// against the whole KV slice in VMEM). K2 is gridded over (Q tile of 64
// rows, head, batch row) with a loop over KV tiles of 64 keys; K3 over (KV
// tile, head, batch row) with a loop over Q tiles, in order.
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
// K2, K4, and K3 for f32 inputs, stage their tiles in shared memory
// widened to f32 and multiply on the CUDA cores. As in K1's f32 kernel,
// four threads share one row (a query row in K2/K4, a key in K3): each
// scores 16 of the tile's 64 partners and owns a quarter of the Dh output
// columns; the p and ds values reach the owners of the columns by warp
// shuffle. The bias and the partial dbias are read and written in global
// memory (L2-resident: [H,L,S] f32 is 0.8 MB at mT5's training shape, a
// block's partial 32 KB).
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
// All are memory-bound. K2 and K4 still multiply on the f32 CUDA cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr int kBQ = 64;                  // query rows per tile
constexpr int kBK = 64;                  // keys per tile
constexpr int kTPR = 4;                  // threads per row (query or key)
constexpr int kThreads = kBQ * kTPR;     // 256; also kBK * kTPR
constexpr int kCols = kBK / kTPR;        // partners scored per thread
constexpr int kDhMax = 128;
constexpr int kChunks = kDhMax / 4 / kTPR;  // float4 output chunks per thread
constexpr float kMaskedRowLse = -1e29f;  // lse of a fully masked row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Row pitch of a staged tile: 16-byte aligned rows.
__host__ __device__ __forceinline__ int pitch(int Dh) { return Dh + 4; }

// Stages rows [r0, r0 + 64) of a strided [rows, Dh] matrix (row stride
// `sl`) into `dst`, widened to f32 and multiplied by `mul`; rows past
// `n` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long sl,
                                      int r0, int n, int Dh, float mul) {
  const int ld = pitch(Dh);
  for (int i = threadIdx.x; i < 64 * Dh; i += kThreads) {
    const int rr = i / Dh, d = i % Dh;
    const int gr = r0 + rr;
    dst[rr * ld + d] = gr < n ? to_f32(src[gr * sl + d]) * mul : 0.f;
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

// K2's work for rows [q0, q0 + 64) of batch row b, head h: dq, and delta
// for K3. K2 runs it once per block, K4 once per batch row of its group.
// With `bias` the scores are rebuilt with it; with `part` (K4) the tile's
// ds is added into this group's partial dbias [L,S] of head h (stored,
// not added, when `first`). Each (row, key) of `part` belongs to one
// thread, the same one in every call.
template <typename T>
__device__ __forceinline__ void dq_tile(
    float* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    const float* __restrict__ bias, const float* __restrict__ g,
    const float* __restrict__ out, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, float* __restrict__ part,
    bool first, int b, int h, int q0, int H, int L, int S, int Dh,
    float scale, const Strides& st) {
  const int ld = pitch(Dh);
  float* qs = smem;                      // [kBQ][ld] scale * q
  float* gs = qs + kBQ * ld;             // [kBQ][ld] g
  float* ks = gs + kBQ * ld;             // [kBK][ld] k (out, first)
  float* vs = ks + kBK * ld;             // [kBK][ld] v
  int* key_ok = reinterpret_cast<int*>(vs + kBK * ld);  // [kBK]

  const int tid = threadIdx.x;
  const int r = tid / kTPR, sub = tid % kTPR;
  const int row_lane0 = (tid & 31) & ~(kTPR - 1);
  const int row = q0 + r;
  const bool row_ok = row < L;
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

  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
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
    }
    __syncthreads();

    float s[kCols], ds[kCols];
    dots(s, ds, qs + r * ld, ks, gs + r * ld, vs, ld, sub, Dh);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = kv0 + sub + kTPR * j;
      const bool ok = live && key_ok[sub + kTPR * j];
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
    T* drow = dq + b * st.dq[0] + h * st.dq[1] + row * st.dq[2];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int ch = sub + kTPR * i;
      if (ch < nchunk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(drow + 4 * ch + e, acc[4 * i + e] * scale);
      }
    }
  }
}

// K2: one block per (Q tile, head, batch row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const uint8_t* __restrict__ kv_mask,
                    const float* __restrict__ g, const float* __restrict__ out,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int H, int L, int S, int Dh,
                    float scale, Strides st) {
  extern __shared__ float4 smem4[];
  dq_tile<T>(reinterpret_cast<float*>(smem4), q, k, v, kv_mask, nullptr, g,
             out, lse, delta, dq, nullptr, false, blockIdx.z, blockIdx.y,
             blockIdx.x * kBQ, H, L, S, Dh, scale, st);
}

// K4, first launch: one block per (Q tile, head, group of `group` batch
// rows), K2's work for each row of the group in order, its ds summed into
// part[group index, h] ([groups, H, L, S] f32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const uint8_t* __restrict__ kv_mask,
                          const float* __restrict__ bias,
                          const float* __restrict__ g,
                          const float* __restrict__ out,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, T* __restrict__ dq,
                          float* __restrict__ part, int B, int H, int L,
                          int S, int Dh, float scale, int group,
                          Strides st) {
  extern __shared__ float4 smem4[];
  const int h = blockIdx.y;
  const int b0 = blockIdx.z * group;
  const int b1 = min(B, b0 + group);
  float* my_part = part + ((long long)blockIdx.z * H + h) * L * S;
  for (int b = b0; b < b1; ++b)
    dq_tile<T>(reinterpret_cast<float*>(smem4), q, k, v, kv_mask, bias, g,
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
// without the bias.
template <bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ kv_mask,
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

  const int b = blockIdx.z, h = blockIdx.y;
  const int c0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const int r = tid / kTPR, sub = tid % kTPR;
  const int row_lane0 = (tid & 31) & ~(kTPR - 1);
  const int key = c0 + r;
  const bool key_in = key < S;
  const bool key_ok = key_in && kv_mask[(long long)b * S + key] != 0;
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
      } else {
        row_lse[i] = row_delta[i] = 0.f;
        row_state[i] = -1;
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
      if (state > 0 && key_ok) {
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
          store(krow + 4 * ch + e, acc_k[4 * i + e] * scale);
          store(vrow + 4 * ch + e, acc_v[4 * i + e]);
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

int check_shape(int B, int H, int L, int S, int Dh) {
  if (Dh <= 0 || Dh > kDhMax || Dh % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || L <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* kv_mask, const void* g, const void* out,
                      const void* lse, void* delta, void* dq, int B, int H,
                      int L, int S, int Dh, float scale, const Strides& st,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes(Dh, kBK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const float*>(g), static_cast<const float*>(out),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), H, L, S, Dh, scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_dbias(const void* q, const void* k, const void* v,
                            const void* kv_mask, const void* bias,
                            const void* g, const void* out, const void* lse,
                            void* delta, void* dq, void* part, void* dbias,
                            int B, int H, int L, int S, int Dh, float scale,
                            int group, const Strides& st,
                            cudaStream_t stream) {
  const size_t smem = smem_bytes(Dh, kBK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_dbias_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (B + group - 1) / group;
  const dim3 grid((L + kBQ - 1) / kBQ, H, groups);
  flash_bwd_dq_dbias_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const float*>(bias), static_cast<const float*>(g),
      static_cast<const float*>(out), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq),
      static_cast<float*>(part), B, H, L, S, Dh, scale, group, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)H * L * S;
  flash_bwd_dbias_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                               stream>>>(static_cast<const float*>(part),
                                         static_cast<float*>(dbias), groups,
                                         n);
  return cudaGetLastError();
}

cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* kv_mask, const void* bias,
                           const void* g, const void* lse, const void* delta,
                           void* dk, void* dv, int B, int H, int L, int S,
                           int Dh, float scale, const Strides& st,
                           cudaStream_t stream) {
  const size_t smem = smem_bytes(Dh, 3 * kBQ);
  auto kernel = bias != nullptr ? flash_bwd_dkv_kernel<true>
                                : flash_bwd_dkv_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBK - 1) / kBK, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const float*>(bias), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, L, S, Dh, scale,
      st);
  return cudaGetLastError();
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
};

// Byte offsets of the shared-memory buffers (all 16-byte aligned).
struct Layout {
  int k, v, q, g32, g, g_lo, bias, lse, delta, total;
};

__host__ __device__ __forceinline__ Layout layout(int dp, int keys, int bm,
                                                  int stages, bool bias) {
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
  s.total = s.delta + stages * kMaxRows * 4;
  return s;
}

// One block per (`keys` keys, head, batch row); each warp owns 16 keys and
// accumulates their dk and dv over every Q tile, in order. DP is the head
// dim the fragments cover (64 or 128), Dh <= DP the real one.
template <int DP, bool kBias>
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
  const Layout lay = layout(DP, a.keys, a.bm, a.stages, kBias);
  bf16* ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  float* g32 = reinterpret_cast<float*>(smem + lay.g32);
  bf16* gs = reinterpret_cast<bf16*>(smem + lay.g);
  bf16* gl = reinterpret_cast<bf16*>(smem + lay.g_lo);
  float* bs = reinterpret_cast<float*>(smem + lay.bias);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* delta_s = reinterpret_cast<float*>(smem + lay.delta);

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

  // this block's keys; rows past S and columns past Dh are zero
  mma::stage_rows(ks, P, kb, st.k[2], c0, a.keys, S, a.Dh, DP);
  mma::stage_rows(vs, P, vb, st.v[2], c0, a.keys, S, a.Dh, DP);
  // Q tile `t` (q, g in f32, lse, delta and the bias) into ring slot `sl`
  // (g32 has one slot: it is converted before the next tile is issued)
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
    }
    if (kBias)                           // 16-byte pieces when rows allow
      mma::stage_tile(bs + sl * bm * BP, BP, bias_h, S, r0, bm, L, c0,
                      a.keys, S, (S & 3) == 0);
  };
  issue(0, 0);
  mma::cp_async_commit();

  // this lane's keys: rows grp and grp + 8 of the warp's 16
  const int lkey = warp * 16 + grp;
  bool key_in[2], key_ok[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = c0 + lkey + 8 * hi;
    key_in[hi] = key < S;
    key_ok[hi] = key_in[hi] && a.kv_mask[(long long)b * S + key] != 0;
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

  for (int t = 0; t < ntiles; ++t) {
    const int sl = t & 1;                // stages == 2 whenever t > 0
    mma::cp_async_wait_all();
    __syncthreads();                     // tile t landed; tile t-1 consumed
    if (kKeep && t == 0) {
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
    if (t + 1 < ntiles) {                // overlaps this tile's compute
      issue(t + 1, sl ^ 1);
      mma::cp_async_commit();
    }
    const bf16* qt = qs + sl * bm * P;
    const float* bt = bs + sl * bm * BP;
    const float* lt = lse_s + sl * kMaxRows;
    const float* dt = delta_s + sl * kMaxRows;
    const int r0 = t * bm;

    // 16 query rows at a time: s^T = k.q^T and dp^T = v.g^T (16 keys x 16
    // rows), then p^T and ds^T, then dv += p^T.g and dk += ds^T.q
#pragma unroll
    for (int qc = 0; qc < kMaxRows / 16; ++qc) {
      if (qc * 16 >= bm) break;
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
          if (r0 + lq < L && key_in[hi]) {
            if (ls <= kMaskedRowLse) {
              p = inv_s;                 // uniform softmax, no score grad
            } else if (key_ok[hi]) {
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
// granted once per instantiation (this process's device).
template <int DP, bool kBias>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<DP, kBias>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      layout(DP, kMaxKeys, kMaxRows, 2, kBias).total);
  return err;
}

template <int DP, bool kBias>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const cudaError_t err = allow_smem<DP, kBias>();
  if (err != cudaSuccess) return err;
  const int smem = layout(DP, a.keys, a.bm, a.stages, kBias).total;
  const dim3 grid((a.S + a.keys - 1) / a.keys, a.H, B);
  flash_bwd_dkv_tc_kernel<DP, kBias><<<grid, a.keys * 2, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the CUDA error
// code of its launch (0 = launched). `strides` holds 21 element strides:
// (batch, head, row) of q, k, v, g, dq, dk, dv in that order.

// K2: dq, and delta [B,H,L] f32 for K3.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* kv_mask, const void* g,
                            const void* out, const void* lse, void* delta,
                            void* dq, int B, int H, int L, int S, int Dh,
                            float scale, int is_bf16,
                            const long long* strides, void* stream) {
  const int bad = check_shape(B, H, L, S, Dh);
  if (bad) return bad;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch_dq<__nv_bfloat16>(q, k, v, kv_mask, g, out, lse, delta, dq, B,
                                 H, L, S, Dh, scale, st, s)
      : launch_dq<float>(q, k, v, kv_mask, g, out, lse, delta, dq, B, H, L,
                         S, Dh, scale, st, s));
}

// K4: dq, delta [B,H,L] f32 for K3, and dbias [H,L,S] f32, through the
// scratch `part` [ceil(B / group), H, L, S] f32.
extern "C" int flash_bwd_dq_dbias(const void* q, const void* k,
                                  const void* v, const void* kv_mask,
                                  const void* bias, const void* g,
                                  const void* out, const void* lse,
                                  void* delta, void* dq, void* part,
                                  void* dbias, int B, int H, int L, int S,
                                  int Dh, float scale, int is_bf16,
                                  int group, const long long* strides,
                                  void* stream) {
  const int bad = check_shape(B, H, L, S, Dh);
  if (bad) return bad;
  if (group <= 0 || (B + group - 1) / group > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch_dq_dbias<__nv_bfloat16>(q, k, v, kv_mask, bias, g, out, lse,
                                       delta, dq, part, dbias, B, H, L, S,
                                       Dh, scale, group, st, s)
      : launch_dq_dbias<float>(q, k, v, kv_mask, bias, g, out, lse, delta,
                               dq, part, dbias, B, H, L, S, Dh, scale, group,
                               st, s));
}

// K3 for bf16 q/k/v, on the tensor cores: dk and dv (bf16), reading the
// delta K2 or K4 wrote; `bias` may be null. q, k, v, g, dk and dv must be
// 16-byte aligned, and so must each of their strides (the wrapper makes a
// view that is not contiguous first).
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* kv_mask,
                                  const void* bias, const void* g,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int H, int L,
                                  int S, int Dh, float scale,
                                  const long long* strides, void* stream) {
  const int bad = check_shape(B, H, L, S, Dh);
  if (bad) return bad;
  tc::Args a;
  a.q = static_cast<const tc::bf16*>(q);
  a.k = static_cast<const tc::bf16*>(k);
  a.v = static_cast<const tc::bf16*>(v);
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  a.bias = static_cast<const float*>(bias);
  a.g = static_cast<const float*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<tc::bf16*>(dk);
  a.dv = static_cast<tc::bf16*>(dv);
  a.H = H;
  a.L = L;
  a.S = S;
  a.Dh = Dh;
  // the key tile from S: one warp (16 keys) at the query tower's S=16
  a.keys = S <= 16 ? 16 : (S <= 32 ? 32 : tc::kMaxKeys);
  // the Q tile from L; with the bias, 32 rows: a block's buffers then take
  // 63 KB of shared memory instead of 106 at a head dim of 64, so 3 blocks
  // fit an SM instead of 2
  a.bm = bias != nullptr && L > 32
             ? 32
             : (L >= tc::kMaxRows ? tc::kMaxRows : (L + 15) / 16 * 16);
  a.stages = L > a.bm ? 2 : 1;
  a.scale = scale;
  a.st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool biased = bias != nullptr;
  if (Dh <= 64)
    return (int)(biased ? tc::launch<64, true>(a, B, s)
                        : tc::launch<64, false>(a, B, s));
  return (int)(biased ? tc::launch<128, true>(a, B, s)
                      : tc::launch<128, false>(a, B, s));
}

// K3 for f32 q/k/v, on the CUDA cores: dk and dv (f32).
extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* kv_mask, const void* bias,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int L, int S, int Dh, float scale,
                                 const long long* strides, void* stream) {
  const int bad = check_shape(B, H, L, S, Dh);
  if (bad) return bad;
  return (int)launch_dkv_f32(q, k, v, kv_mask, bias, g, lse, delta, dk, dv,
                             B, H, L, S, Dh, scale, unpack(strides),
                             static_cast<cudaStream_t>(stream));
}
