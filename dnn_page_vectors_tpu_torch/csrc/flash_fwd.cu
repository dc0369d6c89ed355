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
//
// Design. The TPU kernel holds the whole KV slice in VMEM and has no KV
// loop (capped at 8,192 tokens). Here it is the FlashAttention-2 loop: one
// block per (Q tile of 64 rows, head, batch row); K/V tiles of 64 rows are
// staged in shared memory (widened to f32) in a loop over S; each query row
// keeps a running max and sum in f32 and rescales its accumulator as the
// max moves. Bias and segment ids are applied per score tile, so no
// [B,L,S] mask and no [B,H,L,S] score array ever exists in device memory.
// Ragged edges (L or S not a multiple of 64) are masked here, not padded
// by the caller: keys past S are no keys at all (probability exactly 0).
// Four threads share one query row: each scores 16 of the tile's 64 keys
// and owns a quarter of the Dh output columns; the row's max and sum are
// reduced with warp shuffles, and probabilities reach the owners of the
// output columns by shuffle as well.
//
// Bound on an H100 SXM at the bulk-embed shape (B=512, H=4, L=S=64,
// Dh=64, bf16): about 84 MB must move (q, k, v in bf16 = 50 MB, out in f32
// = 34 MB, lse 0.5 MB), which is about 25 us at 3.35 TB/s, against about
// 2.1 GFLOP, about 2 us at 989 TFLOP/s. The kernel is memory-bound, and
// the f32 output is 40% of the bytes. This first version is simple and
// right: it multiplies on the f32 CUDA cores, not the tensor cores.
// wgmma, TMA and a bf16 output are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // keys per shared-memory tile
constexpr int kTPR = 4;                  // threads per query row
constexpr int kThreads = kBQ * kTPR;     // 256
constexpr int kCols = kBK / kTPR;        // keys scored per thread per tile
constexpr int kDhMax = 128;
constexpr int kChunks = kDhMax / 4 / kTPR;  // float4 output chunks per thread
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ kv_mask,
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

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < kBQ * Dh; i += kThreads) {
    const int rr = i / Dh, d = i % Dh;
    const int gr = q0 + rr;
    qs[rr * ld + d] = gr < L ? to_f32(qb[gr * q_sl + d]) * scale : 0.f;
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
      ks[rr * ld + d] = in ? to_f32(kb[gs * k_sl + d]) : 0.f;
      vs[rr * ld + d] = in ? to_f32(vb[gs * v_sl + d]) : 0.f;
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, const void* bias, const void* seg,
                   void* out, void* lse, int B, int H, int L, int S, int Dh,
                   float scale, const long long* st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(kBQ + 2 * kBK) * (Dh + 4) +
                      sizeof(int) * 2 * kBK;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<const float*>(bias), static_cast<const int*>(seg),
      static_cast<float*>(out), static_cast<float*>(lse), H, L, S, Dh, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the CUDA error code of
// the launch (0 = launched). `strides` holds the element strides of q, k, v
// over (batch, head, row): 9 values. bias and seg may be null.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_mask, const void* bias,
                         const void* seg, void* out, void* lse, int B, int H,
                         int L, int S, int Dh, float scale, int is_bf16,
                         const long long* strides, void* stream) {
  if (Dh <= 0 || Dh > kDhMax || Dh % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || L <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch<__nv_bfloat16>(q, k, v, kv_mask, bias, seg, out, lse, B, H, L,
                              S, Dh, scale, strides, st)
      : launch<float>(q, k, v, kv_mask, bias, seg, out, lse, B, H, L, S, Dh,
                      scale, strides, st));
}
