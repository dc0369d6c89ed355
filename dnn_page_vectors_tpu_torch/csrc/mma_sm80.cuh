// PTX helpers shared by the tensor-core flash kernels (flash_fwd.cu's bf16
// K1, flash_bwd.cu's bf16 K3): asynchronous 16- and 4-byte copies from
// global to shared memory, 8x8 matrix loads from shared memory, and the
// warp-level bf16 matrix product m16n8k16 with float32 accumulation. All
// exist on sm_80 and later; the kernels are built for sm_90a.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * grp + tq):
//   A (16x16, row-major), 4 regs of two bf16: a0 (row grp, cols 2tq, 2tq+1),
//     a1 (row grp+8, same cols), a2 (row grp, cols 2tq+8, 2tq+9), a3 (row
//     grp+8, cols 2tq+8, 2tq+9);
//   B (16x8, "col"), 2 regs: b0 (rows 2tq, 2tq+1 of column grp), b1 (rows
//     2tq+8, 2tq+9);
//   C (16x8 f32), 4 floats: c0, c1 (row grp, cols 2tq, 2tq+1), c2, c3 (row
//     grp+8, same cols).
// The lower column (or row) index sits in the lower 16 bits of a register.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous; zero-filled when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until every copy this thread committed has landed (then a
// __syncthreads makes all threads' copies visible to the block).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + rows) of a row-major bf16 matrix of n rows and `cols`
// columns (row stride ld; base, ld and cols multiples of 8 elements) into
// shared rows of `pitch` elements, `width` columns wide (a multiple of 8,
// at least cols), by 16-byte copies from every thread of the block; rows
// past n and columns past cols are zero.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int pitch,
                                           const __nv_bfloat16* src,
                                           long long ld, int r0, int rows,
                                           int n, int cols, int width) {
  const int ch = width / 8;
  for (int i = threadIdx.x; i < rows * ch; i += blockDim.x) {
    const int r = i / ch, c = i % ch * 8;
    const bool ok = r0 + r < n && c < cols;
    cp_async16(dst + r * pitch + c, ok ? src + (r0 + r) * ld + c : src, ok);
  }
}

// The f32 tile of rows [r0, r0 + rows) and columns [c0, c0 + width) of a
// row-major matrix of n rows and m columns (row stride ld) into shared rows
// of `pitch` floats; outside the matrix, zero. With `vec4` (base, ld, m and
// c0 multiples of 4 floats; width too) in 16-byte copies, else in 4-byte
// ones.
__device__ __forceinline__ void stage_tile(float* dst, int pitch,
                                           const float* src, long long ld,
                                           int r0, int rows, int n, int c0,
                                           int width, int m, bool vec4) {
  const int step = vec4 ? 4 : 1, per_row = width / step;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = i % per_row * step;
    const bool ok = r0 + r < n && c0 + c < m;
    const float* from = ok ? src + (r0 + r) * ld + c0 + c : src;
    if (vec4)
      cp_async16(dst + r * pitch + c, from, ok);
    else
      cp_async4(dst + r * pitch + c, from, ok);
  }
}

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j
// (16-byte aligned), and register j of lane (4 * grp + tq) receives row grp,
// elements 2tq and 2tq+1 of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: register j of lane (4 * grp + tq)
// receives rows 2tq and 2tq+1 of column grp of matrix j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b for one 16x8x16 tile, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, lo in the low
// half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as a pair of bf16 registers: hi = bf16(x) and lo = bf16(x -
// hi), so that hi + lo holds about 16 bits of x (two products, one on hi
// and one on lo, summed in f32, then carry x almost exactly).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

}  // namespace mma
