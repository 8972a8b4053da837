// Tensor-core and asynchronous-copy helpers shared by the port's kernels
// (sm_80 PTX that Hopper runs: mma.sync, ldmatrix, cp.async).
//
// Fragment layouts of mma.sync.m16n8k16 with bf16 operands and f32
// accumulators, with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major), 4 regs of 2 bf16:  a0 (row g,   cols 2t, 2t+1)
//                                              a1 (row g+8, cols 2t, 2t+1)
//                                              a2 (row g,   cols 2t+8, 2t+9)
//                                              a3 (row g+8, cols 2t+8, 2t+9)
//   B (16 x 8, k x n), 2 regs of 2 bf16:       b0 (rows 2t, 2t+1, col g)
//                                              b1 (rows 2t+8, 2t+9, col g)
//   C / D (16 x 8), 4 f32:                     c0, c1 (row g,   cols 2t, 2t+1)
//                                              c2, c3 (row g+8, cols 2t, 2t+1)
// so the C fragments of two neighbouring n-tiles are, element for element,
// the A fragment of the next product over that 16-wide k-step (the
// FlashAttention-2 register reuse).
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8m..8m+7 give the row
// addresses of matrix m, and register m of every lane receives its part:
// (row lane/4, cols 2(lane%4), +1) of the stored matrix, or with .trans
// (rows 2(lane%4), +1, col lane/4).
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes < 16 zero-fills the rest (0
// copies nothing and reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b on the tensor cores: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two bf16 of a packed register, as floats (exact).
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return make_float2(__uint_as_float(r << 16), __uint_as_float(r & 0xffff0000u));
}

// x = hi + lo to about 16 bits of mantissa: hi = bf16(x), lo = bf16(x - hi),
// for a pair of floats packed as two registers.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

}  // namespace tc
