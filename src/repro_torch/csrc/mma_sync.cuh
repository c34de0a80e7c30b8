// Warp-level tensor-core building blocks written as inline PTX: 16-byte
// `cp.async` copies from device memory into shared memory, `ldmatrix` of
// 8 x 8 bf16 tiles (plain and transposed; `wkv6_bwd.cu` reads 8 x 4 f32
// tiles with it, each word where a TF32 fragment wants it), `movmatrix`
// (an 8 x 8 bf16 transpose in registers) and the `mma.sync.m16n8k16`
// product, bf16 in and f32 out. They were written for `flash_attention.cu`
// (its mma.sync kernel at head dims 16 and 32) and moved here from it when
// the split-KV kernel of `decode_attention.cu` came to need them too. The
// TF32 helpers (`split_tf32`, `mma_tf32`, `mma_3xtf32`) serve `wkv6.cu`,
// whose f32 products run on the tensor cores in 3xTF32.
//
// Fragments of m16n8k16 (lane = 4 g + t): A (16 x 16, row-major) holds
// (row g, k 2t..2t+1), (row g + 8, k 2t..), (row g, k 2t + 8..),
// (row g + 8, k 2t + 8..); B (16 x 8) holds (k 2t..2t+1, col g) and
// (k 2t + 8.., col g); the f32 accumulator holds (row g, cols 2t, 2t + 1)
// and (row g + 8, cols 2t, 2t + 1). Pairs are packed low element first.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace mma {

using hopper::smem_addr;

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the transpose of an 8 x 8 bf16 matrix held as one register a lane (row
// g, cols 2t..2t+1): afterwards the lane holds (rows 2t, 2t + 1 of col g)
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// d += a · b for a 16x16 bf16 A (row), 16x8 bf16 B (col), 16x8 f32 D
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- TF32 ---------------------------------------------------------------
//
// Fragments of m16n8k8 with .tf32 (lane = 4 g + t): A (16 x 8, row-major)
// holds (row g, k t), (row g + 8, k t), (row g, k t + 4), (row g + 8,
// k t + 4); B (8 x 8) holds (k t, col g) and (k t + 4, col g); the f32
// accumulator is that of m16n8k16 above.

// x = hi + lo + O(2^-20 |x|) as two TF32 operands, in two full-rate
// integer and f32 operations: the tensor core reads a TF32 operand from a
// 32-bit register and drops its 13 low bits (rounds toward zero), so hi is
// x's own bits and lo = x − trunc(x), exact in f32, whose low bits are
// dropped in turn.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// d += a · b for a 16x8 TF32 A (row), 8x8 TF32 B (col), 16x8 f32 D
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i] += a · b[i] with f32 accuracy for N tiles that share the A
// fragment, from three TF32 products of the split operands (a = ah + al,
// b = bh + bl): the small terms al·bh + ah·bl into sml[i], ah·bh into
// acc[i] (al·bl, about 2^-22 relative, is dropped); the caller adds sml to
// acc at the end. Each round issues one product per tile, so the tiles'
// products interleave instead of waiting on one accumulator.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[N][4],
                                           float (&sml)[N][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(sml[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(sml[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(acc[i], ah, bh[i][0], bh[i][1]);
}

}  // namespace mma
