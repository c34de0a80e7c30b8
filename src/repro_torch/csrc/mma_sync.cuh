// Warp-level tensor-core building blocks written as inline PTX: 16-byte
// `cp.async` copies from device memory into shared memory, `ldmatrix` of
// 8 x 8 bf16 tiles (plain and transposed), `movmatrix` (an 8 x 8 bf16
// transpose in registers) and the `mma.sync.m16n8k16` product, bf16 in and
// f32 out. They were written for `flash_attention.cu` (its mma.sync kernel
// at head dims 16 and 32) and moved here from it when the split-KV kernel
// of `decode_attention.cu` came to need them too; `wkv6.cu` takes its
// `cp.async` copies from here as well, in place of a copy of its own.
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

}  // namespace mma
