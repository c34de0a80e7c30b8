// Pieces of a row-of-F · w dot product shared by the kernels of
// `eps_affine.cu` and `band_reclassify.cu` (both band kernels).
//
// A row is read in chunks of BYTES bytes (16, 8, 4, or 2 for bf16): the
// widest that the row pitch and the table's base address allow. A chunk
// holds BYTES / sizeof(T) elements, which `chunk_fma` unpacks from the
// register words in element order (no local array) and accumulates in fp32
// with fmaf against fp32 w. A group of `lanes` consecutive lanes shares a
// row; `group_sum` adds their partial sums with __shfl_xor_sync.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rowdot {

// the register type of one chunk
template <int BYTES>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = uint32_t;
};
template <>
struct Raw<2> {
  using type = uint16_t;
};

// word i of a chunk (i a compile-time constant after unrolling)
__device__ __forceinline__ uint32_t word(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(uint2 v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }

// acc + Σ_e chunk[e] · w[e] over the chunk's elements, in element order
template <typename T, int BYTES>
__device__ __forceinline__ float chunk_fma(typename Raw<BYTES>::type v,
                                           const float* w, float acc) {
  if constexpr (BYTES == 2) {
    static_assert(sizeof(T) == 2, "2-byte chunks hold one bf16");
    return fmaf(__uint_as_float(static_cast<uint32_t>(v) << 16), w[0], acc);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i)
      acc = fmaf(__uint_as_float(word(v, i)), w[i], acc);
    return acc;
  } else {
    // a bf16 is the high half of an f32: the low element of a word is
    // word << 16, the high one word & 0xffff0000 (exact)
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) {
      const uint32_t u = word(v, i);
      acc = fmaf(__uint_as_float(u << 16), w[2 * i], acc);
      acc = fmaf(__uint_as_float(u & 0xffff0000u), w[2 * i + 1], acc);
    }
    return acc;
  }
}

// chunk_fma with w read as 16-byte vectors: `w` must be 16-byte aligned
// and the chunk hold a multiple of 4 elements (scalar reads of w from
// shared memory by lanes 4 or 8 words apart conflict on the banks)
template <typename T, int BYTES>
__device__ __forceinline__ float chunk_fma_w4(typename Raw<BYTES>::type v,
                                              const float* w, float acc) {
  constexpr int kE = BYTES / static_cast<int>(sizeof(T));
  static_assert(kE % 4 == 0, "w in float4 needs 4 elements a chunk");
  float wl[kE];
#pragma unroll
  for (int q = 0; q < kE / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(w)[q];
    wl[4 * q] = t.x, wl[4 * q + 1] = t.y, wl[4 * q + 2] = t.z,
    wl[4 * q + 3] = t.w;
  }
  return chunk_fma<T, BYTES>(v, wl, acc);
}

// Sum over the aligned group of `lanes` lanes (a power of two, at most 32).
// Every lane of the warp must call it with the same `lanes` (full shuffle
// mask): callers keep their loops warp-uniform.
__device__ __forceinline__ float group_sum(float acc, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

}  // namespace rowdot
