// Tiles of (rows, HD) f32 attention operands staged in shared memory,
// shared by the CUDA-core f32 kernels of `flash_attention.cu` and
// `decode_attention.cu` (their bf16 kernels keep bf16 tiles on the tensor
// cores, through `mma_sync.cuh` and `hopper.cuh`).
//
// A tile row is one head's HD contiguous elements of a (b, s, heads, hd)
// tensor read through its row stride, so the model layout is read in place
// (the TPU wrapper transposed it first). Each 16-byte vector of a row goes
// to one thread; the loads of a whole tile are issued before any is stored
// (`fetch`, then `store`), so a thread keeps several loads in flight, and a
// caller can fetch the next tile while it computes on the current one.
// Rows past the valid count are stored as zeros, so a masked row meets a
// zero value row (0 · p and never NaN · 0).
//
// In shared memory a row has pitch HD + 4 floats: 16-byte aligned, and the
// eight rows that a quarter warp reads with float4 loads fall in distinct
// banks (pitch ≡ 4 or 20 mod 32 words).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

constexpr int kThreads = 256;        // threads per block
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr float kMinL = 1e-30f;      // floor of the softmax denominator
constexpr size_t kDefaultSmem = 48 * 1024;

template <int HD>
__host__ __device__ constexpr int pitch() { return HD + 4; }

// A tile of ROWS rows of HD floats, in flight in registers.
template <int HD, int ROWS>
struct Tile {
  static constexpr int kPerRow = HD / 4;
  static constexpr int kVecs = ROWS * kPerRow;
  static constexpr int kIters = (kVecs + kThreads - 1) / kThreads;
  uint4 raw[kIters];

  // Issue the loads of rows [0, valid) of `src` (row stride in elements).
  __device__ __forceinline__ void fetch(const float* __restrict__ src,
                                        int64_t row_stride, int valid) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * 4;
      raw[it] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kVecs && r < valid)
        raw[it] = __ldg(reinterpret_cast<const uint4*>(src + r * row_stride +
                                                       c));
    }
  }

  // Store the fetched rows at pitch HD + 4 (invalid rows as 0).
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (i >= kVecs) break;
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * 4;
      *reinterpret_cast<uint4*>(dst + r * pitch<HD>() + c) = raw[it];
    }
  }
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace attn
