// eps = F·w − b over every row, with sign labels and the positive count,
// in one pass over F; hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `eps_affine` / `_eps_kernel`
// (src/repro/kernels/eps_affine/kernel.py:20-58) and its padding wrapper
// (src/repro/kernels/eps_affine/ops.py:9-24): the paper's relabel-everything
// pass (the naive eager update, and the eps recompute inside a reorganize).
//
// What it computes, for F (n, d) f32 or bf16, w (d,) f32 and b () f32:
//   eps[r]    = dot(F[r], w) - b        fp32 accumulator, fp32 output
//   labels[r] = eps[r] >= 0 ? +1 : -1   int8
//   count     = #{r : eps[r] >= 0}      int32, left on the device
// The TPU wrapper padded d to 128 lanes and n to the tile and took the
// padded rows back out of the count; here the ragged edge is masked, so the
// outputs are the same without padding.
//
// What bounds it: device-memory bytes. Each row is read once (d · 4 bytes
// at f32) for 5 bytes written, about 2 operations per byte read, far below
// the card's ratio of operations to bytes. The design reads F once with
// loads as wide as the alignment allows (`row_dot.cuh`); w is staged in
// shared memory once per block. The count is reduced in the warp
// (__reduce_add_sync), then in the block, and each block adds its total with
// one integer atomic, so it is exact and the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "row_dot.cuh"

namespace {

using rowdot::kThreads;

template <typename T, int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads)
eps_affine_kernel(const T* __restrict__ F, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ eps,
                  int8_t* __restrict__ labels, int32_t* __restrict__ count,
                  int64_t n, int d) {
  extern __shared__ float w_s[];
  __shared__ int32_t warp_pos[kThreads / 32];
  for (int j = threadIdx.x; j < d; j += kThreads) w_s[j] = w[j];
  __syncthreads();

  constexpr int kGroups = kThreads / LANES;   // rows in flight per block
  const int group = threadIdx.x / LANES;
  const int sub = threadIdx.x % LANES;
  const float bv = *b;
  int32_t pos = 0;
  // block-uniform loop: every lane reaches the shuffles in group_sum
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kGroups; base < n;
       base += static_cast<int64_t>(gridDim.x) * kGroups) {
    const int64_t r = base + group;
    const bool live = r < n;
    float acc = live ? rowdot::partial_dot<T, LANES, VEC>(F + r * d, w_s, d,
                                                          sub)
                     : 0.f;
    acc = rowdot::group_sum<LANES>(acc);
    if (live && sub == 0) {
      const float e = acc - bv;
      const bool p = e >= 0.f;
      eps[r] = e;
      labels[r] = p ? int8_t(1) : int8_t(-1);
      pos += p;
    }
  }
  pos = __reduce_add_sync(0xffffffffu, pos);
  if ((threadIdx.x & 31) == 0) warp_pos[threadIdx.x >> 5] = pos;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t total = 0;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_pos[i];
    if (total) atomicAdd(count, total);
  }
}

template <typename T>
cudaError_t launch(const void* F, const void* w, const void* b, void* eps,
                   void* labels, void* count, int64_t n, int d,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  return rowdot::with_row_layout<T>(F, d, [&](auto lanes, auto vec) {
    constexpr int kLanes = decltype(lanes)::value;
    constexpr bool kVec = decltype(vec)::value;
    auto kernel = eps_affine_kernel<T, kLanes, kVec>;
    cudaError_t e = rowdot::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<rowdot::grid_for(n, kLanes), kThreads, smem, stream>>>(
        static_cast<const T*>(F), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(eps),
        static_cast<int8_t*>(labels), static_cast<int32_t*>(count), n, d);
    return cudaGetLastError();
  });
}

}  // namespace

// Plain C entry for ctypes. Every pointer is a device pointer; `stream` is
// a cudaStream_t; `bf16` says F holds bf16 (else f32). Zeroes `count`,
// launches asynchronously and returns the first CUDA error, or 0.
extern "C" int eps_affine(const void* F, const void* w, const void* b,
                          void* eps, void* labels, void* count, int64_t n,
                          int d, int bf16, void* stream) {
  if (n < 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = bf16 ? launch<__nv_bfloat16>(F, w, b, eps, labels, count, n, d, s)
           : launch<float>(F, w, b, eps, labels, count, n, d, s);
  return static_cast<int>(e);
}

extern "C" const char* eps_affine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
