// One row of F dotted with a model vector, shared by the single-view
// kernels (`eps_affine.cu`, `band_reclassify` in `band_reclassify.cu`).
//
// A group of LANES consecutive lanes of a warp works on one row: lane `sub`
// accumulates elements sub, sub + LANES, ... in fp32 with fmaf, and the
// group is summed with __shfl_xor_sync. LANES is chosen from the row width
// so that a narrow row (Forest's 54 floats) does not leave most of a warp
// idle. Where the row pitch and the pointer are 16-byte aligned (d a
// multiple of 4 floats or 8 bf16, which d = 1024 and 4096 are), each lane
// loads 16 bytes at a time; otherwise loads are scalar, since a 216-byte
// row (d = 54) is only 4-byte aligned. The model vector sits in shared
// memory as fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace rowdot {

constexpr int kThreads = 256;            // threads per block
constexpr int kMaxBlocks = 4096;         // grid cap; blocks stride over rows
constexpr size_t kDefaultSmem = 48 * 1024;

// One 16-byte load of T: kN elements, and their fmaf into acc in element
// order, unpacked from the register words (no local array).
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ float fma(uint4 v, const float* w,
                                              float acc) {
    acc = fmaf(__uint_as_float(v.x), w[0], acc);
    acc = fmaf(__uint_as_float(v.y), w[1], acc);
    acc = fmaf(__uint_as_float(v.z), w[2], acc);
    return fmaf(__uint_as_float(v.w), w[3], acc);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bf16 is the high half of an f32: the low element of a word is
  // word << 16, the high one word & 0xffff0000 (exact)
  static __device__ __forceinline__ float fma2(unsigned u, const float* w,
                                               float acc) {
    acc = fmaf(__uint_as_float(u << 16), w[0], acc);
    return fmaf(__uint_as_float(u & 0xffff0000u), w[1], acc);
  }
  static __device__ __forceinline__ float fma(uint4 v, const float* w,
                                              float acc) {
    acc = fma2(v.x, w, acc);
    acc = fma2(v.y, w + 2, acc);
    acc = fma2(v.z, w + 4, acc);
    return fma2(v.w, w + 6, acc);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// This lane's share of dot(f, w_s) over a row of d elements.
template <typename T, int LANES, bool VEC>
__device__ __forceinline__ float partial_dot(const T* __restrict__ f,
                                             const float* w_s, int d,
                                             int sub) {
  float acc = 0.f;
  if constexpr (VEC) {
    constexpr int kN = Vec16<T>::kN;
    const uint4* fv = reinterpret_cast<const uint4*>(f);
    const int nv = d / kN;
    for (int j = sub; j < nv; j += LANES)
      acc = Vec16<T>::fma(__ldg(fv + j), w_s + j * kN, acc);
  } else {
    for (int j = sub; j < d; j += LANES) acc = fmaf(to_f32(f[j]), w_s[j], acc);
  }
  return acc;
}

// Sum over the LANES-aligned group of lanes. Every lane of the warp must
// call it (full shuffle mask): callers keep their loops warp-uniform.
template <int LANES>
__device__ __forceinline__ float group_sum(float acc) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Blocks for `rows` rows at LANES lanes a row: at least 1, at most
// kMaxBlocks.
inline unsigned grid_for(int64_t rows, int lanes) {
  const int64_t per_block = kThreads / lanes;
  int64_t blocks = (rows + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

// Picks LANES and VEC for rows of d elements of T at pointer F and calls
// launch(integral_constant<int, LANES>, bool_constant<VEC>).
template <typename T, typename Launch>
cudaError_t with_row_layout(const void* F, int d, Launch&& launch) {
  using std::integral_constant;
  constexpr int kN = Vec16<T>::kN;
  const bool vec =
      d % kN == 0 && reinterpret_cast<uintptr_t>(F) % 16 == 0;
  const int dv = vec ? d / kN : d;
  const int lanes = dv >= 128 ? 32 : dv >= 64 ? 16 : dv >= 16 ? 8 : 4;
  if (vec) {
    switch (lanes) {
      case 32: return launch(integral_constant<int, 32>{}, std::true_type{});
      case 16: return launch(integral_constant<int, 16>{}, std::true_type{});
      case 8: return launch(integral_constant<int, 8>{}, std::true_type{});
      default: return launch(integral_constant<int, 4>{}, std::true_type{});
    }
  }
  switch (lanes) {
    case 32: return launch(integral_constant<int, 32>{}, std::false_type{});
    case 16: return launch(integral_constant<int, 16>{}, std::false_type{});
    case 8: return launch(integral_constant<int, 8>{}, std::false_type{});
    default: return launch(integral_constant<int, 4>{}, std::false_type{});
  }
}

// Lets `kernel` use d floats of dynamic shared memory past the default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace rowdot
