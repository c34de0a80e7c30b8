// Band relabel kernels, hand-written for Hopper (sm_90a): the union-band
// relabel for k one-vs-all views over ONE shared scratch table, and the
// single-view relabel of one window (at the end of this note).
//
// The multi-view kernel replaces the TPU kernel `multiview_band_reclassify` / `_mv_band_kernel`
// (src/repro/kernels/band_reclassify/kernel.py:34-93).
//
// What it computes: for each view v and each row r in
//   [start_blocks[v] * block_n, start_blocks[v] * block_n + widths[v])
// it sets labels[v, r] = (dot(F[r], W[v]) - b[v] >= 0) ? +1 : -1, with the
// dot accumulated in fp32 and b in fp32. No other label is touched: `labels`
// is updated IN PLACE (the TPU kernel aliased input and output to the same
// effect).
//
// What bounds it: device-memory bytes. Each in-band row of F is read once
// (d * 4 bytes) for one int8 written, about 2 operations per byte read, far
// below the card's ratio of operations to bytes. So the design reads only
// in-band rows: the TPU grid streamed all `cap` rows of every view's window
// and masked the write; here a block whose first row is past widths[v]
// exits before it loads anything, and the traffic scales with
// sum_v widths[v], not with k * cap.
//
// Layout: grid (row tiles, k), 256 threads = 8 warps per block, one warp
// per row. Lanes stride over d, so neighbouring lanes read neighbouring
// floats; the row is reduced with __shfl_xor_sync and lane 0 stores the
// int8. W[v] is staged in shared memory once per block. Rows are only
// 4-byte aligned in general (d = 54 gives 216-byte rows), so loads are
// scalar floats, never 16-byte vectors. The grid is capped per view and
// warps stride over the window, so a wide window needs no more blocks.
// TMA, a persistent grid and one pass over the union of all k windows are
// left for later work.
//
// The single-view kernel `band_reclassify` below replaces the TPU kernel
// `band_reclassify` / `_band_kernel` (kernel.py:20-31, :96-127), the paper's
// incremental step. It computes what a k = 1 launch of the multi-view kernel
// computes, labels[r] = (dot(F[r], w) - b >= 0) ? +1 : -1 in place for the
// rows of one window, with two differences: the window is given in rows
// ([start_row, start_row + width), no tile alignment), so the banded step
// relabels exactly the rows of its Lemma 3.1 band; and F may be f32 or bf16,
// read through `row_dot.cuh` (lanes per row chosen from d, 16-byte loads
// where the alignment allows). The host knows the window when it launches,
// so the grid covers the band and no block lies past it. Its accumulation
// order differs from the multi-view kernel's, so the two agree up to fp32
// ties at the boundary (z within rounding of 0).

#include <cuda_runtime.h>

#include <cstdint>

#include "row_dot.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTilesPerView = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
mv_band_reclassify_kernel(const float* __restrict__ F,
                          int8_t* __restrict__ labels,
                          const float* __restrict__ W,
                          const float* __restrict__ b,
                          const int32_t* __restrict__ start_blocks,
                          const int32_t* __restrict__ widths,
                          int64_t n, int d, int block_n) {
  extern __shared__ float w_s[];
  const int v = blockIdx.y;
  const int width = widths[v];
  const int first = blockIdx.x * kWarps;
  if (first >= width) return;  // the whole tile lies past the band

  const float* w = W + static_cast<int64_t>(v) * d;
  for (int j = threadIdx.x; j < d; j += kThreads) w_s[j] = w[j];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float bv = b[v];
  const int64_t base = static_cast<int64_t>(start_blocks[v]) * block_n;
  int8_t* lab = labels + static_cast<int64_t>(v) * n;
  const int stride = gridDim.x * kWarps;
  for (int r = first + warp; r < width; r += stride) {
    const int64_t row = base + r;
    if (row >= n) break;  // the wrapper clamps windows; never taken
    const float* f = F + row * d;
    float acc = 0.f;
    for (int j = lane; j < d; j += 32) acc = fmaf(f[j], w_s[j], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) lab[row] = (acc - bv >= 0.f) ? int8_t(1) : int8_t(-1);
  }
}

template <typename T, int LANES, bool VEC>
__global__ void __launch_bounds__(rowdot::kThreads)
band_reclassify_kernel(const T* __restrict__ F, int8_t* __restrict__ labels,
                       const float* __restrict__ w,
                       const float* __restrict__ b, int64_t start_row,
                       int64_t width, int d) {
  extern __shared__ float w_s[];
  for (int j = threadIdx.x; j < d; j += rowdot::kThreads) w_s[j] = w[j];
  __syncthreads();

  constexpr int kGroups = rowdot::kThreads / LANES;
  const int group = threadIdx.x / LANES;
  const int sub = threadIdx.x % LANES;
  const float bv = *b;
  // block-uniform loop: every lane reaches the shuffles in group_sum
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kGroups;
       base < width; base += static_cast<int64_t>(gridDim.x) * kGroups) {
    const int64_t r = start_row + base + group;
    const bool live = base + group < width;
    float acc = live ? rowdot::partial_dot<T, LANES, VEC>(F + r * d, w_s, d,
                                                          sub)
                     : 0.f;
    acc = rowdot::group_sum<LANES>(acc);
    if (live && sub == 0)
      labels[r] = (acc - bv >= 0.f) ? int8_t(1) : int8_t(-1);
  }
}

template <typename T>
cudaError_t launch_band(const void* F, void* labels, const void* w,
                        const void* b, int64_t start_row, int64_t width,
                        int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  return rowdot::with_row_layout<T>(F, d, [&](auto lanes, auto vec) {
    constexpr int kLanes = decltype(lanes)::value;
    constexpr bool kVec = decltype(vec)::value;
    auto kernel = band_reclassify_kernel<T, kLanes, kVec>;
    cudaError_t e = rowdot::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<rowdot::grid_for(width, kLanes), rowdot::kThreads, smem,
             stream>>>(static_cast<const T*>(F),
                       static_cast<int8_t*>(labels),
                       static_cast<const float*>(w),
                       static_cast<const float*>(b), start_row, width, d);
    return cudaGetLastError();
  });
}

}  // namespace

// Plain C entry for ctypes. Every pointer is a device pointer; `stream` is
// a cudaStream_t. Launches asynchronously and returns cudaGetLastError().
extern "C" int mv_band_reclassify(const void* F, void* labels, const void* W,
                                  const void* b, const void* start_blocks,
                                  const void* widths, int64_t n, int d, int k,
                                  int cap, int block_n, void* stream) {
  if (k <= 0 || cap <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        mv_band_reclassify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int tiles = (cap + kWarps - 1) / kWarps;
  if (tiles > kMaxTilesPerView) tiles = kMaxTilesPerView;
  const dim3 grid(tiles, k);
  mv_band_reclassify_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(F), static_cast<int8_t*>(labels),
      static_cast<const float*>(W), static_cast<const float*>(b),
      static_cast<const int32_t*>(start_blocks),
      static_cast<const int32_t*>(widths), n, d, block_n);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry for ctypes: relabel rows [start_row, start_row + width) of
// `labels` (n,) int8 in place under (w, b). Pointers are device pointers, b
// a () f32 scalar on the device, `bf16` says F holds bf16 (else f32).
// Launches asynchronously (one launch, also for an empty window) and
// returns cudaGetLastError().
extern "C" int band_reclassify(const void* F, void* labels, const void* w,
                               const void* b, int64_t start_row,
                               int64_t width, int64_t n, int d, int bf16,
                               void* stream) {
  if (d <= 0 || start_row < 0 || width < 0 || start_row + width > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_band<__nv_bfloat16>(F, labels, w, b, start_row, width, d,
                                        s)
           : launch_band<float>(F, labels, w, b, start_row, width, d, s);
  return static_cast<int>(e);
}

extern "C" const char* band_reclassify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
