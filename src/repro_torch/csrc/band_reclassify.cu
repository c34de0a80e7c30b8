// Union-band relabel for k one-vs-all views over ONE shared scratch table,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `multiview_band_reclassify` / `_mv_band_kernel`
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

#include <cuda_runtime.h>

#include <cstdint>

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

extern "C" const char* band_reclassify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
