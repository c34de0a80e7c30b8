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
// relabels exactly the rows of its Lemma 3.1 band; and F may be f32 or bf16.
// Its accumulation order differs from the multi-view kernel's, so the two
// agree up to fp32 ties at the boundary (z within rounding of 0).
//
// The band is small (about 1,000 rows on the DBLife path, 1,937 at most),
// so its time is latency, not streaming: the design puts the whole band in
// flight at once.
//  * A row is read in chunks of 16 bytes where its pitch and the table's
//    base allow (8, 4, or 2 for bf16, otherwise). `lanes` lanes share a row
//    (a power of two; more than 32, for Citeseer's 16 KB rows, sum their
//    warps through shared memory), each lane taking at most kK chunks, so
//    that it issues every load of its share of the row into registers
//    before its first fmaf: 8 loads of 16 bytes a lane at d = 1024 f32.
//  * w is not staged in shared memory and nothing waits on a
//    __syncthreads before the first load of F: each lane reads its own
//    columns of w once into registers (the same for every row it takes),
//    issued behind its first row's loads of F.
//  * The host (`band_plan` in kernels/band_reclassify/kernel.py) picks the
//    chunk, the lanes and a grid of at most one wave (132 SMs x 2 resident
//    blocks), so a band of up to one wave is in flight at once; a wider
//    band loops. A row too wide for kK chunks a lane (never on the
//    paths served) is read in several such passes, w reloaded each pass.

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

constexpr int kBandThreads = 256;
constexpr int kBandMaxGrid = 65535;

// chunks a lane loads before its arithmetic: at most 8, and at most 32
// floats of w held in registers
template <typename T, int BYTES>
__host__ __device__ constexpr int band_loads() {
  return 32 / (BYTES / static_cast<int>(sizeof(T))) < 8
             ? 32 / (BYTES / static_cast<int>(sizeof(T)))
             : 8;
}

template <typename T, int BYTES>
__global__ void __launch_bounds__(kBandThreads, 2)
band_reclassify_kernel(const T* __restrict__ F, int8_t* __restrict__ labels,
                       const float* __restrict__ w,
                       const float* __restrict__ b, int64_t start_row,
                       int64_t width, int d, int lanes) {
  using Raw = typename rowdot::Raw<BYTES>::type;
  constexpr int kE = BYTES / static_cast<int>(sizeof(T));   // elements
  constexpr int kK = band_loads<T, BYTES>();
  __shared__ float row_part[kBandThreads / 32];
  const int nv = d / kE;                    // chunks a row
  const int span = lanes * kK;              // chunks one pass covers
  const int passes = (nv + span - 1) / span;
  const int sub = threadIdx.x & (lanes - 1);
  const int group = threadIdx.x / lanes;
  const int rows = kBandThreads / lanes;    // rows a block takes at once
  const int warp = threadIdx.x >> 5;

  float wr[kK * kE];                        // this lane's columns of w
  // w in loads as wide as a chunk's fp32 columns and w's address allow
  constexpr int kWv = kE % 4 == 0 ? 4 : kE % 2 == 0 ? 2 : 1;
  const bool w_vec = reinterpret_cast<uintptr_t>(w) % (4 * kWv) == 0;
  auto load_w = [&](int c0) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int j = c0 + sub + k * lanes;
      const float* wj = w + j * kE;
#pragma unroll
      for (int e = 0; e < kE; e += kWv) {
        float* o = wr + k * kE + e;
        if (j >= nv) {
#pragma unroll
          for (int q = 0; q < kWv; ++q) o[q] = 0.f;
        } else if constexpr (kWv == 4) {
          const float4 v = w_vec ? __ldg(reinterpret_cast<const float4*>(wj + e))
                                 : make_float4(__ldg(wj + e), __ldg(wj + e + 1),
                                               __ldg(wj + e + 2),
                                               __ldg(wj + e + 3));
          o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
        } else if constexpr (kWv == 2) {
          const float2 v = w_vec ? __ldg(reinterpret_cast<const float2*>(wj + e))
                                 : make_float2(__ldg(wj + e), __ldg(wj + e + 1));
          o[0] = v.x, o[1] = v.y;
        } else {
          o[0] = __ldg(wj + e);
        }
      }
    }
  };
  const float bv = __ldg(b);
  bool w_loaded = false;
  // block-uniform loop: every thread reaches the shuffles and barriers
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * rows; base < width;
       base += static_cast<int64_t>(gridDim.x) * rows) {
    const int64_t r = base + group;
    const bool live = r < width;
    const Raw* f =
        reinterpret_cast<const Raw*>(F + (start_row + (live ? r : 0)) * d);
    float acc = 0.f;
    for (int p = 0; p < passes; ++p) {
      const int c0 = p * span;
      Raw v[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) {        // every load, then the fmafs
        const int j = c0 + sub + k * lanes;
        v[k] = live && j < nv ? __ldg(f + j) : Raw{};
      }
      if (passes > 1 || !w_loaded) {        // w behind the first F loads
        load_w(c0);
        w_loaded = true;
      }
#pragma unroll
      for (int k = 0; k < kK; ++k)
        acc = rowdot::chunk_fma<T, BYTES>(v[k], wr + k * kE, acc);
    }
    if (lanes <= 32) {
      acc = rowdot::group_sum(acc, lanes);
    } else {                                // the row's warps, in order
      acc = rowdot::group_sum(acc, 32);
      if ((threadIdx.x & 31) == 0) row_part[warp] = acc;
      __syncthreads();
      if (sub == 0)
        for (int i = 1; i < lanes / 32; ++i) acc += row_part[warp + i];
      __syncthreads();
    }
    if (live && sub == 0)
      labels[start_row + r] = (acc - bv >= 0.f) ? int8_t(1) : int8_t(-1);
  }
}

template <typename T, int BYTES>
cudaError_t launch_band(const void* F, void* labels, const void* w,
                        const void* b, int64_t start_row, int64_t width,
                        int d, int lanes, int grid, cudaStream_t stream) {
  band_reclassify_kernel<T, BYTES><<<grid, kBandThreads, 0, stream>>>(
      static_cast<const T*>(F), static_cast<int8_t*>(labels),
      static_cast<const float*>(w), static_cast<const float*>(b), start_row,
      width, d, lanes);
  return cudaGetLastError();
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
// (chunk, lanes, grid) is the host's band plan: chunk bytes dividing the
// row pitch and F's address, lanes a power of two up to 256; a plan the
// kernel cannot run returns cudaErrorInvalidValue. Launches asynchronously
// (one launch, also for an empty window) and returns cudaGetLastError().
extern "C" int band_reclassify(const void* F, void* labels, const void* w,
                               const void* b, int64_t start_row,
                               int64_t width, int64_t n, int d, int bf16,
                               int chunk, int lanes, int grid,
                               void* stream) {
  const int size = bf16 ? 2 : 4;
  const int64_t row_bytes = static_cast<int64_t>(d) * size;
  if (d <= 0 || start_row < 0 || width < 0 || start_row + width > n ||
      chunk < size || chunk > 16 || (chunk & (chunk - 1)) ||
      row_bytes % chunk || reinterpret_cast<uintptr_t>(F) % chunk ||
      lanes < 1 || lanes > kBandThreads || (lanes & (lanes - 1)) ||
      grid < 1 || grid > kBandMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16) {
    using B = __nv_bfloat16;
    e = chunk == 16  ? launch_band<B, 16>(F, labels, w, b, start_row, width,
                                          d, lanes, grid, s)
        : chunk == 8 ? launch_band<B, 8>(F, labels, w, b, start_row, width,
                                         d, lanes, grid, s)
        : chunk == 4 ? launch_band<B, 4>(F, labels, w, b, start_row, width,
                                         d, lanes, grid, s)
                     : launch_band<B, 2>(F, labels, w, b, start_row, width,
                                         d, lanes, grid, s);
  } else {
    e = chunk == 16  ? launch_band<float, 16>(F, labels, w, b, start_row,
                                              width, d, lanes, grid, s)
        : chunk == 8 ? launch_band<float, 8>(F, labels, w, b, start_row,
                                             width, d, lanes, grid, s)
                     : launch_band<float, 4>(F, labels, w, b, start_row,
                                             width, d, lanes, grid, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* band_reclassify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
