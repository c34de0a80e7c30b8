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
// What bounds it: device-memory bytes. A row of F in the union of the
// windows is d * 4 bytes read for about 2 * d operations a view covering
// it, far below the card's ratio of operations to bytes, so the least
// traffic is each row of the union read once. The k-view engine orders
// the table by min_v |eps_v|, so every window is a small window near the
// front and the windows overlap: the TPU grid streamed all `cap` rows of
// every window, and this kernel's first design (one warp a row, grid
// (cap / 8 capped at 1024, k), scalar 4-byte loads, each window on its
// own) read a row once for each window holding it and launched about
// seven waves of blocks of which almost all exited at once. It no longer
// does any of that:
//  * One pass over the union. Each block first builds the union's
//    segments in one warp (a prologue, no second launch and no host round
//    trip: the windows exist only on the device): the 2k window endpoints
//    sorted, the segments between neighbours that some window covers, each
//    with its bitmask of covering views (so k <= 64) and the prefix sum of
//    the segment lengths. The other warps meanwhile stage all of W (k * d
//    fp32) and b in shared memory. Blocks then walk the union as one flat
//    range of rows, a flat row mapped to its segment by a binary search
//    over the prefix sums; each row is read once and dotted with every
//    view whose window covers it.
//  * A grid of at most one wave (132 SMs x 2 resident blocks, fewer where
//    W fills shared memory), chosen on the host from (k, d, cap) without
//    reading the widths (`multiview_plan` in
//    kernels/band_reclassify/kernel.py); blocks stride over the union and
//    a block past its end exits after the prologue.
//  * The row's loads all in flight (`row_dot.cuh`, as the single-view
//    kernel below): chunks as wide as the row pitch and F's address allow
//    (8 bytes at d = 54), `lanes` lanes a row, each lane issuing every load
//    of its share of the row before any fmaf. Then, for each view in the
//    segment's mask (the OR over the warp's rows, so that the shuffles stay
//    warp-uniform; over the block's rows where a row spans warps), the lane's
//    fmafs against W[v] read from shared memory, a sum over the row's
//    lanes, and one int8 store where the row's own mask holds the view.
// Bulk copies or TMA for F are not used: the band is small on the path,
// and the single-view kernel found in-flight loads best for small bands.
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

#include <climits>
#include <cstdint>

#include "row_dot.cuh"

namespace {

constexpr int kMvThreads = 256;
constexpr int kMvWarps = kMvThreads / 32;
constexpr int kMvMaxViews = 64;         // a segment's views fit one uint64
constexpr int kMvLoads = 8;             // chunks a lane loads before its fmafs
constexpr int kMaxSmem = 232448;        // shared memory a block can use
constexpr size_t kDefaultSmem = 48 * 1024;

// Dynamic shared memory of the multi-view kernel, in this order: W (k * d
// f32, padded to 16 bytes), segment masks (2k uint64), b (k f32), segment
// starts (2k), segment prefix sums (2k + 1), window starts and ends (k
// each), endpoints and sorted endpoints (2k each), and [segments, union
// rows]; int32 unless said. `multiview_plan` computes the same.
__host__ __device__ constexpr int64_t mv_smem_bytes(int k, int d) {
  return (static_cast<int64_t>(k) * d * 4 + 15) / 16 * 16 + 16 * k +
         4 * (11 * k + 3);
}

// acc + chunk · w, w read from shared memory as wide as the chunk
template <int BYTES>
__device__ __forceinline__ float mv_chunk_fma(
    typename rowdot::Raw<BYTES>::type v, const float* w, float acc) {
  if constexpr (BYTES == 16) {
    return rowdot::chunk_fma_w4<float, 16>(v, w, acc);
  } else if constexpr (BYTES == 8) {
    const float2 t = *reinterpret_cast<const float2*>(w);
    const float wl[2] = {t.x, t.y};
    return rowdot::chunk_fma<float, 8>(v, wl, acc);
  } else {
    return rowdot::chunk_fma<float, 4>(v, w, acc);
  }
}

template <int BYTES>
__global__ void __launch_bounds__(kMvThreads, 2)
mv_band_reclassify_kernel(const float* __restrict__ F,
                          int8_t* __restrict__ labels,
                          const float* __restrict__ W,
                          const float* __restrict__ b,
                          const int32_t* __restrict__ start_blocks,
                          const int32_t* __restrict__ widths, int64_t n,
                          int d, int k, int block_n, int lanes) {
  using Raw = typename rowdot::Raw<BYTES>::type;
  constexpr int kE = BYTES / 4;                 // floats a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float row_part[kMvWarps];
  __shared__ unsigned long long block_mask;
  const int k2 = 2 * k;
  float* w_s = reinterpret_cast<float*>(smem);
  uint64_t* seg_mask = reinterpret_cast<uint64_t*>(
      smem + (static_cast<int64_t>(k) * d * 4 + 15) / 16 * 16);
  float* b_s = reinterpret_cast<float*>(seg_mask + k2);
  int* seg_lo = reinterpret_cast<int*>(b_s + k);
  int* seg_pre = seg_lo + k2;                   // 2k + 1 entries
  int* win_lo = seg_pre + k2 + 1;
  int* win_hi = win_lo + k;
  int* pts = win_hi + k;
  int* srt = pts + k2;
  int* head = srt + k2;                         // [segments, union rows]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr unsigned kAll = 0xffffffffu;

  if (warp == 0) {
    // the segments of the union, built by one warp
    for (int v = lane; v < k; v += 32) {
      const int wd = widths[v];
      const int lo = start_blocks[v] * block_n;
      const int hi = lo + (wd > 0 ? wd : 0);
      win_lo[v] = lo;
      win_hi[v] = hi;
      pts[2 * v] = wd > 0 ? lo : INT_MAX;       // an empty window adds none
      pts[2 * v + 1] = wd > 0 ? hi : INT_MAX;
    }
    __syncwarp();
    for (int i = lane; i < k2; i += 32) {       // rank sort, ties by index
      const int p = pts[i];
      int r = 0;
      for (int j = 0; j < k2; ++j) {
        const int q = pts[j];
        r += q < p || (q == p && j < i);
      }
      srt[r] = p;
    }
    __syncwarp();
    int segs = 0, total = 0;
    for (int base = 0; base < k2 - 1; base += 32) {   // warp-uniform
      const int i = base + lane;
      uint64_t mask = 0;
      int lo = 0, len = 0;
      if (i < k2 - 1 && srt[i] < srt[i + 1]) {
        lo = srt[i];
        for (int v = 0; v < k; ++v)
          if (win_lo[v] <= lo && lo < win_hi[v]) mask |= 1ull << v;
        len = mask ? srt[i + 1] - lo : 0;
      }
      const unsigned keep = __ballot_sync(kAll, mask != 0);
      int x = len;                              // inclusive scan of lengths
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kAll, x, off);
        if (lane >= off) x += y;
      }
      if (mask) {
        const int at = segs + __popc(keep & ((1u << lane) - 1));
        seg_lo[at] = lo;
        seg_mask[at] = mask;
        seg_pre[at] = total + x - len;
      }
      total += __shfl_sync(kAll, x, 31);
      segs += __popc(keep);
    }
    if (lane == 0) {
      seg_pre[segs] = total;
      head[0] = segs;
      head[1] = total;
    }
  } else {
    for (int i = threadIdx.x - 32; i < k * d; i += kMvThreads - 32)
      w_s[i] = __ldg(W + i);
    for (int i = threadIdx.x - 32; i < k; i += kMvThreads - 32)
      b_s[i] = __ldg(b + i);
  }
  __syncthreads();

  const int segs = head[0];
  const int total = head[1];
  const int rows = kMvThreads / lanes;          // rows a block takes at once
  if (static_cast<int64_t>(blockIdx.x) * rows >= total) return;
  const int nv = d / kE;                        // chunks a row
  const int span = lanes * kMvLoads;            // chunks one pass covers
  const int passes = (nv + span - 1) / span;
  const int sub = threadIdx.x & (lanes - 1);
  const int group = threadIdx.x / lanes;
  // block-uniform loop: every thread reaches the shuffles and barriers
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * rows; base < total;
       base += static_cast<int64_t>(gridDim.x) * rows) {
    const int u = static_cast<int>(base) + group;   // flat union row
    const bool live = u < total;
    int s = 0;                                  // last segment starting <= u
    for (int hi = segs - 1; s < hi;) {
      const int mid = (s + hi + 1) >> 1;
      if (seg_pre[mid] <= u) s = mid; else hi = mid - 1;
    }
    const int64_t row = live ? seg_lo[s] + (u - seg_pre[s]) : 0;
    const unsigned long long mask = live ? seg_mask[s] : 0;
    const Raw* f = reinterpret_cast<const Raw*>(F + row * d);
    Raw v[kMvLoads];
    auto load = [&](int p) {
#pragma unroll
      for (int c = 0; c < kMvLoads; ++c) {      // every load, then the fmafs
        const int j = p * span + sub + c * lanes;
        v[c] = live && j < nv ? __ldg(f + j) : Raw{};
      }
    };
    load(0);
    uint64_t todo;                              // views, uniform over
    if (lanes <= 32) {                          // ... the warp's rows
      const unsigned lo = __reduce_or_sync(kAll, static_cast<unsigned>(mask));
      const unsigned hi =
          __reduce_or_sync(kAll, static_cast<unsigned>(mask >> 32));
      todo = (static_cast<uint64_t>(hi) << 32) | lo;
    } else {                                    // ... the block's rows
      if (threadIdx.x == 0) block_mask = 0;
      __syncthreads();
      if (sub == 0 && live) atomicOr(&block_mask, mask);
      __syncthreads();
      todo = block_mask;    // not empty: the view loop's barriers order
    }                       // this read before the next reset
    bool first = true;
    while (todo) {
      const int view = __ffsll(static_cast<long long>(todo)) - 1;
      todo &= todo - 1;
      const float* wv = w_s + view * d;
      float acc = 0.f;
      for (int p = 0; p < passes; ++p) {
        if (passes > 1 && (p > 0 || !first)) load(p);
#pragma unroll
        for (int c = 0; c < kMvLoads; ++c) {
          const int j = p * span + sub + c * lanes;
          if (j < nv) acc = mv_chunk_fma<BYTES>(v[c], wv + j * kE, acc);
        }
      }
      first = false;
      if (lanes <= 32) {
        acc = rowdot::group_sum(acc, lanes);
      } else {                                  // the row's warps, in order
        acc = rowdot::group_sum(acc, 32);
        if (lane == 0) row_part[warp] = acc;
        __syncthreads();
        if (sub == 0)
          for (int i = 1; i < lanes / 32; ++i) acc += row_part[warp + i];
        __syncthreads();
      }
      if (sub == 0 && (mask >> view & 1))
        labels[view * n + row] = (acc - b_s[view] >= 0.f) ? int8_t(1)
                                                          : int8_t(-1);
    }
  }
}

template <int BYTES>
cudaError_t launch_mv(const void* F, void* labels, const void* W,
                      const void* b, const void* start_blocks,
                      const void* widths, int64_t n, int d, int k,
                      int block_n, int lanes, int grid, int smem,
                      cudaStream_t stream) {
  if (smem > static_cast<int>(kDefaultSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        mv_band_reclassify_kernel<BYTES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  mv_band_reclassify_kernel<BYTES><<<grid, kMvThreads, smem, stream>>>(
      static_cast<const float*>(F), static_cast<int8_t*>(labels),
      static_cast<const float*>(W), static_cast<const float*>(b),
      static_cast<const int32_t*>(start_blocks),
      static_cast<const int32_t*>(widths), n, d, k, block_n, lanes);
  return cudaGetLastError();
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
// a cudaStream_t. The windows must lie inside the table (the wrapper
// aligns and clamps them). (chunk, lanes, grid, smem) is the host's plan
// (`multiview_plan`): chunk bytes dividing the row pitch and F's address,
// lanes a power of two up to 256, smem the kernel's layout for (k, d); a
// plan the kernel cannot run returns cudaErrorInvalidValue. Launches
// asynchronously (one launch, also when every window is empty) and returns
// cudaGetLastError().
extern "C" int mv_band_reclassify(const void* F, void* labels, const void* W,
                                  const void* b, const void* start_blocks,
                                  const void* widths, int64_t n, int d, int k,
                                  int block_n, int chunk, int lanes, int grid,
                                  int smem, void* stream) {
  const int64_t row_bytes = static_cast<int64_t>(d) * 4;
  if (d <= 0 || k < 1 || k > kMvMaxViews || n <= 0 || n > INT_MAX ||
      block_n <= 0 || (chunk != 4 && chunk != 8 && chunk != 16) ||
      row_bytes % chunk || reinterpret_cast<uintptr_t>(F) % chunk ||
      lanes < 1 || lanes > kMvThreads || (lanes & (lanes - 1)) ||
      grid < 1 || grid > kBandMaxGrid || smem != mv_smem_bytes(k, d) ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      chunk == 16  ? launch_mv<16>(F, labels, W, b, start_blocks, widths, n,
                                   d, k, block_n, lanes, grid, smem, s)
      : chunk == 8 ? launch_mv<8>(F, labels, W, b, start_blocks, widths, n,
                                  d, k, block_n, lanes, grid, smem, s)
                   : launch_mv<4>(F, labels, W, b, start_blocks, widths, n,
                                  d, k, block_n, lanes, grid, smem, s);
  return static_cast<int>(e);
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
