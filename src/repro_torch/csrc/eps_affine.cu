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
// the card's ratio of operations to bytes. So the design keeps as many
// bytes of F in flight as the card needs, at any row width:
//
//  * A persistent grid (one or two blocks an SM) walks tiles of R whole
//    rows, block i taking tiles i, i + grid, ... . R · d · sizeof(T) is a
//    multiple of 16 bytes, so each tile is ONE 1-D bulk copy
//    (cp.async.bulk, `hopper::bulk_load`) into a ring of shared-memory
//    stages (two of 32 KB by default), completing on an mbarrier. Forest's 216-byte rows then stream
//    like DBLife's 4 KB rows, with no per-lane load width to choose. The
//    plan (R, stages, grid, lanes) is computed on the host (`tile_plan` in
//    kernels/eps_affine/kernel.py) and checked again here.
//  * One producer warp (one elected lane) keeps the ring full; eight
//    consumer warps compute each row's dot from shared memory in fp32
//    (`row_dot.cuh`, groups of LANES lanes a row) and write eps and the
//    label, then free the stage. w is read into shared memory as fp32 by
//    the consumers while the first stages are already in flight.
//  * The rows past the last whole tile, and every row of a table whose
//    base address is not 16-byte aligned (a view such as F[1:]), are read
//    with ordinary loads by the consumer warps of the same kernel. This is
//    a code path of this kernel, not a fallback to the plain version.
//  * The count needs no memset launch: each block writes its total to its
//    own slot in `partial` (allocated by the wrapper, never zeroed); the
//    block that takes the last ticket of an atomic counter, after a
//    __threadfence, sums every slot and writes `count`, then sets the
//    ticket back to 0 for the next call on the stream (the wrapper keeps
//    one zeroed ticket per device and stream). Integer sums are exact, so
//    the count is the same on every run; each row's dot has a fixed order,
//    so eps is too. One device operation a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "row_dot.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;   // threads that compute
constexpr int kThreads = kConsumers + 32;         // and one producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxGrid = 1024;
// a block's shared memory, less 1 KB for the static arrays below
constexpr size_t kMaxSmem = 232448 - 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// This lane's share of dot(row, w_s) over d elements of T read in chunks of
// BYTES, lane `sub` of a group of LANES taking chunks sub, sub + LANES, ...
template <typename T, int BYTES, int LANES>
__device__ __forceinline__ float partial_dot(const void* row,
                                             const float* w_s, int d,
                                             int sub) {
  using Raw = typename rowdot::Raw<BYTES>::type;
  constexpr int kE = BYTES / static_cast<int>(sizeof(T));
  const Raw* f = static_cast<const Raw*>(row);
  float acc = 0.f;
#pragma unroll 4
  for (int j = sub; j < d / kE; j += LANES) {
    if constexpr (kE % 4 == 0)   // w_s is 16-byte aligned
      acc = rowdot::chunk_fma_w4<T, BYTES>(f[j], w_s + j * kE, acc);
    else
      acc = rowdot::chunk_fma<T, BYTES>(f[j], w_s + j * kE, acc);
  }
  return acc;
}

template <typename T, int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
eps_affine_kernel(const T* __restrict__ F, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ eps,
                  int8_t* __restrict__ labels, int32_t* __restrict__ partial,
                  uint32_t* __restrict__ ticket, int32_t* __restrict__ count,
                  int64_t n, int d, int rows_per_tile, int64_t tiles,
                  int stages) {
  // shared-memory rows are 16-byte chunks where the pitch allows
  constexpr int kBytes = VEC ? 16 : static_cast<int>(sizeof(T));
  constexpr int kGroups = kConsumers / LANES;   // rows at once
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];   // full, empty
  __shared__ int32_t warp_pos[kThreads / 32];
  __shared__ bool last;

  const int row_bytes = d * static_cast<int>(sizeof(T));
  const uint32_t tile_bytes = static_cast<uint32_t>(rows_per_tile) * row_bytes;
  float* w_s = reinterpret_cast<float*>(ring + stages * tile_bytes);
  const uint32_t ring_addr = hopper::smem_addr(ring);
  const uint32_t full0 = hopper::smem_addr(bars);
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // this block's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int64_t mine =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  int32_t pos = 0;
  if (warp == 0) {
    if (lane == 0) {                      // the producer
      const char* src = reinterpret_cast<const char*>(F);
      for (int64_t i = 0; i < mine; ++i) {
        const int s = static_cast<int>(i % stages);
        const uint32_t use = static_cast<uint32_t>(i / stages);
        if (use > 0) hopper::mbar_wait(empty0 + 8 * s, (use - 1) & 1);
        hopper::mbar_expect_tx(full0 + 8 * s, tile_bytes);
        const int64_t t = blockIdx.x + i * gridDim.x;
        hopper::bulk_load(ring_addr + s * tile_bytes, src + t * tile_bytes,
                          tile_bytes, full0 + 8 * s);
      }
    }
  } else {                                // the consumers
    const int c = threadIdx.x - 32;
    const int group = c / LANES;
    const int sub = c % LANES;
    for (int j = c; j < d; j += kConsumers) w_s[j] = w[j];
    consumers_sync();
    const float bv = *b;
    for (int64_t i = 0; i < mine; ++i) {
      const int s = static_cast<int>(i % stages);
      hopper::mbar_wait(full0 + 8 * s, static_cast<uint32_t>(i / stages) & 1);
      const unsigned char* tile = ring + s * tile_bytes;
      const int64_t row0 = (blockIdx.x + i * gridDim.x) * rows_per_tile;
      // warp-uniform loop: every lane reaches the shuffles in group_sum
      for (int r0 = 0; r0 < rows_per_tile; r0 += kGroups) {
        const int r = r0 + group;
        const bool live = r < rows_per_tile;
        float acc = live ? partial_dot<T, kBytes, LANES>(
                               tile + r * row_bytes, w_s, d, sub)
                         : 0.f;
        acc = rowdot::group_sum(acc, LANES);
        if (live && sub == 0) {
          const float e = acc - bv;
          eps[row0 + r] = e;
          labels[row0 + r] = e >= 0.f ? int8_t(1) : int8_t(-1);
          pos += e >= 0.f;
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * s);
    }
    // rows past the last whole tile (all rows when tiles == 0): ordinary
    // element loads straight from device memory
    for (int64_t base = tiles * rows_per_tile +
                        static_cast<int64_t>(blockIdx.x) * kGroups;
         base < n; base += static_cast<int64_t>(gridDim.x) * kGroups) {
      const int64_t r = base + group;
      const bool live = r < n;
      float acc = live ? partial_dot<T, sizeof(T), LANES>(F + r * d, w_s, d,
                                                          sub)
                       : 0.f;
      acc = rowdot::group_sum(acc, LANES);
      if (live && sub == 0) {
        const float e = acc - bv;
        eps[r] = e;
        labels[r] = e >= 0.f ? int8_t(1) : int8_t(-1);
        pos += e >= 0.f;
      }
    }
  }

  // the count: a slot per block, summed by the block that finishes last
  pos = __reduce_add_sync(0xffffffffu, pos);
  if (lane == 0) warp_pos[warp] = pos;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t total = 0;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_pos[i];
    partial[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && warp == 0) {
    __threadfence();
    int32_t sum = 0;
    for (int k = lane; k < static_cast<int>(gridDim.x); k += 32)
      sum += __ldcg(partial + k);
    sum = __reduce_add_sync(0xffffffffu, sum);
    if (lane == 0) {
      *count = sum;
      *ticket = 0;
    }
  }
}

template <typename T, int LANES, bool VEC>
cudaError_t launch_as(const void* F, const void* w, const void* b, void* eps,
                      void* labels, void* partial, void* ticket, void* count,
                      int64_t n, int d, int rows_per_tile, int64_t tiles,
                      int stages, int grid, size_t smem, cudaStream_t stream) {
  auto kernel = eps_affine_kernel<T, LANES, VEC>;
  // raise the kernel's shared-memory limit once per device, not per call:
  // the call is on the host-bound path of every naive update
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > kDefaultSmem && !raised[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(F), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(eps),
      static_cast<int8_t*>(labels), static_cast<int32_t*>(partial),
      static_cast<uint32_t*>(ticket), static_cast<int32_t*>(count), n, d,
      rows_per_tile, tiles, stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* F, const void* w, const void* b, void* eps,
                   void* labels, void* partial, void* ticket, void* count,
                   int64_t n, int d, int rows_per_tile, int stages, int grid,
                   int lanes, cudaStream_t stream) {
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const size_t tile_bytes = static_cast<size_t>(rows_per_tile) * row_bytes;
  const size_t smem = stages * tile_bytes + static_cast<size_t>(d) * 4;
  if (rows_per_tile <= 0 || tile_bytes % 16 || stages < 1 ||
      stages > kMaxStages || grid < 1 || grid > kMaxGrid || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(F) % 16 == 0;
  const int64_t tiles = aligned ? n / rows_per_tile : 0;
#define EPS_LAUNCH(L, V)                                                    \
  return launch_as<T, L, V>(F, w, b, eps, labels, partial, ticket, count, \
                            n, d, rows_per_tile, tiles, stages, grid, smem, \
                            stream)
  if (row_bytes % 16 == 0) {      // tile rows in 16-byte chunks
    switch (lanes) {
      case 32: EPS_LAUNCH(32, true);
      case 16: EPS_LAUNCH(16, true);
      case 8: EPS_LAUNCH(8, true);
      case 4: EPS_LAUNCH(4, true);
    }
  } else {
    switch (lanes) {
      case 32: EPS_LAUNCH(32, false);
      case 16: EPS_LAUNCH(16, false);
      case 8: EPS_LAUNCH(8, false);
      case 4: EPS_LAUNCH(4, false);
    }
  }
#undef EPS_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry for ctypes. Every pointer is a device pointer; `stream` is
// a cudaStream_t; `bf16` says F holds bf16 (else f32). `partial` holds
// `grid` int32 slots (any contents), `ticket` one uint32 that is 0 before
// the call and is 0 again after it. (rows_per_tile, stages, grid, lanes)
// is the host's tile plan; a plan this kernel cannot run returns
// cudaErrorInvalidValue. Launches once, asynchronously, and returns the
// first CUDA error, or 0.
extern "C" int eps_affine(const void* F, const void* w, const void* b,
                          void* eps, void* labels, void* count, void* partial,
                          void* ticket, int64_t n, int d, int bf16,
                          int rows_per_tile, int stages, int grid,
                          int lanes, void* stream) {
  if (n < 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(F, w, b, eps, labels, partial, ticket,
                                   count, n, d, rows_per_tile, stages, grid,
                                   lanes, s)
           : launch<float>(F, w, b, eps, labels, partial, ticket, count, n, d,
                           rows_per_tile, stages, grid, lanes, s);
  return static_cast<int>(e);
}

extern "C" const char* eps_affine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
