// RWKV-6 chunked WKV recurrence; hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `wkv6` / `_wkv_kernel`
// (src/repro/kernels/wkv6/kernel.py:28-92) and its padding, transposing
// wrapper (src/repro/kernels/wkv6/ops.py): the time mix of every prefill of
// the ssm family (`models/rwkv6.py` time_mix, rwkv6-3b).
//
// What it computes, for r/k/v/la (b, s, H, K) f32 and u (H, K) f32, per
// (batch row, head), from a zero K x K state S, chunk by chunk of CH rows
// from position 0 (a = cumsum(la) within the chunk, a_prev = a − la):
//   o     = (r ⊙ e^{a_prev}) S
//         + tril₋₁[(r ⊙ e^{clip(a_prev)}) (k ⊙ e^{clip(−a)})ᵀ] v
//         + (Σ_j r ⊙ u ⊙ k) v
//   S    <- diag(e^{a_last}) S + (k ⊙ e^{a_last − a})ᵀ v
// with clip to ±40, all in f32, as the TPU kernel does; out (b, s, H, K)
// f32. The clip makes the result depend on where the chunks start, so the
// chunking is the TPU kernel's own: CH rows from position 0, a ragged last
// chunk zero-filled (la = 0 neither decays nor adds, exactly the TPU
// wrapper's padding), and a sequence shorter than CH one chunk of s rows.
//
// Layout: one block per (head, batch row) walks its chunks in order, the
// state in shared memory across them (the TPU grid's sequential chunk axis
// becomes the loop). The operands are read in the model layout through
// their strides (a row is K contiguous floats), so no transposed or padded
// copy is made. Each chunk's four tiles arrive by cp.async; the next
// chunk's tiles are in flight while the block multiplies on the current
// one. Per chunk: a column scan gives a (one thread per channel, in order),
// an elementwise pass forms the four scaled tiles and the bonus
// coefficients, then three products on the CUDA cores with 4 x 4 register
// tiles: the strictly lower triangle of the c x c attention (the upper one
// is skipped, not multiplied by 0), the output, and the state update.
//
// What bounds it: at rwkv6-3b's prefill (b 8, s 2048, 48 heads, K 64,
// chunk 64) a launch reads 805 MB and writes 201 MB, and does 19.2 GFLOP
// on the triangle it needs: bytes and operations within 5% of each other.
// Everything stays in f32 on the CUDA cores: clip lets k ⊙ e^{clip(−a)}
// reach e^40, past what TF32 or bf16 tensor cores would keep within the
// reference's tolerance. 384 blocks of 192 KB shared memory fill the card
// in three waves; a chunk-parallel split and the tensor cores are later
// work.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kClip = 40.f;

// Offsets (in floats) of the shared-memory arrays for CH-row chunks of
// K-wide heads. Tiles are (CH, K) at pitch K + 4: 16-byte aligned rows,
// and the eight rows that a quarter warp reads with float4 loads fall in
// distinct banks.
template <int CH, int K>
struct Smem {
  static constexpr int P = K + 4;          // pitch of a (rows, K) tile
  static constexpr int PA = CH + 4;        // pitch of the (CH, CH) tile
  static constexpr int kTile = CH * P;
  static constexpr int r = 0;              // raw r, k, la of this chunk
  static constexpr int k = r + kTile;
  static constexpr int la = k + kTile;     // la, then a_prev
  static constexpr int v = la + kTile;     // v, two stages
  static constexpr int rs = v + 2 * kTile;   // r ⊙ e^{a_prev}
  static constexpr int rf = rs + kTile;    // r ⊙ e^{clip(a_prev)}
  static constexpr int kf = rf + kTile;    // k ⊙ e^{clip(−a)}
  static constexpr int kd = kf + kTile;    // a, then k ⊙ e^{a_last − a}
  static constexpr int S = kd + kTile;     // the state, (K, K) at pitch P
  static constexpr int att = S + K * P;    // (CH, CH) at pitch PA
  static constexpr int u = att + CH * PA;
  static constexpr int alast = u + K;      // a_last
  static constexpr int decay = alast + K;  // e^{a_last}
  static constexpr int beta = decay + K;   // Σ_j r u k per row
  static constexpr int total = beta + CH;
  static constexpr size_t bytes = total * sizeof(float);
};

using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;

// async copy of rows [0, valid) of a (CH, K) tile to pitch K + 4; the
// other rows are zero-filled
template <int CH, int K>
__device__ __forceinline__ void copy_tile(float* dst,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int valid) {
  constexpr int kVec = K / 4;             // 16-byte vectors per row
  constexpr int kIters = (CH * kVec + kThreads - 1) / kThreads;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i >= CH * kVec) break;
    const int row = i / kVec;
    const int c = (i % kVec) * 4;
    const bool live = row < valid;
    cp_async16(dst + row * Smem<CH, K>::P + c,
               src + (live ? row : 0) * row_stride + c, live ? 16 : 0);
  }
}

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClip), kClip);
}

__device__ __forceinline__ float comp(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int CH, int K>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ la,
            const float* __restrict__ u, float* __restrict__ out, int s,
            int64_t rsb, int64_t rss, int64_t rsh, int64_t ksb, int64_t kss,
            int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t lsb,
            int64_t lss, int64_t lsh) {
  using L = Smem<CH, K>;
  constexpr int P = L::P;
  constexpr int PA = L::PA;
  constexpr int NB = CH / 4;              // 4-row blocks of a chunk
  constexpr int KB = K / 4;               // 4-column blocks of a head
  extern __shared__ __align__(16) float sm[];
  float* const r_s = sm + L::r;
  float* const k_s = sm + L::k;
  float* const la_s = sm + L::la;
  float* const rs_s = sm + L::rs;
  float* const rf_s = sm + L::rf;
  float* const kf_s = sm + L::kf;
  float* const kd_s = sm + L::kd;
  float* const S_s = sm + L::S;
  float* const att_s = sm + L::att;
  float* const u_s = sm + L::u;
  float* const alast_s = sm + L::alast;
  float* const decay_s = sm + L::decay;
  float* const beta_s = sm + L::beta;

  const int h = blockIdx.x;
  const int H = gridDim.x;
  const int64_t bi = blockIdx.y;
  const int tid = threadIdx.x;
  const float* rb = r + bi * rsb + h * rsh;
  const float* kb = k + bi * ksb + h * ksh;
  const float* vb = v + bi * vsb + h * vsh;
  const float* lb = la + bi * lsb + h * lsh;
  const int64_t os = static_cast<int64_t>(H) * K;     // out's row stride
  float* ob = out + (bi * s * H + h) * K;
  const int n_chunks = (s + CH - 1) / CH;

  auto issue = [&](int n) {               // chunk n's tiles in flight
    const int t0 = n * CH;
    const int valid = min(CH, s - t0);
    copy_tile<CH, K>(r_s, rb + t0 * rss, rss, valid);
    copy_tile<CH, K>(k_s, kb + t0 * kss, kss, valid);
    copy_tile<CH, K>(la_s, lb + t0 * lss, lss, valid);
    copy_tile<CH, K>(sm + L::v + (n & 1) * L::kTile, vb + t0 * vss, vss,
                     valid);
    cp_async_commit();
  };
  issue(0);
  for (int i = tid; i < K * P; i += kThreads) S_s[i] = 0.f;
  for (int j = tid; j < K; j += kThreads) u_s[j] = u[h * K + j];

  for (int n = 0; n < n_chunks; ++n) {
    const int t0 = n * CH;
    const float* v_s = sm + L::v + (n & 1) * L::kTile;
    cp_async_wait<0>();
    __syncthreads();

    // a = cumsum(la) per channel, in row order
    if (tid < K) {
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < CH; ++t) {
        const float l = la_s[t * P + tid];
        acc += l;
        la_s[t * P + tid] = acc - l;      // a_prev = a − la, as the TPU
        kd_s[t * P + tid] = acc;
      }
      alast_s[tid] = acc;
      decay_s[tid] = expf(acc);
    }
    __syncthreads();

    // the scaled tiles and the bonus coefficient of each row: TPR
    // consecutive threads share a row
    {
      constexpr int TPR = kThreads / CH;
      const int t = tid / TPR;
      const int q = tid % TPR;
      float bsum = 0.f;
#pragma unroll
      for (int m = 0; m < K / TPR; ++m) {
        const int j = q + TPR * m;
        const int e = t * P + j;
        const float rr = r_s[e];
        const float kk = k_s[e];
        const float ap = la_s[e];
        const float a = kd_s[e];
        rs_s[e] = rr * expf(ap);
        rf_s[e] = rr * expf(clip(ap));
        kf_s[e] = kk * expf(clip(-a));
        kd_s[e] = kk * expf(alast_s[j] - a);
        bsum += rr * u_s[j] * kk;
      }
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        bsum += __shfl_xor_sync(0xffffffffu, bsum, o);
      if (q == 0) beta_s[t] = bsum;
    }
    __syncthreads();
    if (n + 1 < n_chunks) issue(n + 1);   // raw r, k, la are free now

    // att = rf · kfᵀ on the 4 x 4 blocks on or below the diagonal,
    // enumerated row by row; the diagonal blocks' upper half is 0
    for (int p = tid; p < NB * (NB + 1) / 2; p += kThreads) {
      int R = 0;
      while ((R + 1) * (R + 2) / 2 <= p) ++R;
      const int C = p - R * (R + 1) / 2;
      float acc[4][4] = {};
#pragma unroll 4
      for (int j = 0; j < K; j += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          a[x] = ld4(rf_s + (4 * R + x) * P + j);
          b[x] = ld4(kf_s + (4 * C + x) * P + j);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            acc[x][y] = fmaf(a[x].x, b[y].x, acc[x][y]);
            acc[x][y] = fmaf(a[x].y, b[y].y, acc[x][y]);
            acc[x][y] = fmaf(a[x].z, b[y].z, acc[x][y]);
            acc[x][y] = fmaf(a[x].w, b[y].w, acc[x][y]);
          }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
          att_s[(4 * R + x) * PA + 4 * C + y] =
              4 * C + y < 4 * R + x ? acc[x][y] : 0.f;
    }
    __syncthreads();

    // o = rs · S + att · v + beta ⊙ v on 4 x 4 blocks; a block of rows
    // 4R .. 4R + 3 reads att columns 0 .. 4R + 3 only
    for (int p = tid; p < NB * KB; p += kThreads) {
      const int R = p / KB;
      const int C = p % KB;
      float inter[4][4] = {}, intra[4][4] = {};
#pragma unroll 2
      for (int j = 0; j < K; j += 4) {
        float4 a[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = ld4(rs_s + (4 * R + x) * P + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 sv = ld4(S_s + (j + jj) * P + 4 * C);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float w = comp(a[x], jj);
            inter[x][0] = fmaf(w, sv.x, inter[x][0]);
            inter[x][1] = fmaf(w, sv.y, inter[x][1]);
            inter[x][2] = fmaf(w, sv.z, inter[x][2]);
            inter[x][3] = fmaf(w, sv.w, inter[x][3]);
          }
        }
      }
      for (int i = 0; i < 4 * R + 4; i += 4) {
        float4 a[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = ld4(att_s + (4 * R + x) * PA + i);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float4 vv = ld4(v_s + (i + ii) * P + 4 * C);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float w = comp(a[x], ii);
            intra[x][0] = fmaf(w, vv.x, intra[x][0]);
            intra[x][1] = fmaf(w, vv.y, intra[x][1]);
            intra[x][2] = fmaf(w, vv.z, intra[x][2]);
            intra[x][3] = fmaf(w, vv.w, intra[x][3]);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = 4 * R + x;
        if (t0 + t >= s) break;
        const float4 vv = ld4(v_s + t * P + 4 * C);
        const float bt = beta_s[t];
        float4 o;
        o.x = inter[x][0] + intra[x][0] + bt * vv.x;
        o.y = inter[x][1] + intra[x][1] + bt * vv.y;
        o.z = inter[x][2] + intra[x][2] + bt * vv.z;
        o.w = inter[x][3] + intra[x][3] + bt * vv.w;
        *reinterpret_cast<float4*>(ob + (t0 + t) * os + 4 * C) = o;
      }
    }
    __syncthreads();                      // every read of S is done

    // S = diag(e^{a_last}) S + kdᵀ v on 4 x 4 blocks
    for (int p = tid; p < KB * KB; p += kThreads) {
      const int R = p / KB;
      const int C = p % KB;
      float acc[4][4] = {};
#pragma unroll 4
      for (int t = 0; t < CH; ++t) {
        const float4 kk = ld4(kd_s + t * P + 4 * R);
        const float4 vv = ld4(v_s + t * P + 4 * C);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float w = comp(kk, x);
          acc[x][0] = fmaf(w, vv.x, acc[x][0]);
          acc[x][1] = fmaf(w, vv.y, acc[x][1]);
          acc[x][2] = fmaf(w, vv.z, acc[x][2]);
          acc[x][3] = fmaf(w, vv.w, acc[x][3]);
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float* row = S_s + (4 * R + x) * P + 4 * C;
        const float d = decay_s[4 * R + x];
#pragma unroll
        for (int y = 0; y < 4; ++y) row[y] = row[y] * d + acc[x][y];
      }
    }
    // the next iteration's barrier orders these writes before any read
  }
}

template <int CH, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* la, const void* u, void* out, int b, int s,
                   int H, const int64_t* st, cudaStream_t stream) {
  auto kernel = wkv6_kernel<CH, K>;
  constexpr size_t smem = Smem<CH, K>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3(H, b), kThreads, smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(la),
      static_cast<const float*>(u), static_cast<float*>(out), s, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return cudaGetLastError();
}

template <int CH>
cudaError_t dispatch_k(const void* r, const void* k, const void* v,
                       const void* la, const void* u, void* out, int b,
                       int s, int H, int K, const int64_t* st,
                       cudaStream_t stream) {
  switch (K) {
    case 16: return launch<CH, 16>(r, k, v, la, u, out, b, s, H, st, stream);
    case 32: return launch<CH, 32>(r, k, v, la, u, out, b, s, H, st, stream);
    case 64: return launch<CH, 64>(r, k, v, la, u, out, b, s, H, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. r/k/v/la/u/out are device pointers to f32; the
// strides are in elements, for the batch, sequence and head axes of r, k,
// v and la (the K axis is contiguous, rows 16-byte aligned); u is a
// contiguous (H, K) tensor and out a contiguous (b, s, H, K) one. Chunks of
// `chunk` rows (16, 32 or 64) from position 0, K 16, 32 or 64. Launches
// asynchronously on `stream` and returns the first CUDA error, or 0.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* la, const void* u, void* out, int b, int s,
                    int H, int K, int chunk, int64_t rsb, int64_t rss,
                    int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh, int64_t lsb,
                    int64_t lss, int64_t lsh, void* stream) {
  if (b <= 0 || s <= 0 || H <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[12] = {rsb, rss, rsh, ksb, kss, ksh,
                          vsb, vss, vsh, lsb, lss, lsh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16:
      return static_cast<int>(
          dispatch_k<16>(r, k, v, la, u, out, b, s, H, K, st, cs));
    case 32:
      return static_cast<int>(
          dispatch_k<32>(r, k, v, la, u, out, b, s, H, K, st, cs));
    case 64:
      return static_cast<int>(
          dispatch_k<64>(r, k, v, la, u, out, b, s, H, K, st, cs));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
