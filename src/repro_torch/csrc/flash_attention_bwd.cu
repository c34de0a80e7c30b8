// Causal GQA attention backward; hand-written for Hopper (sm_90a).
//
// The training step's gradient of `flash_attention.cu`. The reference
// trains through its plain jnp attention (`_sdpa` in
// src/repro/models/layers.py, differentiated by XLA), so this kernel has
// no Pallas counterpart; it is the backward of the port's forward kernel,
// which replaces the TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/kernel.py:59).
//
// What it computes, for q (b, s, nq, hd), k/v (b, s, nkv, hd), the
// forward's output o and logsumexp lse (b, nq, s), and the upstream
// gradient dO in q's shape, f32 or bf16, g = nq / nkv:
//   D_i   = Σ_d dO_id · O_id
//   P_ij  = exp(q_i·k_j · hd^-1/2 − lse_i)       j ≤ i, else 0
//   dV_j  = Σ_{h in group, i ≥ j} P_ij · dO_i
//   dP_ij = dO_i · v_j
//   dS_ij = P_ij (dP_ij − D_i) · hd^-1/2
//   dQ_i  = Σ_{j ≤ i} dS_ij · k_j
//   dK_j  = Σ_{h in group, i ≥ j} dS_ij · q_i
// in f32; dq, dk and dv in q's dtype. The forward masks with −1e30 and
// floors its denominator at 1e-30; both are in lse, so P is the forward's.
//
// Three kernels, launched in order on one stream; none uses atomics, so
// every result is the same from run to run:
//  1. `flash_bwd_dot_kernel`: D, one warp a row.
//  2. `flash_bwd_dkdv_kernel`: one block per (kv tile of 64 rows, kv head,
//     batch row). It loops over the group's q heads and, for each, the q
//     tiles at or below the diagonal, so the GQA sum of dK and dV stays in
//     its registers; P and dS are rebuilt from q, k and lse (no s x s
//     tensor exists anywhere).
//  3. `flash_bwd_dq_kernel`: one block per (q tile of 64 rows, q head,
//     batch row), looping over the kv tiles up to the diagonal.
// Tiles above the diagonal are skipped (about s²/2 of the work); rows past
// s are zero-filled and never written, so any s runs. The operands are
// read in the model layout through their strides, as the forward does.
//
// What bounds it: operations. Five products of the forward's size (S and
// dP twice, dV, dK, dQ; the forward has two), 2.5 times its FLOPs: at
// tinyllama's training shape (b 8, s 2,048, 32/4 heads, hd 64) 3.4e11
// causal FLOPs for about 0.3 GB of operands, far above the card's ratio of
// operations to bytes. So bf16, the model's type, runs on the tensor cores
// (mma.sync m16n8k16 through `mma_sync.cuh`, operands staged by cp.async
// in two-stage rings, f32 accumulators; P and dS re-packed as bf16 A
// fragments in registers, as the forward packs P). f32 runs on the CUDA
// cores in fp32 (each thread a 4 x 4 block of the 64 x 64 logit tile, as
// the forward's f32 kernel), where the tensor cores would round the
// operands. This is the simple version: no TMA, no wgmma, one block's
// loads not yet overlapped with another's products beyond the two-stage
// ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tile.cuh"
#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using attn::kThreads;
using hopper::pack_bf16;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;            // rows of the tile a block owns
constexpr int kPP = kBlock + 4;       // pitch of an f32 64 x 64 tile
constexpr float kLog2e = 1.4426950408889634f;

// element strides of the batch, sequence and head axes of one operand
struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO ∘ O), one warp per (batch row, position, q head)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, int b, int s, int nq,
                     Strides ds) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(b) * s * nq) return;   // a whole warp
  const int h = static_cast<int>(row % nq);
  const int64_t i = (row / nq) % s;
  const int64_t bi = row / (static_cast<int64_t>(nq) * s);
  const T* orow = o + row * HD;                   // o is contiguous
  const T* drow = dout + bi * ds.b + i * ds.s + h * ds.h;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(bi * nq + h) * s + i] = acc;
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores. 256 threads; thread (tx, ty) = (tid % 16, tid / 16)
// owns rows ty + 16 i and columns tx + 16 j of a 64 x 64 tile, and columns
// tx · CW .. of the rows' gradients (CW = hd / 16).
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t f32_dkdv_smem() {   // k, v, q, dO tiles; Pᵀ, dSᵀ; lse, D
  return (4 * kBlock * attn::pitch<HD>() + 2 * kBlock * kPP + 2 * kBlock) *
         sizeof(float);
}
template <int HD>
constexpr size_t f32_dq_smem() {     // q, dO, k, v tiles; dS
  return (4 * kBlock * attn::pitch<HD>() + kBlock * kPP) * sizeof(float);
}

// CW consecutive floats of a shared-memory row
template <int CW>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[CW]) {
  if constexpr (CW % 4 == 0) {
#pragma unroll
    for (int w = 0; w < CW; w += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + w);
      x[w] = f.x;
      x[w + 1] = f.y;
      x[w + 2] = f.z;
      x[w + 3] = f.w;
    }
  } else if constexpr (CW == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = p[0];
  }
}

__device__ __forceinline__ float comp(float4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// a[i][j] += rows ty + 16 i of `ra` · rows tx + 16 j of `rb` (pitch P)
template <int HD>
__device__ __forceinline__ void tile_dots(float (&a)[4][4], const float* ra,
                                          const float* rb, int tx, int ty) {
  constexpr int P = attn::pitch<HD>();
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(ra + (ty + 16 * i) * P + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(rb + (tx + 16 * j) * P + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = attn::dot4(x[i], y[j], a[i][j]);
  }
}

// acc[i][w] += Σ_c t[ty + 16 i][c] · rows[c][tx · CW + w] over a 64-wide
// tile t (pitch kPP) and 64 rows (pitch P)
template <int HD>
__device__ __forceinline__ void tile_acc(float (&acc)[4][HD / 16],
                                         const float* t, const float* rows,
                                         int tx, int ty) {
  constexpr int P = attn::pitch<HD>();
  constexpr int CW = HD / 16;
#pragma unroll 2
  for (int c = 0; c < kBlock; c += 4) {
    float4 tv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tv[i] = *reinterpret_cast<const float4*>(t + (ty + 16 * i) * kPP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float x[CW];
      load_cols<CW>(rows + (c + cc) * P + tx * CW, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = comp(tv[i], cc);
#pragma unroll
        for (int w = 0; w < CW; ++w) acc[i][w] = fmaf(p, x[w], acc[i][w]);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int s, int nq, int nkv, int group, Strides qs,
                          Strides ks, Strides vs, Strides ds, float scale) {
  constexpr int P = attn::pitch<HD>();
  constexpr int CW = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBlock * P;
  float* q_s = v_s + kBlock * P;
  float* do_s = q_s + kBlock * P;
  float* p_s = do_s + kBlock * P;       // Pᵀ [kv row][q row]
  float* ds_s = p_s + kBlock * kPP;     // dSᵀ / scale
  float* lse_s = ds_s + kBlock * kPP;
  float* dl_s = lse_s + kBlock;

  const int jt = blockIdx.x;            // most q tiles first
  const int kvh = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int k0 = jt * kBlock;
  const int n_tiles = (s + kBlock - 1) / kBlock;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  {
    attn::Tile<HD, kBlock> kt, vt;
    kt.fetch(k + bi * ks.b + k0 * ks.s + kvh * ks.h, ks.s, s - k0);
    vt.fetch(v + bi * vs.b + k0 * vs.s + kvh * vs.h, vs.s, s - k0);
    kt.store(k_s);
    vt.store(v_s);
  }
  float dka[4][CW], dva[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int w = 0; w < CW; ++w) dka[i][w] = dva[i][w] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const int64_t rows = (bi * nq + h) * s;
    for (int it = jt; it < n_tiles; ++it) {
      const int q0 = it * kBlock;
      attn::Tile<HD, kBlock> qt, dt;
      qt.fetch(q + bi * qs.b + q0 * qs.s + h * qs.h, qs.s, s - q0);
      dt.fetch(dout + bi * ds.b + q0 * ds.s + h * ds.h, ds.s, s - q0);
      __syncthreads();                  // the last tile's reads are done
      qt.store(q_s);
      dt.store(do_s);
      if (threadIdx.x < kBlock) {       // rows past s: P = 0
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < s ? lse[rows + r] : inf();
        dl_s[threadIdx.x] = r < s ? delta[rows + r] : 0.f;
      }
      __syncthreads();

      // Sᵀ and dPᵀ of kv rows ty + 16 i against q rows tx + 16 j
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
      tile_dots<HD>(sc, k_s, q_s, tx, ty);
      tile_dots<HD>(dp, v_s, do_s, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kv_row = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = q0 + c >= kv_row
                              ? expf(sc[i][j] * scale - lse_s[c]) : 0.f;
          p_s[(ty + 16 * i) * kPP + c] = p;
          ds_s[(ty + 16 * i) * kPP + c] = p * (dp[i][j] - dl_s[c]);
        }
      }
      __syncthreads();
      tile_acc<HD>(dva, p_s, do_s, tx, ty);
      tile_acc<HD>(dka, ds_s, q_s, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= s) continue;
    const int64_t off = ((bi * s + row) * nkv + kvh) * HD + tx * CW;
#pragma unroll
    for (int w = 0; w < CW; ++w) {
      dk[off + w] = dka[i][w] * scale;
      dv[off + w] = dva[i][w];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int s, int nq, int group,
                        Strides qs, Strides ks, Strides vs, Strides ds,
                        float scale) {
  constexpr int P = attn::pitch<HD>();
  constexpr int CW = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBlock * P;
  float* k_s = do_s + kBlock * P;
  float* v_s = k_s + kBlock * P;
  float* ds_s = v_s + kBlock * P;       // dS / scale [q row][kv row]

  const int iq = gridDim.x - 1 - blockIdx.x;       // largest tiles first
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int kvh = h / group;
  const int q0 = iq * kBlock;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  {
    attn::Tile<HD, kBlock> qt, dt;
    qt.fetch(q + bi * qs.b + q0 * qs.s + h * qs.h, qs.s, s - q0);
    dt.fetch(dout + bi * ds.b + q0 * ds.s + h * ds.h, ds.s, s - q0);
    qt.store(q_s);
    dt.store(do_s);
  }
  float lse_r[4], dl_r[4];
  const int64_t rows = (bi * nq + h) * s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < s ? lse[rows + r] : inf();
    dl_r[i] = r < s ? delta[rows + r] : 0.f;
  }
  const float* kb = k + bi * ks.b + kvh * ks.h;
  const float* vb = v + bi * vs.b + kvh * vs.h;
  float dqa[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int w = 0; w < CW; ++w) dqa[i][w] = 0.f;

  for (int jt = 0; jt <= iq; ++jt) {
    const int k0 = jt * kBlock;
    attn::Tile<HD, kBlock> kt, vt;
    kt.fetch(kb + k0 * ks.s, ks.s, s - k0);
    vt.fetch(vb + k0 * vs.s, vs.s, s - k0);
    __syncthreads();                    // the last tile's reads are done
    kt.store(k_s);
    vt.store(v_s);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    tile_dots<HD>(sc, q_s, k_s, tx, ty);
    tile_dots<HD>(dp, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = k0 + c <= row ? expf(sc[i][j] * scale - lse_r[i])
                                      : 0.f;
        ds_s[(ty + 16 * i) * kPP + c] = p * (dp[i][j] - dl_r[i]);
      }
    }
    __syncthreads();
    tile_acc<HD>(dqa, ds_s, k_s, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    float* o = dq + ((bi * s + row) * nq + h) * HD + tx * CW;
#pragma unroll
    for (int w = 0; w < CW; ++w) o[w] = dqa[i][w] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: 4 warps, each owning 16 rows of the block's
// 64-row tile; bf16 tiles in shared memory at pitch hd + 8 (the eight rows
// of an ldmatrix fall in distinct banks), fed by 16-byte cp.async with the
// rows past s zero-filled. The m16n8k16 fragment layouts are those of
// `mma_sync.cuh`; an accumulator pair of two 8-column blocks is re-packed
// as the A fragment of the next product, as the forward does with P.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;

template <int HD>
__host__ __device__ constexpr int mma_pitch() { return HD + 8; }

// q rows a step of the dK/dV kernel: 32 at hd 128 keeps its four
// accumulator sets (Sᵀ, dPᵀ, dK, dV) within the register file
template <int HD>
__host__ __device__ constexpr int dkdv_rows() { return HD == 128 ? 32 : 64; }

template <int HD>
constexpr size_t dkdv_smem() {   // k, v; 2 stages of (q, dO); 2 of (lse, D)
  return (2 * kBlock + 4 * dkdv_rows<HD>()) * mma_pitch<HD>() * sizeof(bf16) +
         4 * dkdv_rows<HD>() * sizeof(float);
}
template <int HD>
constexpr size_t dq_smem() {     // q, dO; 2 stages of (k, v)
  return 6 * kBlock * mma_pitch<HD>() * sizeof(bf16);
}

// async copy of rows [0, valid) of a ROWS-row tile into shared memory at
// pitch hd + 8; the other rows are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          int64_t row_stride, int valid) {
  constexpr int kChunks = HD / 8;       // 16-byte chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool live = r < valid;
    cp_async16(dst + r * mma_pitch<HD>() + c,
               src + (live ? r : 0) * row_stride + c, live ? 16 : 0);
  }
}

// acc[j] += A(16 rows of `a_rows` from row 16 warp) · B where B's columns
// are the N rows of `b_rows` (N / 8 blocks): the product of two row-major
// tiles over head_dim, X · Yᵀ
template <int HD, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4],
                                        const bf16* a_rows,
                                        const bf16* b_rows, int warp,
                                        int lane) {
  constexpr int P = mma_pitch<HD>();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows + (16 * warp + (lane % 16)) * P + ks * 16 +
                       (lane / 16) * 8);
#pragma unroll
    for (int j2 = 0; j2 < NB / 2; ++j2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_rows + (16 * j2 + (lane % 8) + (lane / 16) * 8) * P +
                         ks * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * j2], a, b[0], b[1]);
      mma_bf16(acc[2 * j2 + 1], a, b[2], b[3]);
    }
  }
}

// acc[j] (16 x hd) += X · Y where X (16 x K) is held as accumulator blocks
// x[0 .. K/8) and Y is K rows of `rows` (row-major, read transposed)
template <int HD, int K>
__device__ __forceinline__ void mma_xy(float (&acc)[HD / 8][4],
                                       const float (&x)[K / 8][4],
                                       const bf16* rows, int lane) {
  constexpr int P = mma_pitch<HD>();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int j2 = 0; j2 < HD / 16; ++j2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, rows + (16 * kk + (lane % 8) +
                                   ((lane / 8) % 2) * 8) * P +
                               16 * j2 + (lane / 16) * 8);
      mma_bf16(acc[2 * j2], a, b[0], b[1]);
      mma_bf16(acc[2 * j2 + 1], a, b[2], b[3]);
    }
  }
}

// rows r and r + 8 of a 16 x hd accumulator, times `mul`, as bf16 into a
// contiguous (.., hd) tensor at rows of `pitch` elements
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[HD / 8][4],
                                           int64_t off_lo, int64_t pitch,
                                           bool lo, bool hi, int t,
                                           float mul) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (lo)
      *reinterpret_cast<uint32_t*>(out + off_lo + col) =
          pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    if (hi)
      *reinterpret_cast<uint32_t*>(out + off_lo + 8 * pitch + col) =
          pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int s, int nq, int nkv,
                      int group, Strides qs, Strides ks, Strides vs,
                      Strides ds, float scale) {
  constexpr int P = mma_pitch<HD>();
  constexpr int BQ = dkdv_rows<HD>();
  constexpr int kNQ = BQ / 8;           // 8-column blocks of Sᵀ (q rows)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBlock * P;
  bf16* qd_s = v_s + kBlock * P;        // [stage][q | dO][BQ][P]
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * BQ * P);  // [stage][lse·log2e | D][BQ]

  const int jt = blockIdx.x;            // most q tiles first
  const int kvh = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int k0 = jt * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kv_lo = k0 + 16 * warp + g;  // this thread's kv rows: lo, lo + 8
  const int n_qt = (s + BQ - 1) / BQ;
  const int it0 = k0 / BQ;              // the q tile that starts at k0
  const int per_head = n_qt - it0;
  const int items = group * per_head;   // (q head, q tile) steps
  const float sl2 = scale * kLog2e;

  copy_rows<HD, kBlock>(k_s, k + bi * ks.b + k0 * ks.s + kvh * ks.h, ks.s,
                        s - k0);
  copy_rows<HD, kBlock>(v_s, v + bi * vs.b + k0 * vs.s + kvh * vs.h, vs.s,
                        s - k0);
  cp_async_commit();
  auto load_item = [&](int n) {
    const int h = kvh * group + n / per_head;
    const int q0 = (it0 + n % per_head) * BQ;
    bf16* dst = qd_s + (n & 1) * 2 * BQ * P;
    copy_rows<HD, BQ>(dst, q + bi * qs.b + q0 * qs.s + h * qs.h, qs.s,
                      s - q0);
    copy_rows<HD, BQ>(dst + BQ * P, dout + bi * ds.b + q0 * ds.s + h * ds.h,
                      ds.s, s - q0);
    float* sd = st_s + (n & 1) * 2 * BQ;
    const int64_t rows = (bi * nq + h) * s;
    for (int i = threadIdx.x; i < BQ; i += kMmaThreads) {
      const int r = q0 + i;             // rows past s: P = 0
      sd[i] = r < s ? lse[rows + r] * kLog2e : inf();
      sd[BQ + i] = r < s ? delta[rows + r] : 0.f;
    }
  };
  load_item(0);
  cp_async_commit();

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int n = 0; n < items; ++n) {
    if (n + 1 < items) {                // the next step into the other stage
      load_item(n + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (it0 + n % per_head) * BQ;
    const bf16* q_t = qd_s + (n & 1) * 2 * BQ * P;
    const bf16* do_t = q_t + BQ * P;
    const float* lse2 = st_s + (n & 1) * 2 * BQ;
    const float* dl = lse2 + BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows kv_lo / kv_lo + 8, columns q
    // rows 8 j + 2 t (+1)
    float sc[kNQ][4], dp[kNQ][4];
#pragma unroll
    for (int j = 0; j < kNQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    mma_abt<HD, kNQ>(sc, k_s, q_t, warp, lane);
    mma_abt<HD, kNQ>(dp, v_s, do_t, warp, lane);
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const int kv = e < 2 ? kv_lo : kv_lo + 8;
        const float p = q0 + c >= kv ? exp2f(sc[j][e] * sl2 - lse2[c]) : 0.f;
        sc[j][e] = p;                            // Pᵀ
        dp[j][e] = p * (dp[j][e] - dl[c]);       // dSᵀ / scale
      }
    }
    mma_xy<HD, BQ>(dva, sc, do_t, lane);         // dV += Pᵀ·dO
    mma_xy<HD, BQ>(dka, dp, q_t, lane);          // dK += dSᵀ·Q
    __syncthreads();                    // this stage is refilled next
  }

  const int64_t off = ((bi * s + kv_lo) * nkv + kvh) * HD;
  const int64_t pitch = static_cast<int64_t>(nkv) * HD;
  store_rows<HD>(dk, dka, off, pitch, kv_lo < s, kv_lo + 8 < s, t, scale);
  store_rows<HD>(dv, dva, off, pitch, kv_lo < s, kv_lo + 8 < s, t, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int s, int nq, int group, Strides qs, Strides ks,
                    Strides vs, Strides ds, float scale) {
  constexpr int P = mma_pitch<HD>();
  constexpr int kNB = kBlock / 8;       // 8-column blocks of S (kv rows)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBlock * P;
  bf16* kv_s = do_s + kBlock * P;       // [stage][k | v][64][P]

  const int iq = gridDim.x - 1 - blockIdx.x;       // largest tiles first
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int kvh = h / group;
  const int q0 = iq * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_lo = q0 + 16 * warp + g;  // this thread's rows: lo, lo + 8
  const float sl2 = scale * kLog2e;
  const bf16* kb = k + bi * ks.b + kvh * ks.h;
  const bf16* vb = v + bi * vs.b + kvh * vs.h;

  copy_rows<HD, kBlock>(q_s, q + bi * qs.b + q0 * qs.s + h * qs.h, qs.s,
                        s - q0);
  copy_rows<HD, kBlock>(do_s, dout + bi * ds.b + q0 * ds.s + h * ds.h, ds.s,
                        s - q0);
  cp_async_commit();
  copy_rows<HD, kBlock>(kv_s, kb, ks.s, s);
  copy_rows<HD, kBlock>(kv_s + kBlock * P, vb, vs.s, s);
  cp_async_commit();

  const int64_t rows = (bi * nq + h) * s;
  float lse2[2], dl[2];                 // rows past s: P = 0
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row_lo + 8 * e;
    lse2[e] = r < s ? lse[rows + r] * kLog2e : inf();
    dl[e] = r < s ? delta[rows + r] : 0.f;
  }
  float dqa[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  for (int jt = 0; jt <= iq; ++jt) {
    const int k0 = jt * kBlock;
    if (jt < iq) {                      // next tile into the other stage
      bf16* nxt = kv_s + ((jt + 1) & 1) * 2 * kBlock * P;
      copy_rows<HD, kBlock>(nxt, kb + (k0 + kBlock) * ks.s, ks.s,
                            s - k0 - kBlock);
      copy_rows<HD, kBlock>(nxt + kBlock * P, vb + (k0 + kBlock) * vs.s,
                            vs.s, s - k0 - kBlock);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_t = kv_s + (jt & 1) * 2 * kBlock * P;
    const bf16* v_t = k_t + kBlock * P;

    // S = Q·Kᵀ and dP = dO·Vᵀ: rows row_lo / row_lo + 8, columns kv rows
    // k0 + 8 j + 2 t (+1)
    float sc[kNB][4], dp[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    mma_abt<HD, kNB>(sc, q_s, k_t, warp, lane);
    mma_abt<HD, kNB>(dp, do_s, v_t, warp, lane);
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int r = e >> 1;
        const float p = col <= row_lo + 8 * r
                            ? exp2f(sc[j][e] * sl2 - lse2[r]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[r]);       // dS / scale
      }
    }
    mma_xy<HD, kBlock>(dqa, dp, k_t, lane);      // dQ += dS·K
    __syncthreads();                    // this stage is refilled next
  }

  store_rows<HD>(dq, dqa, ((bi * s + row_lo) * nq + h) * HD,
                 static_cast<int64_t>(nq) * HD, row_lo < s, row_lo + 8 < s,
                 t, scale);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int b, s, nq, nkv;
  Strides qs, ks, vs, ds;
  float scale;
};

template <typename T, int HD>
int launch_dot(const Args& a, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(a.b) * a.s * a.nq;
  const int64_t blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dot_kernel<T, HD><<<static_cast<unsigned>(blocks), 256, 0,
                                stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      a.b, a.s, a.nq, a.ds);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const Args& a, cudaStream_t stream) {
  int err = launch_dot<float, HD>(a, stream);
  if (err) return err;
  const int tiles = (a.s + kBlock - 1) / kBlock;
  const int group = a.nq / a.nkv;
  auto dkdv = flash_bwd_dkdv_f32_kernel<HD>;
  cudaError_t e = attn::allow_smem(dkdv, f32_dkdv_smem<HD>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv<<<dim3(tiles, a.nkv, a.b), kThreads, f32_dkdv_smem<HD>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.s, a.nq, a.nkv, group, a.qs, a.ks, a.vs, a.ds, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto dq = flash_bwd_dq_f32_kernel<HD>;
  e = attn::allow_smem(dq, f32_dq_smem<HD>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dq<<<dim3(tiles, a.nq, a.b), kThreads, f32_dq_smem<HD>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.s, a.nq, group, a.qs,
      a.ks, a.vs, a.ds, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const Args& a, cudaStream_t stream) {
  int err = launch_dot<bf16, HD>(a, stream);
  if (err) return err;
  const int tiles = (a.s + kBlock - 1) / kBlock;
  const int group = a.nq / a.nkv;
  auto dkdv = flash_bwd_dkdv_kernel<HD>;
  cudaError_t e = attn::allow_smem(dkdv, dkdv_smem<HD>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv<<<dim3(tiles, a.nkv, a.b), kMmaThreads, dkdv_smem<HD>(), stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.s,
      a.nq, a.nkv, group, a.qs, a.ks, a.vs, a.ds, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto dq = flash_bwd_dq_kernel<HD>;
  e = attn::allow_smem(dq, dq_smem<HD>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dq<<<dim3(tiles, a.nq, a.b), kMmaThreads, dq_smem<HD>(), stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dq), a.s, a.nq, group, a.qs, a.ks, a.vs,
      a.ds, a.scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& a, int hd, bool is_bf16, cudaStream_t stream) {
#define BWD_CASE(HD) \
  case HD:           \
    return is_bf16 ? launch_bf16<HD>(a, stream) : launch_f32<HD>(a, stream);
  switch (hd) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BWD_CASE
}

}  // namespace

// Plain C entry for ctypes. q/k/v/dout are device pointers read through
// their strides (in elements, for the batch, sequence and head axes; the
// head_dim axis is contiguous); o (b, s, nq, hd) and lse (b, nq, s, f32)
// are the forward's contiguous outputs; delta is an f32 (b, nq, s) buffer
// the first kernel fills; dq (b, s, nq, hd), dk and dv (b, s, nkv, hd) are
// contiguous outputs of q's dtype. `bf16` says the tensors hold bf16 (else
// f32). Launches the three kernels asynchronously on `stream` and returns
// the first CUDA error, or 0.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int s, int nq, int nkv, int hd, int64_t qsb, int64_t qss,
    int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
    int64_t vss, int64_t vsh, int64_t dsb, int64_t dss, int64_t dsh,
    float scale, int bf16, void* stream) {
  if (b <= 0 || s <= 0 || nkv <= 0 || nq % nkv || b > 65535 || nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,  v, o, dout, lse, delta, dq, dk, dv, b, s, nq, nkv,
               {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
               {dsb, dss, dsh}, scale};
  return dispatch(a, hd, bf16 != 0, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
