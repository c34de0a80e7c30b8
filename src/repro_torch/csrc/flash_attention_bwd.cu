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
//  2. dK/dV: one block per (kv tile, kv head, batch row). It loops over
//     the group's q heads and, for each, the q tiles at or below the
//     diagonal, so the GQA sum of dK and dV stays in its registers; P and
//     dS are rebuilt from q, k and lse (no s x s tensor exists anywhere).
//  3. dQ: one block per (q tile, q head, batch row), looping over the kv
//     tiles up to the diagonal.
// Tiles above the diagonal are skipped (about s²/2 of the work); rows past
// s are zero-filled and never written, so any s runs. The operands are
// read in the model layout through their strides, as the forward does.
//
// What bounds it: operations. Five products of the forward's size (S and
// dP twice, dV, dK, dQ; the forward has two), 2.5 times its FLOPs: at
// tinyllama's training shape (b 8, s 2,048, 32/4 heads, hd 64) 3.4e11
// causal FLOPs for about 0.3 GB of operands, far above the card's ratio of
// operations to bytes. The two-kernel form runs seven (S and dP in both),
// so it reaches at most 5/7 of the bound; a fused form would need dQ summed
// across kv tiles, in an order fixed by a semaphore or by atomics whose
// order changes from run to run, and the bit-for-bit repeat of a call
// (training resumes exactly) is worth more here than the two products.
//
// bf16 at head dims 64 and 128 (every registered config) runs on Hopper's
// TMA and wgmma: `flash_bwd_dkdv_wgmma_kernel` and
// `flash_bwd_dq_wgmma_kernel` (design at their definitions). bf16 at hd
// 16 and 32 (smoke twins only) keeps `flash_bwd_dkdv_kernel` and
// `flash_bwd_dq_kernel` (mma.sync m16n8k16 through `mma_sync.cuh`,
// operands staged by cp.async in two-stage rings, 64-row tiles), as the
// forward keeps its mma.sync kernel there. f32 runs on the CUDA cores in
// fp32 (each thread a 4 x 4 block of the 64 x 64 logit tile, as the
// forward's f32 kernel), where the tensor cores would round the operands.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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
// 1. D = rowsum(dO ∘ O), a row (batch row, position, q head) to the lanes
//    of a warp that cover it with 16-byte loads. With
//    kRows (the wgmma kernels) `delta` is a (2, b, nq, s_pad) scratch whose
//    rows are padded to a multiple of 128 positions: [0] gets lse · log2e
//    and [1] D, and the rows past s +inf and 0, so that a 64-row slice at
//    any tile is one aligned bulk copy and gives P = 0 where q is past s.
//    Without it `delta` is D alone, (b, nq, s).
// ---------------------------------------------------------------------------

template <typename T, int HD, bool kRows>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     int b, int s, int s_rows, int nq, Strides ds) {
  constexpr int kVec = 16 / sizeof(T);  // elements of one 16-byte load
  constexpr int kLanes = HD / kVec;     // lanes a row: 2 .. 32
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  const bool live = row < static_cast<int64_t>(b) * s_rows * nq;
  const int h = static_cast<int>(row % nq);
  const int64_t i = (row / nq) % s_rows;
  const int64_t bi = row / (static_cast<int64_t>(nq) * s_rows);
  float acc = 0.f;
  if (live && i < s) {                  // o is contiguous
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + ((bi * s + i) * nq + h) * HD + part * kVec);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + bi * ds.b + i * ds.s + h * ds.h + part * kVec);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc = fmaf(to_f(oe[e]), to_f(de[e]), acc);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (!live || part != 0) return;
  const int64_t at = (bi * nq + h) * s_rows + i;
  if constexpr (kRows) {
    const int64_t d_part = static_cast<int64_t>(b) * nq * s_rows;
    delta[at] = i < s ? lse[(bi * nq + h) * s + i] * kLog2e : inf();
    delta[d_part + at] = acc;           // 0 past s
  } else {
    delta[at] = acc;
  }
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
// bf16 at head dims 16 and 32 on mma.sync: 4 warps, each owning 16 rows of
// the block's 64-row tile; bf16 tiles in shared memory at pitch hd + 8 (the
// eight rows of an ldmatrix fall in distinct banks), fed by 16-byte
// cp.async with the rows past s zero-filled. The m16n8k16 fragment layouts
// are those of `mma_sync.cuh`; an accumulator pair of two 8-column blocks
// is re-packed as the A fragment of the next product, as the forward does
// with P.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;

template <int HD>
__host__ __device__ constexpr int mma_pitch() { return HD + 8; }

template <int HD>
constexpr size_t dkdv_smem() {   // k, v; 2 stages of (q, dO); 2 of (lse, D)
  return 6 * kBlock * mma_pitch<HD>() * sizeof(bf16) +
         4 * kBlock * sizeof(float);
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
  constexpr int BQ = kBlock;            // q rows a step
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

// ---------------------------------------------------------------------------
// bf16 at head dims 64 and 128: TMA and wgmma. Both kernels have one shape.
// A block owns a tile of 128 rows (kv rows for dK/dV, q rows for dQ) and
// streams the other side in steps of 64 rows; it has 384 threads in three
// warpgroups:
//
//  * a producer warpgroup that gives up its registers (setmaxnreg) and of
//    which one thread issues every load: the owned tiles once, by TMA from
//    4-D tensor maps over the model layout (dims hd, heads, s, b; boxes of
//    64 columns x 64 rows with the 128-byte swizzle, so a 128-row tile at
//    hd 128 is four boxes), then the steps through a ring of four stages,
//    each with a full and an empty mbarrier. Rows past s arrive as
//    zeros. The dK/dV kernel's steps also carry that q tile's lse · log2e
//    and D rows, two 256-byte bulk copies from the padded scratch that
//    `flash_bwd_dot_kernel` writes (+inf and 0 past s, so P = 0 there
//    whatever the zero rows of q and dO give; the padding keeps every copy
//    inside the scratch and 16-byte aligned, which a 1-D bulk copy needs).
//  * two consumer warpgroups of 64 owned rows each. A step is four
//    products on the tensor cores: two 64 x 64 logit tiles by hd/16 wgmma
//    m64n64k16 with both operands K-major in shared memory (as the
//    forward's issue_qk), then P (or Pᵀ) and dS formed on the accumulator
//    registers (exp2 on the special function unit with the scale folded
//    in; the causal mask on the diagonal steps), packed to bf16 A fragments
//    in registers (as the forward's pack_p), and two (or one) m64n{hd}k16
//    with A from registers and the streamed 64-row tile as an MN-major B
//    operand (the transpose bit, as the forward's issue_pv). P and dS never
//    touch shared memory, and no result leaves the block but its own rows.
//
// dK/dV (`flash_bwd_dkdv_wgmma_kernel`): a work item is (kv tile, batch
// row, kv head), the kv tiles nearest position 0 first (they see the most q
// tiles). The owned tiles are k and v; the steps are the q and dO tiles of
// every q head of the group at or below the diagonal. Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ, Pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e), dSᵀ = Pᵀ∘(dPᵀ − D),
// dV += Pᵀ·dO and dK += dSᵀ·Q: the GQA sum stays in registers.
//
// dQ (`flash_bwd_dq_wgmma_kernel`): a work item is (q tile, batch row, q
// head), the last q tiles first, the heads of one kv group side by side so
// that they share k and v in L2 (the forward's order). The owned tiles are
// q and dO, each thread's lse and D rows sit in registers from the start,
// and the steps are the k and v tiles up to the diagonal: S = Q·Kᵀ,
// dP = dO·Vᵀ, dS as above, dQ += dS·K. The forward's loop without the
// online softmax.
//
// Registers set the overlap. ptxas serialises every wgmma ("insufficient
// register resources", C7512: each product waits for the one before) once
// a consumer thread's live values pass about 165 registers, whatever
// setmaxnreg grants; on an H100 the serialised kernels ran 1.3 to 2.8
// times slower. So each loop keeps what is in flight at about 128:
//  * dQ at hd 64 (dq 32 floats): step n's S and dP are issued beside step
//    n - 1's dQ product, and their exp2 runs while it runs (the forward's
//    S_j beside P_{j-1}·V);
//  * dQ at hd 128 (dq 64) and the dK pass below: step n's S is issued
//    beside step n - 1's sum and its exp2 runs while it runs; dP follows
//    once that sum is in;
//  * dK/dV at hd 64 (dK and dV, 32 floats each): no look-ahead; the other
//    warpgroup fills the tensor cores' gaps;
//  * dK/dV at hd 128: dK and dV (64 floats each) and a step's logits do not
//    fit together, so the kernel makes two passes over the same steps, dV
//    into one accumulator (Sᵀ only, S beside the last sum), then dK (Sᵀ
//    and dPᵀ): one more Sᵀ product a step, five where one pass has four.
// One block per work item and SM; the longest items start first, so the
// short ones fill the tail.
//
// What it does not reach: the accumulating products with A in registers
// run at N = 64 (hd 64) far below the tensor cores' rate. On an H100 at
// tinyllama's training shape, leaving them out took dK/dV from 0.67 to
// 0.23 ms and dQ from 0.53 to 0.21 ms, and reading A from shared memory
// instead (with wrong values, for the timing) to 0.28 and 0.25 ms; at
// N = 128 (hd 128) the two forms were within 6%. P and dS stay register
// operands here; staging them through shared memory at hd 64 is the next
// step (PERF.md §7).
// ---------------------------------------------------------------------------

constexpr int kWgTile = 128;          // rows a block owns
constexpr int kWgStep = 64;           // rows a step streams
constexpr int kWgBox = 64 * 128;      // one TMA box: 64 rows of 64 bf16
constexpr int kWgConsumers = 256;     // two warpgroups of 64 owned rows
constexpr int kWgThreads = kWgConsumers + 128;   // and the producer's
constexpr int kWgStages = 4;          // depth of the step ring
constexpr int kWgRowBytes = 2 * kWgStep * 4;   // a step's lse·log2e and D

// Shared memory, from a base aligned to the 1,024-byte swizzle atom: the
// two owned tiles (column box c of a 128-row tile at c · 2 boxes, row half
// r at + r boxes) | kWgStages stages of two 64-row steps (box c at c boxes)
// | kWgStages stages of lse and D rows | full[kWgStages], empty[kWgStages],
// owned. `flash_bwd_plan` in kernels/flash_attention/kernel.py repeats
// this arithmetic for the launch plan and its tests.
template <int HD>
struct WgCfg {
  static constexpr int kBoxes = HD / 64;              // column boxes a row
  static constexpr int kTileBytes = 2 * kBoxes * kWgBox;   // 128 rows
  static constexpr int kStepBytes = kBoxes * kWgBox;       // 64 rows
  static constexpr int kStageOffset = 2 * kTileBytes;
  static constexpr int kRowsOffset = kStageOffset + 2 * kWgStages * kStepBytes;
  static constexpr int kBarOffset = kRowsOffset + kWgStages * kWgRowBytes;
  static constexpr size_t kSmem = kBarOffset + (2 * kWgStages + 1) * 8 + 1024;
  static_assert(kSmem <= 232448, "over the 227 KB a block can use");
};

// acc (64 x 64) = rows [64 wg, 64 wg + 64) of a 128-row tile (`a_wg` points
// at them) times the 64-row step `x` transposed: hd/16 k steps of 32 bytes
// into column box kk / 4 of both K-major tiles. Not committed.
template <int HD>
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint32_t a_wg,
                                          uint32_t x) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t a = a_wg + (kk / 4) * 2 * kWgBox + (kk % 4) * 32;
    const uint32_t b = x + (kk / 4) * kWgBox + (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss(acc, hopper::sw128_desc(a, 16, 1024),
                               hopper::sw128_desc(b, 16, 1024), kk > 0);
  }
}

// acc (64 x hd) += F · y: F (64 x 64) the packed fragments `f` (k step kk
// in f[4 kk ..]), y a 64-row step read as an MN-major B operand (16 rows,
// 2,048 bytes, a k step; column boxes one box apart). Not committed.
template <int HD>
__device__ __forceinline__ void issue_fy(float (&acc)[HD / 2],
                                         const uint32_t (&f)[16],
                                         uint32_t y) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgStep / 16; ++kk) {
    const uint64_t d = hopper::sw128_desc(y + kk * 2048, kWgBox, 1024);
    if constexpr (HD == 64)
      hopper::wgmma_m64n64k16_rs(acc, f + 4 * kk, d);
    else
      hopper::wgmma_m64n128k16_rs(acc, f + 4 * kk, d);
  }
}

// two floats of shared memory at `addr`; volatile so that it stays after
// the barrier wait that makes them valid
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// a 64 x 64 accumulator in bf16: f[4 kk .. 4 kk + 3] is the A fragment of
// its columns 16 kk .. 16 kk + 15 (the forward's pack_p at 64 columns)
__device__ __forceinline__ void pack_frag(const float (&x)[32],
                                          uint32_t (&f)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[2 * j] = pack_bf16(x[4 * j], x[4 * j + 1]);
    f[2 * j + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// rows lo and lo + 8 (when below s) of a 64 x hd accumulator, times `mul`,
// as bf16 at `out` (this thread's row lo, columns 2 t ..), rows `pitch`
// elements apart
template <int HD>
__device__ __forceinline__ void store_wg(bf16* out, const float (&acc)[HD / 2],
                                         int64_t pitch, bool lo, bool hi,
                                         float mul) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (lo)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (hi)
      *reinterpret_cast<uint32_t*>(out + 8 * pitch + 8 * j) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// A block's barriers, and the producer's TMA loads into its owned tiles and
// its ring of steps.
template <int HD>
struct WgRing {
  uint32_t bars;
  __device__ uint32_t full(int st) const { return bars + 8 * st; }
  __device__ uint32_t empty(int st) const {
    return bars + 8 * (kWgStages + st);
  }
  __device__ uint32_t owned() const { return bars + 16 * kWgStages; }

  __device__ void init() const {
    for (int st = 0; st < kWgStages; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), kWgConsumers / 32);
    }
    hopper::mbar_init(owned(), 1);
    hopper::mbar_fence_init();
  }

  // rows r0 .. r0 + 127 of head h of two maps into two owned tiles
  __device__ void load_owned(uint32_t a, const CUtensorMap* ma, uint32_t b,
                             const CUtensorMap* mb, int h, int r0,
                             int bi) const {
    using L = WgCfg<HD>;
    hopper::mbar_expect_tx(owned(), 2 * L::kTileBytes);
    for (int c = 0; c < L::kBoxes; ++c)
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = c * 2 * kWgBox + r * kWgBox;
        hopper::tma_load_4d(a + off, ma, owned(), 64 * c, h, r0 + 64 * r, bi);
        hopper::tma_load_4d(b + off, mb, owned(), 64 * c, h, r0 + 64 * r, bi);
      }
  }

  // step n (stage n % kWgStages): rows r0 .. r0 + 63 of head h of two maps,
  // and `extra` more bytes the caller adds to the same barrier
  __device__ void load_step(int n, uint32_t x, const CUtensorMap* mx,
                            uint32_t y, const CUtensorMap* my, int h, int r0,
                            int bi, int extra) const {
    using L = WgCfg<HD>;
    const int st = n % kWgStages;
    if (n >= kWgStages)                    // the consumers are done with it
      hopper::mbar_wait(empty(st), (n / kWgStages - 1) & 1);
    hopper::mbar_expect_tx(full(st), 2 * L::kStepBytes + extra);
    for (int c = 0; c < L::kBoxes; ++c) {
      hopper::tma_load_4d(x + c * kWgBox, mx, full(st), 64 * c, h, r0, bi);
      hopper::tma_load_4d(y + c * kWgBox, my, full(st), 64 * c, h, r0, bi);
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ rows,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int b, int s, int s_pad, int nq, int nkv,
                            int group, float sl2, float scale) {
  using L = WgCfg<HD>;
  constexpr int kPasses = HD == 128 ? 2 : 1;   // registers: see the note
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (hopper::smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + L::kTileBytes;
  auto q_st = [&](int st) {
    return base + L::kStageOffset + 2 * st * L::kStepBytes;
  };
  auto do_st = [&](int st) { return q_st(st) + L::kStepBytes; };
  const WgRing<HD> ring{base + L::kBarOffset};

  // the work item: kv tile jt, batch row bi, kv head kvh; step n of a pass
  // is (q head kvh · group + n / per_head, q tile it0 + n % per_head), and
  // the ring numbers the steps of all passes in a row
  const int item = blockIdx.x;
  const int jt = item / (b * nkv);
  const int bi = (item / nkv) % b;
  const int kvh = item % nkv;
  const int k0 = jt * kWgTile;
  const int it0 = k0 / kWgStep;         // the q tile that starts at k0
  const int per_head = (s + kWgStep - 1) / kWgStep - it0;
  const int steps = group * per_head;   // a pass's; every item has one
  const int64_t d_part = static_cast<int64_t>(b) * nq * s_pad;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kWgConsumers) {                // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kWgConsumers) {
      hopper::tma_prefetch_map(&tm_q);
      hopper::tma_prefetch_map(&tm_k);
      hopper::tma_prefetch_map(&tm_v);
      hopper::tma_prefetch_map(&tm_do);
      ring.load_owned(k_s, &tm_k, v_s, &tm_v, kvh, k0, bi);
      for (int n = 0; n < kPasses * steps; ++n) {
        const int st = n % kWgStages;
        const int h = kvh * group + n % steps / per_head;
        const int q0 = (it0 + n % steps % per_head) * kWgStep;
        ring.load_step(n, q_st(st), &tm_q, do_st(st), &tm_do, h, q0, bi,
                       kWgRowBytes);
        const float* lr = rows + (static_cast<int64_t>(bi) * nq + h) * s_pad +
                          q0;
        const uint32_t r_s = base + L::kRowsOffset + st * kWgRowBytes;
        hopper::bulk_load(r_s, lr, kWgRowBytes / 2, ring.full(st));
        hopper::bulk_load(r_s + kWgRowBytes / 2, lr + d_part,
                          kWgRowBytes / 2, ring.full(st));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup wg owns kv rows 64 wg .. 64 wg + 63 of the tile; this
  // thread's accumulator rows are kv_lo and kv_lo + 8, its columns (q rows
  // of a step) 8 j + 2 t and + 1 of each 8-column block j
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int t = lane & 3;
  const int kv_lo = k0 + 64 * wg + 16 * (warp % 4) + (lane >> 2);
  const uint32_t k_wg = k_s + wg * kWgBox;
  const uint32_t v_wg = v_s + wg * kWgBox;
  float sc[32], dp[32];
  uint32_t pf[16] = {}, df[16] = {};
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;

  auto release = [&](int n) {           // this warp is done with step n
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(ring.empty(n % kWgStages));
  };
  // step n's lse·log2e (then D) at this thread's columns 2 t, + 8 j
  auto rows_of = [&](int n) {
    return base + L::kRowsOffset + (n % kWgStages) * kWgRowBytes + 8 * t;
  };
  auto probs = [&](int n, int q0) {     // Sᵀ → Pᵀ, once Sᵀ is in
    hopper::reg_fence(sc);
    const bool diagonal = q0 <= k0 + 64 * wg;     // some q row < a kv row
    const uint32_t lr = rows_of(n);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = ld_shared_f2(lr + 32 * j);
      const int c = q0 + 8 * j + 2 * t;
      float p[4] = {hopper::ex2(fmaf(sc[4 * j], sl2, -l.x)),
                    hopper::ex2(fmaf(sc[4 * j + 1], sl2, -l.y)),
                    hopper::ex2(fmaf(sc[4 * j + 2], sl2, -l.x)),
                    hopper::ex2(fmaf(sc[4 * j + 3], sl2, -l.y))};
      if (diagonal) {
        if (c < kv_lo) p[0] = 0.f;
        if (c + 1 < kv_lo) p[1] = 0.f;
        if (c < kv_lo + 8) p[2] = 0.f;
        if (c + 1 < kv_lo + 8) p[3] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[4 * j + e] = p[e];
    }
  };
  auto grads = [&](int n) {             // dPᵀ → dSᵀ / scale, once dPᵀ is in
    hopper::reg_fence(dp);
    const uint32_t dl = rows_of(n) + kWgStep * 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = ld_shared_f2(dl + 32 * j);
      dp[4 * j] = sc[4 * j] * (dp[4 * j] - d.x);
      dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - d.y);
      dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - d.x);
      dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - d.y);
    }
  };

  // One pass over the steps n0 .. n0 + steps - 1, adding dV += Pᵀ·dO into
  // `dva` and/or dK += dSᵀ·Q into `dka` (dSᵀ needs dPᵀ = V·dOᵀ too).
  auto pass = [&](auto want_dv, auto want_dk, float (&dva)[HD / 2],
                  float (&dka)[HD / 2], int n0) {
    constexpr bool kDv = decltype(want_dv)::value;
    constexpr bool kDk = decltype(want_dk)::value;
    auto logits = [&](int n) {          // Sᵀ = K·Qᵀ of step n
      const int st = n % kWgStages;
      hopper::mbar_wait(ring.full(st), (n / kWgStages) & 1);
      issue_abt<HD>(sc, k_wg, q_st(st));
      hopper::wgmma_commit();
    };
    auto slopes = [&](int n) {          // dPᵀ = V·dOᵀ, then dSᵀ
      if constexpr (kDk) {
        issue_abt<HD>(dp, v_wg, do_st(n % kWgStages));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        grads(n);
      }
    };
    auto pack = [&] {
      if constexpr (kDv) pack_frag(sc, pf);
      if constexpr (kDk) pack_frag(dp, df);
    };
    auto add = [&](int n) {
      const int st = n % kWgStages;
      if constexpr (kDv) issue_fy<HD>(dva, pf, do_st(st));
      if constexpr (kDk) issue_fy<HD>(dka, df, q_st(st));
      hopper::wgmma_commit();
    };
    auto settle = [&](int n) {          // step n's sums are in
      if constexpr (kDv) {
        hopper::reg_fence(dva);
        hopper::reg_fence(pf);
      }
      if constexpr (kDk) {
        hopper::reg_fence(dka);
        hopper::reg_fence(df);
      }
      release(n);
    };
    int q0 = k0;                        // of the step probs() takes next
    auto next_q0 = [&] {                // q tiles k0 .., then the next head
      q0 += kWgStep;
      if (q0 == k0 + per_head * kWgStep) q0 = k0;
    };
    if constexpr (kDv && kDk) {
      // both sums at once: no look-ahead (registers: see the note)
      for (int n = n0; n < n0 + steps; ++n) {
        logits(n);
        issue_abt<HD>(dp, v_wg, do_st(n % kWgStages));
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();        // Sᵀ is in
        probs(n, q0);
        next_q0();
        hopper::wgmma_wait<0>();        // so is dPᵀ
        grads(n);
        pack();
        add(n);
        hopper::wgmma_wait<0>();
        settle(n);
      }
      return;
    }
    // Step n's Sᵀ is issued beside step n - 1's sums and its exp2 runs
    // while they run; its dPᵀ follows once they are in (registers: see
    // the note).
    logits(n0);
    hopper::wgmma_wait<0>();
    probs(n0, q0);
    slopes(n0);
    for (int n = n0 + 1; n < n0 + steps; ++n) {
      pack();
      logits(n);
      add(n - 1);
      hopper::wgmma_wait<1>();          // Sᵀ of step n is in
      next_q0();
      probs(n, q0);
      hopper::wgmma_wait<0>();          // and step n - 1's sums
      settle(n - 1);
      slopes(n);
    }
    pack();
    add(n0 + steps - 1);
    hopper::wgmma_wait<0>();
    settle(n0 + steps - 1);
  };

  hopper::mbar_wait(ring.owned(), 0);
  const int64_t pitch = static_cast<int64_t>(nkv) * HD;
  const int64_t off = ((static_cast<int64_t>(bi) * s + kv_lo) * nkv + kvh) *
                          HD + 2 * t;
  const bool lo = kv_lo < s, hi = kv_lo + 8 < s;
  if constexpr (kPasses == 1) {         // both sums at once
    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
    pass(std::true_type{}, std::true_type{}, dva, dka, 0);
    store_wg<HD>(dk + off, dka, pitch, lo, hi, scale);
    store_wg<HD>(dv + off, dva, pitch, lo, hi, 1.f);
  } else {                              // dV, then dK, in one accumulator
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    pass(std::true_type{}, std::false_type{}, acc, acc, 0);
    store_wg<HD>(dv + off, acc, pitch, lo, hi, 1.f);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    pass(std::false_type{}, std::true_type{}, acc, acc, steps);
    store_wg<HD>(dk + off, acc, pitch, lo, hi, scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ rows,
                          bf16* __restrict__ dq, int b, int s, int s_pad,
                          int nq, int group, float sl2, float scale) {
  using L = WgCfg<HD>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (hopper::smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + L::kTileBytes;
  auto k_st = [&](int st) {
    return base + L::kStageOffset + 2 * st * L::kStepBytes;
  };
  auto v_st = [&](int st) { return k_st(st) + L::kStepBytes; };
  const WgRing<HD> ring{base + L::kBarOffset};

  // the work item: q tile iq (the last first), batch row bi, q head h; its
  // steps are the kv tiles 0 .. 2 iq + 1 that hold a row below s
  const int n_qt = (s + kWgTile - 1) / kWgTile;
  const int item = blockIdx.x;
  const int iq = n_qt - 1 - item / (b * nq);
  const int bi = (item / nq) % b;
  const int h = item % nq;
  const int kvh = h / group;
  const int q0 = iq * kWgTile;
  const int kv_steps = (s + kWgStep - 1) / kWgStep;
  const int steps = min(2 * (iq + 1), kv_steps);

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kWgConsumers) {                // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kWgConsumers) {
      hopper::tma_prefetch_map(&tm_q);
      hopper::tma_prefetch_map(&tm_k);
      hopper::tma_prefetch_map(&tm_v);
      hopper::tma_prefetch_map(&tm_do);
      ring.load_owned(q_s, &tm_q, do_s, &tm_do, h, q0, bi);
      for (int n = 0; n < steps; ++n) {
        const int st = n % kWgStages;
        ring.load_step(n, k_st(st), &tm_k, v_st(st), &tm_v, kvh,
                       n * kWgStep, bi, 0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup wg owns q rows 64 wg .. 64 wg + 63 of the tile; this
  // thread's rows are row_lo and row_lo + 8, its columns (kv rows of a
  // step) 8 j + 2 t and + 1 of each 8-column block j
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int t = lane & 3;
  const int row_lo = q0 + 64 * wg + 16 * (warp % 4) + (lane >> 2);
  const uint32_t q_wg = q_s + wg * kWgBox;
  const uint32_t do_wg = do_s + wg * kWgBox;
  // lse · log2e and D of both rows: the scratch is padded to s_pad ≥
  // q0 + 128, with +inf and 0 past s
  const float* lr = rows + (static_cast<int64_t>(bi) * nq + h) * s_pad;
  const int64_t d_part = static_cast<int64_t>(b) * nq * s_pad;
  const float l_lo = lr[row_lo], l_hi = lr[row_lo + 8];
  const float d_lo = lr[d_part + row_lo], d_hi = lr[d_part + row_lo + 8];
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(ring.empty(n % kWgStages));
  };
  float dqa[HD / 2], sc[32], dp[32];
  uint32_t df[16] = {};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;

  // At hd 64 a step's S and dP are issued together beside the last step's
  // sum; at hd 128 only S is, and dP follows once that sum is in
  // (registers: see the note).
  constexpr bool kDpAhead = HD == 64;
  auto logits = [&](int n) {            // S = Q·Kᵀ (and dP = dO·Vᵀ)
    const int st = n % kWgStages;
    hopper::mbar_wait(ring.full(st), (n / kWgStages) & 1);
    issue_abt<HD>(sc, q_wg, k_st(st));
    hopper::wgmma_commit();
    if constexpr (kDpAhead) {
      issue_abt<HD>(dp, do_wg, v_st(st));
      hopper::wgmma_commit();
    }
  };
  auto probs = [&](int n) {             // S → P, once S is in
    hopper::reg_fence(sc);
    const int k0 = n * kWgStep;
    const bool diagonal = k0 >= q0 + 64 * wg;     // some kv row > a q row
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k0 + 8 * j + 2 * t;
      float p[4] = {hopper::ex2(fmaf(sc[4 * j], sl2, -l_lo)),
                    hopper::ex2(fmaf(sc[4 * j + 1], sl2, -l_lo)),
                    hopper::ex2(fmaf(sc[4 * j + 2], sl2, -l_hi)),
                    hopper::ex2(fmaf(sc[4 * j + 3], sl2, -l_hi))};
      if (diagonal) {
        if (c > row_lo) p[0] = 0.f;
        if (c + 1 > row_lo) p[1] = 0.f;
        if (c > row_lo + 8) p[2] = 0.f;
        if (c + 1 > row_lo + 8) p[3] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[4 * j + e] = p[e];
    }
  };
  auto grads = [&] {                    // dP → dS / scale, once dP is in
    hopper::reg_fence(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dp[4 * j] = sc[4 * j] * (dp[4 * j] - d_lo);
      dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - d_lo);
      dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - d_hi);
      dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - d_hi);
    }
  };
  auto add = [&](int n) {               // dQ += dS·K
    issue_fy<HD>(dqa, df, k_st(n % kWgStages));
    hopper::wgmma_commit();
  };
  auto settle = [&](int n) {            // step n's sum is in
    hopper::reg_fence(dqa);
    hopper::reg_fence(df);
    release(n);
  };
  auto slopes = [&](int n) {            // dP where not issued with S
    if constexpr (!kDpAhead) {
      issue_abt<HD>(dp, do_wg, v_st(n % kWgStages));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
    }
    grads();
  };
  hopper::mbar_wait(ring.owned(), 0);

  logits(0);                            // every item has a step
  hopper::wgmma_wait<kDpAhead ? 1 : 0>();
  probs(0);
  if constexpr (kDpAhead) hopper::wgmma_wait<0>();
  slopes(0);
  for (int n = 1; n < steps; ++n) {
    pack_frag(dp, df);
    logits(n);
    add(n - 1);
    hopper::wgmma_wait<kDpAhead ? 2 : 1>();         // S of step n is in
    probs(n);
    if constexpr (kDpAhead) {
      hopper::wgmma_wait<1>();                      // so is dP
      grads();
      hopper::wgmma_wait<0>();                      // and step n - 1's sum
      settle(n - 1);
    } else {
      hopper::wgmma_wait<0>();                      // step n - 1's sum
      settle(n - 1);
      slopes(n);
    }
  }
  pack_frag(dp, df);
  add(steps - 1);
  hopper::wgmma_wait<0>();
  settle(steps - 1);

  const int64_t pitch = static_cast<int64_t>(nq) * HD;
  const int64_t off = ((static_cast<int64_t>(bi) * s + row_lo) * nq + h) *
                          HD + 2 * t;
  store_wg<HD>(dq + off, dqa, pitch, row_lo < s, row_lo + 8 < s, scale);
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

// D into `delta`; with kRows, lse · log2e and D into the padded scratch
// of s_rows positions a row
template <typename T, int HD, bool kRows = false>
int launch_dot(const Args& a, int s_rows, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(a.b) * s_rows * a.nq;
  const int64_t blocks = (rows * (HD * sizeof(T) / 16) + 255) / 256;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dot_kernel<T, HD, kRows><<<static_cast<unsigned>(blocks), 256, 0,
                                       stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.b, a.s, s_rows, a.nq, a.ds);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const Args& a, cudaStream_t stream) {
  int err = launch_dot<float, HD>(a, a.s, stream);
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

// A failed tensor-map encode is returned as kMapError + the CUresult.
constexpr int kMapError = 100000;

// calls that launched the wgmma kernels, for a check that a path took them
long long g_wgmma_calls = 0;

template <int HD>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  const int s_pad = (a.s + kWgTile - 1) / kWgTile * kWgTile;
  int err = launch_dot<bf16, HD, true>(a, s_pad, stream);
  if (err) return err;
  CUtensorMap maps[4];                  // q, k, v, dO
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const int heads[4] = {a.nq, a.nkv, a.nkv, a.nq};
  const Strides st[4] = {a.qs, a.ks, a.vs, a.ds};
  for (int i = 0; i < 4; ++i) {
    const int r = hopper::encode_heads_map(&maps[i], ptrs[i], a.b, a.s,
                                           heads[i], HD, st[i].b, st[i].s,
                                           st[i].h, kWgStep);
    if (r != 0) return kMapError + r;
  }
  constexpr size_t smem = WgCfg<HD>::kSmem;
  const int tiles = (a.s + kWgTile - 1) / kWgTile;
  const int group = a.nq / a.nkv;
  const float sl2 = a.scale * kLog2e;
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<HD>;
  cudaError_t e = attn::allow_smem(dkdv, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv<<<tiles * a.nkv * a.b, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.b, a.s, s_pad, a.nq, a.nkv, group, sl2,
      a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto dq = flash_bwd_dq_wgmma_kernel<HD>;
  e = attn::allow_smem(dq, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq<<<tiles * a.nq * a.b, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.delta, static_cast<bf16*>(a.dq),
      a.b, a.s, s_pad, a.nq, group, sl2, a.scale);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++g_wgmma_calls;
  return static_cast<int>(e);
}

template <int HD>
int launch_mma(const Args& a, cudaStream_t stream) {
  int err = launch_dot<bf16, HD>(a, a.s, stream);
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

// bf16 on the tensor cores: wgmma at head dims 64 and 128, mma.sync below
template <int HD>
int launch_bf16(const Args& a, cudaStream_t stream) {
  if constexpr (HD >= 64)
    return launch_wgmma<HD>(a, stream);
  else
    return launch_mma<HD>(a, stream);
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
// are the forward's contiguous outputs; delta is an f32 scratch the first
// kernel fills: (2, b, nq, s_pad) with s_pad = s rounded up to a multiple of
// 128 for bf16 at head dims 64 and 128, (b, nq, s) otherwise
// (`flash_bwd_plan` in kernels/flash_attention/kernel.py sizes it); dq
// (b, s, nq, hd), dk and dv (b, s, nkv, hd) are contiguous outputs of q's
// dtype. `bf16` says the tensors hold bf16 (else f32). Launches the three
// kernels asynchronously on `stream` and returns the first CUDA error, a
// failed TMA tensor-map encode as kMapError + its CUresult, or 0.
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

// How many calls launched the TMA + wgmma kernels (bf16 at head dims 64
// and 128) since the library was loaded.
extern "C" long long flash_attention_bwd_wgmma_calls() {
  return g_wgmma_calls;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  if (err >= kMapError) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
