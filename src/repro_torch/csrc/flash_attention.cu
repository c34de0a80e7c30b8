// Causal GQA attention forward; hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:22-88) and its transposing
// wrapper (src/repro/kernels/flash_attention/ops.py): the prefill and
// training attention of the dense LM (`models/layers.py` causal_attention).
//
// What it computes, for q (b, s, nq, hd), k/v (b, s, nkv, hd), f32 or bf16:
//   out[b, i, h] = sum_{j <= i} softmax_j(q[b,i,h]·k[b,j,h/g] · hd^-1/2)
//                  · v[b, j, h/g]          g = nq / nkv
// with the online softmax in fp32 (m, l, acc), masked logits set to
// NEG_INF = -1e30 and the denominator floored at 1e-30, as the TPU kernel
// does; out in q's dtype.
//
// Layout: one block per (q tile of 64 rows, q head, batch row), largest
// tiles launched first. The block stages its q tile in shared memory, then
// loops over the kv tiles up to the diagonal (tiles above it are skipped,
// as on the TPU: about s²/2 of the work). The TPU wrapper needed s to be a
// multiple of its block; here rows past s are zero-filled and never
// written, and the causal mask covers every column past s, so any s runs.
// The operands are read in the model layout through their strides, so no
// transposed copy is made.
//
// What bounds it: operations. At tinyllama's prefill (b 8, s 2048, 32/4
// heads, hd 64) one launch does 1.37e11 causal FLOPs for 151 MB of
// operands, far above the card's ratio of operations to bytes. So bf16,
// the model's type, runs on the tensor cores. At head dims 64 and 128
// (every registered config) that is `flash_wgmma_kernel`: TMA loads into a
// ring of shared-memory stages and wgmma products, with 128-row q tiles
// (design below). Head dims 16 and 32 (smoke twins only) keep
// `flash_mma_kernel` (mma.sync, 64-row tiles). f32 runs on the CUDA cores
// in fp32 (`flash_kernel`: each thread owns a 4 x 4 block of the 64 x 64
// logit tile and a 4 x hd/16 block of the output, with float4
// shared-memory reads), where the tensor cores would round the operands.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tile.cuh"
#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using attn::kThreads;
constexpr int kBlock = 64;            // q rows and kv rows per tile
constexpr int kPP = kBlock + 4;       // pitch of the probability tile

template <int HD>
constexpr size_t smem_bytes() {
  return (3 * kBlock * attn::pitch<HD>() + kBlock * kPP) * sizeof(float);
}

// max and sum over the 16 lanes (tx = 0..15) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int s, int nq,
             int group, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
             int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
             float scale) {
  constexpr int P = attn::pitch<HD>();
  constexpr int CW = HD / 16;          // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlock * P;
  float* v_s = k_s + kBlock * P;
  float* p_s = v_s + kBlock * P;

  const int iq = gridDim.x - 1 - blockIdx.x;       // largest tiles first
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int kvh = h / group;
  const int q0 = iq * kBlock;
  const int tx = threadIdx.x % 16;                  // column lane of a row
  const int ty = threadIdx.x / 16;                  // rows ty + 16 i

  {
    attn::Tile<HD, kBlock> t;
    t.fetch(q + bi * qsb + q0 * qss + h * qsh, qss, s - q0);
    t.store(q_s);
  }
  const float* kb = k + bi * ksb + kvh * ksh;
  const float* vb = v + bi * vsb + kvh * vsh;

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = attn::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) acc[i][w] = 0.f;
  }

  for (int jt = 0; jt <= iq; ++jt) {
    const int k0 = jt * kBlock;
    attn::Tile<HD, kBlock> kt, vt;
    kt.fetch(kb + k0 * kss, kss, s - k0);
    vt.fetch(vb + k0 * vss, vss, s - k0);
    __syncthreads();                 // the last tile's k_s/v_s/p_s are read
    kt.store(k_s);
    vt.store(v_s);
    __syncthreads();

    // logits of rows ty + 16 i against columns tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * P + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = attn::dot4(qv[i], kv[j],
                                                          sc[i][j]);
    }

    // online softmax; the causal mask also covers every column past s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = attn::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x = col <= row ? sc[i][j] * scale : attn::kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * kPP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int w = 0; w < CW; ++w) acc[i][w] *= alpha;
    }
    __syncthreads();

    // acc[i][w] += p[row i, c] · v[c, tx · CW + w]
#pragma unroll 2
    for (int c = 0; c < kBlock; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPP +
                                                 c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[CW];
        const float* vr = v_s + (c + cc) * P + tx * CW;
        if constexpr (CW % 4 == 0) {
#pragma unroll
          for (int w = 0; w < CW; w += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vr + w);
            vv[w] = x.x;
            vv[w + 1] = x.y;
            vv[w + 2] = x.z;
            vv[w + 3] = x.w;
          }
        } else if constexpr (CW == 2) {
          const float2 x = *reinterpret_cast<const float2*>(vr);
          vv[0] = x.x;
          vv[1] = x.y;
        } else {
          vv[0] = vr[0];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                        : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int w = 0; w < CW; ++w) acc[i][w] = fmaf(p, vv[w], acc[i][w]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float den = fmaxf(l[i], attn::kMinL);
    float* o = out + ((bi * s + row) * nq + h) * HD + tx * CW;
#pragma unroll
    for (int w = 0; w < CW; ++w) o[w] = acc[i][w] / den;
  }
}


// ---------------------------------------------------------------------------
// bf16 at head dims 16 and 32: the same function on the tensor cores
// (mma.sync m16n8k16, fp32 accumulators), flash-attention-2 style. A block of 4 warps owns a 64-row
// q tile, each warp 16 rows; K and V tiles of 64 rows stream through a
// two-stage cp.async ring in shared memory (bf16, pitch hd + 8 so the eight
// rows of an ldmatrix fall in distinct banks). The logits stay in the
// accumulator registers, the online softmax runs on them in fp32, and the
// probabilities are re-packed as bf16 A fragments for P·V without a trip
// through shared memory. P is rounded to bf16 for that product (the TPU
// kernel multiplies in f32): within the bf16 tolerance of the output.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;      // 4 warps x 16 q rows

template <int HD>
__host__ __device__ constexpr int mma_pitch() { return HD + 8; }   // bf16 elements

template <int HD>
constexpr size_t mma_smem_bytes() {
  return 5 * kBlock * mma_pitch<HD>() * sizeof(__nv_bfloat16);  // q + 2x(k, v)
}

using hopper::pack_bf16;
using hopper::smem_addr;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16;

// async copy of rows [0, valid) of a 64-row tile into shared memory at
// pitch hd + 8; the other rows are zero-filled
template <int HD>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int valid) {
  constexpr int kChunks = HD / 8;       // 16-byte chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool live = r < valid;
    cp_async16(dst + r * mma_pitch<HD>() + c,
               src + (live ? r : 0) * row_stride + c, live ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int s, int nq, int group,
                 int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                 int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                 int64_t vsh, float scale) {
  constexpr int P = mma_pitch<HD>();
  constexpr int kSteps = HD / 16;       // k steps of q·k over head_dim
  constexpr int kNB = kBlock / 8;       // 8-column blocks of logits
  constexpr int kOB = HD / 8;           // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + kBlock * P;   // [stage][k | v][64][P]

  const int iq = gridDim.x - 1 - blockIdx.x;       // largest tiles first
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int kvh = h / group;
  const int q0 = iq * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;              // accumulator row (and row + 8)
  const int t = lane & 3;               // accumulator column pair
  const int row_lo = q0 + 16 * warp + g;
  const int row_hi = row_lo + 8;
  const float sl2 = scale * 1.4426950408889634f;   // exp(x) = 2^(x log2 e)

  const __nv_bfloat16* kb = k + bi * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + bi * vsb + kvh * vsh;
  copy_tile<HD>(q_s, q + bi * qsb + q0 * qss + h * qsh, qss, s - q0);
  cp_async_commit();
  copy_tile<HD>(kv_s, kb, kss, s);
  copy_tile<HD>(kv_s + kBlock * P, vb, vss, s);
  cp_async_commit();

  uint32_t qf[kSteps][4];
  float o[kOB][4];
#pragma unroll
  for (int j = 0; j < kOB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_lo = attn::kNegInf, m_hi = attn::kNegInf;   // raw-logit maxima
  float l_lo = 0.f, l_hi = 0.f;         // this thread's share of the sums

  for (int jt = 0; jt <= iq; ++jt) {
    const int k0 = jt * kBlock;
    if (jt < iq) {                      // next tile into the other stage
      __nv_bfloat16* nxt = kv_s + ((jt + 1) & 1) * 2 * kBlock * P;
      copy_tile<HD>(nxt, kb + (k0 + kBlock) * kss, kss, s - k0 - kBlock);
      copy_tile<HD>(nxt + kBlock * P, vb + (k0 + kBlock) * vss, vss,
                    s - k0 - kBlock);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* k_s = kv_s + (jt & 1) * 2 * kBlock * P;
    const __nv_bfloat16* v_s = k_s + kBlock * P;
    if (jt == 0) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        ldmatrix_x4(qf[ks], q_s + (16 * warp + (lane % 16)) * P + ks * 16 +
                                (lane / 16) * 8);
    }

    // raw logits q·k of rows (row_lo, row_hi) x columns 8 j + 2 t (+1)
    float sc[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int j2 = 0; j2 < kNB / 2; ++j2) {
        uint32_t b[4];
        ldmatrix_x4(b, k_s + (16 * j2 + (lane % 8) + (lane / 16) * 8) * P +
                           ks * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(sc[2 * j2], qf[ks], b[0], b[1]);
        mma_bf16(sc[2 * j2 + 1], qf[ks], b[2], b[3]);
      }
    }
    if (jt == iq) {                     // diagonal tile: causal mask
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const int col = k0 + 8 * j + 2 * t;
        if (col > row_lo) sc[j][0] = attn::kNegInf;
        if (col + 1 > row_lo) sc[j][1] = attn::kNegInf;
        if (col > row_hi) sc[j][2] = attn::kNegInf;
        if (col + 1 > row_hi) sc[j][3] = attn::kNegInf;
      }
    }

    // online softmax on the registers (the 4 lanes of a row share m)
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[j][0], sc[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float a_lo = exp2f((m_lo - mx_lo) * sl2);
    const float a_hi = exp2f((m_hi - mx_hi) * sl2);
    m_lo = mx_lo;
    m_hi = mx_hi;
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int j = 0; j < kOB; ++j) {
      o[j][0] *= a_lo;
      o[j][1] *= a_lo;
      o[j][2] *= a_hi;
      o[j][3] *= a_hi;
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      sc[j][0] = exp2f((sc[j][0] - m_lo) * sl2);
      sc[j][1] = exp2f((sc[j][1] - m_lo) * sl2);
      sc[j][2] = exp2f((sc[j][2] - m_hi) * sl2);
      sc[j][3] = exp2f((sc[j][3] - m_hi) * sl2);
      l_lo += sc[j][0] + sc[j][1];
      l_hi += sc[j][2] + sc[j][3];
    }

    // o += p · v: p re-packed as A fragments, v through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int j2 = 0; j2 < kOB / 2; ++j2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_s + (16 * kk + (lane % 8) +
                                    ((lane / 8) % 2) * 8) * P +
                                 16 * j2 + (lane / 16) * 8);
        mma_bf16(o[2 * j2], pa, b[0], b[1]);
        mma_bf16(o[2 * j2 + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();                    // this stage is refilled next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float d_lo = fmaxf(l_lo, attn::kMinL);
  const float d_hi = fmaxf(l_hi, attn::kMinL);
#pragma unroll
  for (int j = 0; j < kOB; ++j) {
    const int col = 8 * j + 2 * t;
    if (row_lo < s)
      *reinterpret_cast<uint32_t*>(out + ((bi * s + row_lo) * nq + h) * HD +
                                   col) =
          pack_bf16(o[j][0] / d_lo, o[j][1] / d_lo);
    if (row_hi < s)
      *reinterpret_cast<uint32_t*>(out + ((bi * s + row_hi) * nq + h) * HD +
                                   col) =
          pack_bf16(o[j][2] / d_hi, o[j][3] / d_hi);
  }
}

// ---------------------------------------------------------------------------
// bf16 at head dims 64 and 128: the same function with Hopper's TMA and
// wgmma, 128-row q tiles. A work item is one (q tile, q head, batch row);
// the items are ordered longest first (most kv tiles), with the heads of
// one kv group side by side so that they share its k and v in L2. A
// persistent grid of one block per SM walks them, block k taking items k,
// k + grid, ..; a block has 384 threads in three warpgroups:
//
//  * a producer warpgroup that gives up its registers (setmaxnreg) and of
//    which one thread issues every load by TMA from 4-D tensor maps over
//    the model layout (dims hd, heads, s, b; box 64 columns x 128 rows,
//    128-byte swizzle; at hd 128 a row is two boxes). Rows past s arrive
//    as zeros; the causal mask covers every column past s, and rows past
//    s are never stored. The q tile has its own full and empty barriers,
//    so the next item's q loads while this one finishes; k and v tiles of
//    128 rows go through a ring of 3 stages with a full and an empty
//    mbarrier each, continuing from item to item.
//  * two consumer warpgroups of 64 q rows each. For kv tile j a warpgroup
//    computes S_j = q·k_jᵀ (64 x 128, f32) by hd/16 wgmma m64n128k16 from
//    shared memory (both operands K-major), masks the diagonal tile, runs
//    the online softmax on the accumulator registers (row max and sum over
//    the 4 lanes that share a row, exp2 with the scale folded in), packs P
//    to bf16 in registers (an m64n128 accumulator, packed in pairs, is the
//    A fragment of the next product) and adds P·V by 8 wgmma m64n{hd}k16
//    with A from registers and V, whose rows are kv positions, as an
//    MN-major B operand (the transpose bit). P makes no trip through shared
//    memory. Tiles above the diagonal are skipped. S_j is issued together
//    with P_{j-1}·V_{j-1}, and the softmax of S_j runs while the second
//    product (and the other warpgroup's products) run.
//
// At hd 64 the softmax, not the products, sets the pace: a 128 x 128 tile
// takes 16,384 exp2 on the special function units (16 a clock an SM), as
// many clocks as its two products take on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kTile = 128;            // q rows per block, kv rows per stage
constexpr int kBoxBytes = kTile * 64 * 2;   // one 128 x 64 bf16 TMA box
constexpr int kConsumers = 256;       // two warpgroups of 64 q rows
constexpr int kWgThreads = kConsumers + 128;   // and the producer's
constexpr int kStages = 3;            // depth of the k/v ring

template <int HD>
struct WgCfg {
  static constexpr int kTileBytes = (HD / 64) * kBoxBytes;   // q, k or v
  // q | k0 v0 | k1 v1 | .. then the barriers (full and empty per stage,
  // q full, q empty); 1 KB of slack to align the base to the 1,024-byte
  // swizzle atom
  static constexpr int kBarOffset = (1 + 2 * kStages) * kTileBytes;
  static constexpr size_t kSmem = kBarOffset + (2 * kStages + 2) * 8 + 1024;
};

// S = q · kᵀ for a warpgroup's 64 rows: k step kk reads 16 columns, 32
// bytes into box kk / 4 of both K-major tiles
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_wg,
                                         uint32_t k_s) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    hopper::wgmma_m64n128k16_ss(sc, hopper::sw128_desc(q_wg + off, 16, 1024),
                                hopper::sw128_desc(k_s + off, 16, 1024),
                                kk > 0);
  }
  hopper::wgmma_commit();
}

// o += P · v: k step kk takes pa[4 kk ..] and kv rows 16 kk .. of v, an
// MN-major operand (2,048 bytes a step; a 64-column block per box)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[32],
                                         uint32_t v_s) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint64_t vd = hopper::sw128_desc(v_s + kk * 2048, kBoxBytes, 1024);
    if constexpr (HD == 64)
      hopper::wgmma_m64n64k16_rs(o, pa + 4 * kk, vd);
    else
      hopper::wgmma_m64n128k16_rs(o, pa + 4 * kk, vd);
  }
  hopper::wgmma_commit();
}

// The online-softmax state of a thread's two rows.
struct RowState {
  float m_lo = attn::kNegInf, m_hi = attn::kNegInf;   // raw-logit maxima
  float l_lo = 0.f, l_hi = 0.f;         // this thread's share of the sums

  // Mask the diagonal tile (columns k0 ..), fold S into the maxima, and
  // overwrite S with p = 2^((S − m) · sl2); returns the factors (a_lo,
  // a_hi) by which the output accumulated so far must be scaled.
  __device__ __forceinline__ float2 step(float (&sc)[64], bool diagonal,
                                         int k0, int row_lo, int t,
                                         float sl2) {
    const int row_hi = row_lo + 8;
    if (diagonal) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = k0 + 8 * j + 2 * t;
        if (col > row_lo) sc[4 * j] = attn::kNegInf;
        if (col + 1 > row_lo) sc[4 * j + 1] = attn::kNegInf;
        if (col > row_hi) sc[4 * j + 2] = attn::kNegInf;
        if (col + 1 > row_hi) sc[4 * j + 3] = attn::kNegInf;
      }
    }
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // the 4 lanes of a row
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float2 a = make_float2(hopper::ex2((m_lo - mx_lo) * sl2),
                                 hopper::ex2((m_hi - mx_hi) * sl2));
    m_lo = mx_lo;
    m_hi = mx_hi;
    const float ms_lo = mx_lo * sl2, ms_hi = mx_hi * sl2;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j] = hopper::ex2(fmaf(sc[4 * j], sl2, -ms_lo));
      sc[4 * j + 1] = hopper::ex2(fmaf(sc[4 * j + 1], sl2, -ms_lo));
      sc[4 * j + 2] = hopper::ex2(fmaf(sc[4 * j + 2], sl2, -ms_hi));
      sc[4 * j + 3] = hopper::ex2(fmaf(sc[4 * j + 3], sl2, -ms_hi));
      sum_lo += sc[4 * j] + sc[4 * j + 1];
      sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_lo = l_lo * a.x + sum_lo;
    l_hi = l_hi * a.y + sum_hi;
    return a;
  }
};

// P in bf16: pa[4 kk .. 4 kk + 3] is the A fragment of kv rows 16 kk ..
// 16 kk + 15 (rows row_lo / row_hi, column pairs 2 t and 8 + 2 t)
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float2 a) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= a.x;
    o[4 * j + 1] *= a.x;
    o[4 * j + 2] *= a.y;
    o[4 * j + 3] *= a.y;
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, int b, int s, int nq,
                   int group, float sl2) {
  using L = WgCfg<HD>;
  constexpr int kBoxes = HD / 64;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bars = base + L::kBarOffset;
  auto k_tile = [&](int st) { return base + (1 + 2 * st) * L::kTileBytes; };
  auto v_tile = [&](int st) { return base + (2 + 2 * st) * L::kTileBytes; };
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  const uint32_t q_full = bars + 16 * kStages;
  const uint32_t q_empty = q_full + 8;

  // work items, longest first: item i is q tile n_qt - 1 - i / (b nq) of
  // batch row (i / nq) % b and q head i % nq; block k takes items k,
  // k + gridDim.x, .. (one each when the grid covers them all)
  const int n_qt = (s + kTile - 1) / kTile;
  const int n_items = n_qt * b * nq;
  struct Item { int iq, bi, h; };
  auto item_of = [&](int i) {
    return Item{n_qt - 1 - i / (b * nq), (i / nq) % b, i % nq};
  };
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), kConsumers / 32);
    }
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, kConsumers / 32);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {                  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch_map(&tm_q);
      hopper::tma_prefetch_map(&tm_k);
      hopper::tma_prefetch_map(&tm_v);
      int it = 0;                                   // k/v tiles loaded
      for (int i = blockIdx.x, n = 0; i < n_items; i += gridDim.x, ++n) {
        const Item w = item_of(i);
        const int kvh = w.h / group;
        if (n > 0) hopper::mbar_wait(q_empty, (n - 1) & 1);
        hopper::mbar_expect_tx(q_full, L::kTileBytes);
        for (int c = 0; c < kBoxes; ++c)
          hopper::tma_load_4d(q_s + c * kBoxBytes, &tm_q, q_full, 64 * c, w.h,
                              w.iq * kTile, w.bi);
        for (int jt = 0; jt <= w.iq; ++jt, ++it) {  // kv tiles to the diagonal
          const int st = it % kStages;
          if (it >= kStages)                        // consumers done with it
            hopper::mbar_wait(empty(st), (it / kStages - 1) & 1);
          hopper::mbar_expect_tx(full(st), 2 * L::kTileBytes);
          for (int c = 0; c < kBoxes; ++c) {
            hopper::tma_load_4d(k_tile(st) + c * kBoxBytes, &tm_k, full(st),
                                64 * c, kvh, jt * kTile, w.bi);
            hopper::tma_load_4d(v_tile(st) + c * kBoxBytes, &tm_v, full(st),
                                64 * c, kvh, jt * kTile, w.bi);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // consumer warpgroup wg owns q rows 64 wg .. 64 wg + 63 of a tile; this
  // thread's accumulator rows are row_lo and row_lo + 8, its columns
  // 8 j + 2 t and + 1 of each 8-column block j
  const int wg = warp / 4;
  const int t = lane & 3;
  const uint32_t q_wg = q_s + wg * 64 * 128;       // 64 rows of 128 bytes
  auto arrive = [&](uint32_t bar) {                 // this warp is done
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };

  float o[HD / 2];
  float sc[64];
  uint32_t pa[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  int it = 0;                                       // k/v tiles consumed
  for (int i = blockIdx.x, n = 0; i < n_items; i += gridDim.x, ++n) {
    const Item w = item_of(i);
    const int n_tiles = w.iq + 1;
    const int row_lo = w.iq * kTile + 64 * wg + 16 * (warp % 4) + (lane >> 2);
    auto wait_full = [&](int jt) {
      hopper::mbar_wait(full((it + jt) % kStages), ((it + jt) / kStages) & 1);
    };
    auto k_of = [&](int jt) { return k_tile((it + jt) % kStages); };
    auto v_of = [&](int jt) { return v_tile((it + jt) % kStages); };
    auto release = [&](int jt) { arrive(empty((it + jt) % kStages)); };
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
    RowState rs;
    hopper::mbar_wait(q_full, n & 1);

    wait_full(0);
    issue_qk<HD>(sc, q_wg, k_of(0));
    hopper::wgmma_wait<0>();
    hopper::reg_fence(sc);
    rs.step(sc, w.iq == 0, 0, row_lo, t, sl2);
    for (int jt = 1; jt < n_tiles; ++jt) {
      // o holds everything but P_{jt-1} · v_{jt-1}; sc holds P_{jt-1}
      wait_full(jt);
      pack_p(sc, pa);
      issue_qk<HD>(sc, q_wg, k_of(jt));
      issue_pv<HD>(o, pa, v_of(jt - 1));
      hopper::wgmma_wait<1>();                      // S_jt is in
      hopper::reg_fence(sc);
      const float2 a = rs.step(sc, jt == w.iq, jt * kTile, row_lo, t, sl2);
      hopper::wgmma_wait<0>();                      // so is P_{jt-1} · v
      hopper::reg_fence(o);
      hopper::reg_fence(pa);
      release(jt - 1);
      rescale(o, a);
    }
    arrive(q_empty);                                // q is read
    pack_p(sc, pa);
    issue_pv<HD>(o, pa, v_of(n_tiles - 1));
    hopper::wgmma_wait<0>();
    hopper::reg_fence(o);
    hopper::reg_fence(pa);
    release(n_tiles - 1);
    it += n_tiles;

    float l_lo = rs.l_lo, l_hi = rs.l_hi;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float d_lo = fmaxf(l_lo, attn::kMinL);
    const float d_hi = fmaxf(l_hi, attn::kMinL);
    __nv_bfloat16* o_lo = out + ((static_cast<int64_t>(w.bi) * s + row_lo) *
                                 nq + w.h) * HD + 2 * t;
    __nv_bfloat16* o_hi = o_lo + static_cast<int64_t>(8) * nq * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (row_lo < s)
        *reinterpret_cast<uint32_t*>(o_lo + 8 * j) =
            pack_bf16(o[4 * j] / d_lo, o[4 * j + 1] / d_lo);
      if (row_lo + 8 < s)
        *reinterpret_cast<uint32_t*>(o_hi + 8 * j) =
            pack_bf16(o[4 * j + 2] / d_hi, o[4 * j + 3] / d_hi);
    }
  }
}

// A failed tensor-map encode is returned as kMapError + the CUresult.
constexpr int kMapError = 100000;

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int b, int s, int nq, int nkv, const int64_t* st, float scale,
                 cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int heads[3] = {nq, nkv, nkv};
  for (int i = 0; i < 3; ++i) {
    const int r = hopper::encode_heads_map(&maps[i], ptrs[i], b, s, heads[i],
                                           HD, st[3 * i], st[3 * i + 1],
                                           st[3 * i + 2], kTile);
    if (r != 0) return kMapError + r;
  }
  auto kernel = flash_wgmma_kernel<HD>;
  constexpr size_t smem = WgCfg<HD>::kSmem;
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;                // at most one block per SM
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = (s + kTile - 1) / kTile * b * nq;
  const int grid = items < sms ? items : sms;
  kernel<<<grid, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), b, s, nq,
      nq / nkv, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out,
                       int b, int s, int nq, int nkv, const int64_t* st,
                       float scale, cudaStream_t stream) {
  auto kernel = flash_mma_kernel<HD>;
  constexpr size_t smem = mma_smem_bytes<HD>();
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s + kBlock - 1) / kBlock, nq, b);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      s, nq, nq / nkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores: wgmma at head dims 64 and 128, mma.sync below
template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out, int b,
              int s, int nq, int nkv, const int64_t* st, float scale,
              cudaStream_t stream) {
  if constexpr (HD >= 64)
    return launch_wgmma<HD>(q, k, v, out, b, s, nq, nkv, st, scale, stream);
  else
    return launch_mma<HD>(q, k, v, out, b, s, nq, nkv, st, scale, stream);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
                   int b, int s, int nq, int nkv, const int64_t* st,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_kernel<HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s + kBlock - 1) / kBlock, nq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, nq, nq / nkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return static_cast<int>(cudaGetLastError());
}

// f32 on the CUDA cores, bf16 on the tensor cores
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int s, int nq, int nkv, int hd, bool bf16, const int64_t* st,
             float scale, cudaStream_t stream) {
#define FLASH_CASE(HD)                                                      \
  case HD:                                                                  \
    return bf16 ? launch_tc<HD>(q, k, v, out, b, s, nq, nkv, st, scale,     \
                                stream)                                     \
                : launch<HD>(q, k, v, out, b, s, nq, nkv, st, scale, stream);
  switch (hd) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// Plain C entry for ctypes. q/k/v/out are device pointers; the strides are
// in elements, for the batch, sequence and head axes of q, k and v (the
// head_dim axis is contiguous); out is a contiguous (b, s, nq, hd) tensor.
// `bf16` says the tensors hold bf16 (else f32). Launches asynchronously on
// `stream` and returns the first CUDA error, a failed TMA tensor-map
// encode as kMapError + its CUresult, or 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int s, int nq, int nkv,
                               int hd, int64_t qsb, int64_t qss, int64_t qsh,
                               int64_t ksb, int64_t kss, int64_t ksh,
                               int64_t vsb, int64_t vss, int64_t vsh,
                               float scale, int bf16, void* stream) {
  if (b <= 0 || s <= 0 || nkv <= 0 || nq % nkv || b > 65535 || nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return dispatch(q, k, v, out, b, s, nq, nkv, hd, bf16 != 0, st, scale, cs);
}

extern "C" const char* flash_attention_error_string(int err) {
  if (err >= kMapError) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
