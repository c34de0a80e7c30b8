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
// the model's type, runs on the tensor cores (`flash_mma_kernel`:
// mma.sync, the logits and probabilities kept in registers). f32 runs on
// the CUDA cores in fp32 (`flash_kernel`: each thread owns a 4 x 4 block
// of the 64 x 64 logit tile and a 4 x hd/16 block of the output, with
// float4 shared-memory reads), where the tensor cores would round the
// operands. wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tile.cuh"

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
    attn::Tile<float, HD, kBlock> t;
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
    attn::Tile<float, HD, kBlock> kt, vt;
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
    for (int w = 0; w < CW; ++w) attn::store_out(o + w, acc[i][w] / den);
  }
}


// ---------------------------------------------------------------------------
// bf16: the same function on the tensor cores (mma.sync m16n8k16, fp32
// accumulators), flash-attention-2 style. A block of 4 warps owns a 64-row
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a · b for a 16x16 bf16 A (row), 16x8 bf16 B (col), 16x8 f32 D
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int b, int s, int nq, int nkv, const int64_t* st,
                       float scale, cudaStream_t stream) {
  auto kernel = flash_mma_kernel<HD>;
  constexpr size_t smem = mma_smem_bytes<HD>();
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s + kBlock - 1) / kBlock, nq, b);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      s, nq, nq / nkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int s, int nq, int nkv, const int64_t* st,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_kernel<HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s + kBlock - 1) / kBlock, nq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, nq, nq / nkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

// f32 on the CUDA cores, bf16 on the tensor cores
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int b, int s, int nq, int nkv, int hd, bool bf16,
                     const int64_t* st, float scale, cudaStream_t stream) {
#define FLASH_CASE(HD)                                                      \
  case HD:                                                                  \
    return bf16 ? launch_mma<HD>(q, k, v, out, b, s, nq, nkv, st, scale,    \
                                 stream)                                    \
                : launch<HD>(q, k, v, out, b, s, nq, nkv, st, scale, stream);
  switch (hd) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// Plain C entry for ctypes. q/k/v/out are device pointers; the strides are
// in elements, for the batch, sequence and head axes of q, k and v (the
// head_dim axis is contiguous); out is a contiguous (b, s, nq, hd) tensor.
// `bf16` says the tensors hold bf16 (else f32). Launches asynchronously on
// `stream` and returns the first CUDA error, or 0.
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
  return static_cast<int>(
      dispatch(q, k, v, out, b, s, nq, nkv, hd, bf16 != 0, st, scale, cs));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
