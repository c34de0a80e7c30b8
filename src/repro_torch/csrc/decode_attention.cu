// Single-token GQA attention over a KV cache; hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `decode_attention` / `_decode_kernel`
// (src/repro/kernels/decode_attention/kernel.py:23-88) and its reshaping
// wrapper (src/repro/kernels/decode_attention/ops.py): the attention of
// every decode step of the dense LM (`models/layers.py` decode_attention).
//
// What it computes, for q (b, nkv, group, hd) and a cache k/v
// (b, S, nkv, hd), f32 or bf16, and n = cache_index + 1 valid rows:
//   out[b, n_, g] = sum_{t < n} softmax_t(q[b,n_,g]·k[b,t,n_] · hd^-1/2)
//                   · v[b, t, n_]
// with the online softmax in fp32 (m, l, acc), NEG_INF = -1e30 for masked
// logits and the denominator floored at 1e-30, as the TPU kernel does; out
// in q's dtype. Rows past cache_index are never read (the TPU grid read
// and masked them), so any S runs; cache_index comes as a host int.
//
// What bounds it: device-memory bytes. At tinyllama's decode (b 64,
// S 2048, 4 kv heads, group 8, hd 64) a call at cache_index 2047 reads
// 134 MB of K and V and does 8 FLOPs per byte, far below the card's ratio
// of operations to bytes. The design keeps enough loads in flight on every
// SM and keeps the arithmetic off their path.
//
// bf16 (the served type): flash-decoding. The TPU kernel streamed the
// cache of one (batch row, kv head) in order and left a split of the
// sequence to the caller's mesh; here the split is inside the call.
//  * `decode_split_kernel`: grid (b · nkv, n_splits); a block owns one
//    contiguous run of `rows_per_split` valid rows of one (batch row, kv
//    head) and the whole q-head group (up to 16), so a cache row is read
//    once for the group. The host picks n_splits (`split_plan` in
//    kernel.py): as many as keep the blocks within one wave of two an SM
//    (one split at batch 64 and 4 or 8 kv heads), since a block keeps two
//    or three tiles of loads in flight and more splits only add blocks
//    and their combine. 64-row K and V tiles
//    stay bf16 in shared memory (pitch hd + 8, so the eight rows of an
//    ldmatrix fall in distinct banks), fed by 16-byte cp.async copies
//    through a ring of 4 stages (3 at hd 128, so two blocks fit an SM);
//    one __syncthreads a tile. Each of the 4 warps takes 16 rows of a tile
//    and keeps its own online softmax: Sᵀ = K·Qᵀ by mma.sync m16n8k16 (K
//    rows the A operand through ldmatrix, Qᵀ the B operand with the group
//    as n = 8, one n-tile or two for a group over 8, held in registers
//    from the start), the softmax per q head in f32 with exp2 and the
//    scale folded into log2 e, the ragged tile masked in registers, and
//    Oᵀ += Vᵀ·Pᵀ with V through ldmatrix.trans and P re-packed to bf16
//    and transposed in registers (movmatrix), never through shared
//    memory. At the end the 4 warps' (m, l, acc) are combined in shared
//    memory, in warp order. With one split the block writes `out`;
//    otherwise it writes f32 partials (m in units of the scaled logit, l,
//    unnormalised acc) to a workspace the wrapper allocates.
//  * `decode_combine_kernel`: one block per (batch row, kv head) folds the
//    splits' partials in split order, out = Σ_s e^(m_s − M) acc_s /
//    max(Σ_s e^(m_s − M) l_s, 1e-30), so the result does not depend on
//    which split finished first.
// P is rounded to bf16 for its product (the TPU kernel multiplies in f32):
// within the bf16 tolerance of the output.
//
// On a mesh whose cache is split over its rows (the reference's "kv_seq"
// and "long_kv_seq" rules) each rank attends its block of rows and the
// partial outputs are combined by their logsumexp: an optional f32 `lse`
// output (b, nkv, group) takes m + log l of each q head from the kernel
// that ends the call. A null `lse` leaves every path as it was.
//
// f32 (not served; the tensor cores would round its operands) keeps
// `decode_kernel` on the CUDA cores: one block per (batch row, kv head)
// walks 64-row tiles, fetched into registers (the next tile's loads fly
// during compute) and stored to shared memory as fp32.
//
// An f8 e4m3fn cache (qwen1.5-32b's `kv_cache_dtype`; the reference
// dequantizes the whole cache with `kg.astype(q.dtype)` every step) is
// read at 1 byte an element and widened on chip, so the bytes that bound
// the call halve. Every e4m3 value is exact in f16, bf16 and f32, so the
// widening (`cvt.rn.f16x2.e4m3x2`, then f16 -> f32 -> bf16, all exact)
// changes no value, and the kernel gives the bits it gives on the
// dequantized cache under the same split plan. The split kernel lands a
// tile's e4m3 bytes with the same 16-byte cp.async copies (16 elements
// each) into a ring of bytes; after the tile barrier each warp widens its
// own 16 rows of K and V into a bf16 tile of its own at the bf16 pitch
// and reads that with ldmatrix, so one __syncwarp and no second block
// barrier a tile. The f32 kernel widens straight to f32 as it stores a
// fetched tile.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_tile.cuh"
#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using attn::kThreads;
constexpr int kTS = 64;              // cache rows per tile
constexpr int kMaxGroup = 16;        // q heads per kv head
constexpr int kWarps = kThreads / 32;
constexpr int kRowSlots = kThreads / kTS;   // threads per cache row (scores)

template <int HD>
constexpr size_t smem_bytes() {
  return ((kMaxGroup + 2 * kTS) * attn::pitch<HD>() + kMaxGroup * kTS +
          2 * kMaxGroup) * sizeof(float);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// e4m3 bytes 2i, 2i + 1 of a 16-byte chunk as two floats (exact); i is
// a constant after unrolling, so the word select folds away
__device__ __forceinline__ float2 e4m3x2_to_float2(uint4 x, int i) {
  const uint32_t w = i < 4 ? (i < 2 ? x.x : x.y) : (i < 6 ? x.z : x.w);
  const __nv_fp8x2_storage_t pair =
      static_cast<__nv_fp8x2_storage_t>(i % 2 ? w >> 16 : w & 0xffffu);
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
}

// 16 e4m3 values to 16 bf16 at dst (16-byte aligned), exactly
__device__ __forceinline__ void widen16_bf16(uint4 x, __nv_bfloat16* dst) {
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 b = __float22bfloat162_rn(e4m3x2_to_float2(x, i));
    o[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// A tile of ROWS rows of HD e4m3 bytes in flight in registers, stored
// widened to f32 at pitch HD + 4 (invalid rows as 0): `attn::Tile` for an
// f8 cache, one 16-byte load for 16 elements.
template <int HD, int ROWS>
struct TileF8 {
  static constexpr int kPerRow = HD / 16;
  static constexpr int kVecs = ROWS * kPerRow;
  static constexpr int kIters = (kVecs + kThreads - 1) / kThreads;
  uint4 raw[kIters];

  __device__ __forceinline__ void fetch(const uint8_t* __restrict__ src,
                                        int64_t row_stride, int valid) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * 16;
      raw[it] = make_uint4(0u, 0u, 0u, 0u);
      if (i < kVecs && r < valid)
        raw[it] = __ldg(reinterpret_cast<const uint4*>(src + r * row_stride +
                                                       c));
    }
  }

  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (i >= kVecs) break;
      float* row =
          dst + (i / kPerRow) * attn::pitch<HD>() + (i % kPerRow) * 16;
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float2 a = e4m3x2_to_float2(raw[it], j);
        const float2 b = e4m3x2_to_float2(raw[it], j + 1);
        *reinterpret_cast<float4*>(row + 2 * j) =
            make_float4(a.x, a.y, b.x, b.y);
      }
    }
  }
};

// KV: float, or uint8_t for an e4m3 cache (widened to f32 in `store`)
template <int HD, typename KV>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const KV* __restrict__ k,
              const KV* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int nkv,
              int group, int n_valid, int64_t ksb, int64_t kss, int64_t ksh,
              int64_t vsb, int64_t vss, int64_t vsh, float scale) {
  using KVTile = std::conditional_t<std::is_same<KV, float>::value,
                                    attn::Tile<HD, kTS>, TileF8<HD, kTS>>;
  constexpr int P = attn::pitch<HD>();
  constexpr int kCols = HD / 4;                 // float4 columns of a row
  constexpr int kGStride = kThreads / kCols;    // q heads per output pass
  constexpr int kPasses = (kMaxGroup + kGStride - 1) / kGStride;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                            // [kMaxGroup][P]
  float* k_s = q_s + kMaxGroup * P;             // [kTS][P]
  float* v_s = k_s + kTS * P;                   // [kTS][P]
  float* p_s = v_s + kTS * P;                   // [kMaxGroup][kTS]
  float* alpha_s = p_s + kMaxGroup * kTS;       // [kMaxGroup]
  float* l_s = alpha_s + kMaxGroup;             // [kMaxGroup]

  const int64_t bi = blockIdx.x / nkv;
  const int kvh = blockIdx.x % nkv;
  const int64_t head0 = (bi * nkv + kvh) * group;   // first q head's row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the group's q rows are contiguous: group · HD elements
  {
    attn::Tile<HD, kMaxGroup> t;
    t.fetch(q + head0 * HD, HD, group);
    t.store(q_s);
  }
  const KV* kb = k + bi * ksb + kvh * ksh;
  const KV* vb = v + bi * vsb + kvh * vsh;

  // softmax state: warp w owns q heads w and w + 8
  float m_r[2] = {attn::kNegInf, attn::kNegInf};
  float l_r[2] = {0.f, 0.f};
  // output: thread owns columns 4c..4c+3 of q heads gi + p · kGStride
  const int c = threadIdx.x % kCols;
  const int gi = threadIdx.x / kCols;
  float4 acc[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);
  // scores: thread owns cache row r of the tile for q heads rs + 4 j
  const int r = threadIdx.x % kTS;
  const int rs = threadIdx.x / kTS;

  const int n_tiles = (n_valid + kTS - 1) / kTS;
  KVTile kt, vt;
  kt.fetch(kb, kss, n_valid);
  vt.fetch(vb, vss, n_valid);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kTS;
    __syncthreads();                 // the last tile's k_s/v_s/p_s are read
    kt.store(k_s);
    vt.store(v_s);
    __syncthreads();
    if (it + 1 < n_tiles) {          // next tile's loads fly during compute
      kt.fetch(kb + (t0 + kTS) * kss, kss, n_valid - t0 - kTS);
      vt.fetch(vb + (t0 + kTS) * vss, vss, n_valid - t0 - kTS);
    }

    // logits of cache row r for q heads rs, rs + 4, rs + 8, rs + 12
    float sc[kMaxGroup / kRowSlots];
#pragma unroll
    for (int j = 0; j < kMaxGroup / kRowSlots; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(k_s + r * P + d);
#pragma unroll
      for (int j = 0; j < kMaxGroup / kRowSlots; ++j) {
        const int g = rs + kRowSlots * j;
        if (g < group)
          sc[j] = attn::dot4(
              *reinterpret_cast<const float4*>(q_s + g * P + d), kv, sc[j]);
      }
    }
    const bool live = t0 + r < n_valid;
#pragma unroll
    for (int j = 0; j < kMaxGroup / kRowSlots; ++j) {
      const int g = rs + kRowSlots * j;
      if (g < group) p_s[g * kTS + r] = live ? sc[j] * scale : attn::kNegInf;
    }
    __syncthreads();

    // online softmax over the tile's 64 logits of each q head
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = warp + kWarps * j;
      if (g >= group) continue;
      float* row = p_s + g * kTS;
      const float x0 = row[lane];
      const float x1 = row[lane + 32];
      const float m_new = fmaxf(m_r[j], warp_max(fmaxf(x0, x1)));
      const float alpha = expf(m_r[j] - m_new);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      l_r[j] = l_r[j] * alpha + warp_sum(p0 + p1);
      m_r[j] = m_new;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

    // acc += p · v over the tile's live rows
    const int rows = min(kTS, n_valid - t0);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int g = gi + p * kGStride;
      if (g >= group) continue;
      const float alpha = alpha_s[g];
      float4 a = acc[p];
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
      const float* pr = p_s + g * kTS;
#pragma unroll 4
      for (int t = 0; t < rows; ++t) {
        const float w = pr[t];
        const float4 x = *reinterpret_cast<const float4*>(v_s + t * P + 4 * c);
        a.x = fmaf(w, x.x, a.x);
        a.y = fmaf(w, x.y, a.y);
        a.z = fmaf(w, x.z, a.z);
        a.w = fmaf(w, x.w, a.w);
      }
      acc[p] = a;
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g = warp + kWarps * j;
    if (g < group && lane == 0) {
      l_s[g] = l_r[j];
      if (lse) lse[head0 + g] = m_r[j] + logf(fmaxf(l_r[j], attn::kMinL));
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int g = gi + p * kGStride;
    if (g >= group) continue;
    const float den = fmaxf(l_s[g], attn::kMinL);
    float* o = out + (head0 + g) * HD + 4 * c;
    o[0] = acc[p].x / den;
    o[1] = acc[p].y / den;
    o[2] = acc[p].z / den;
    o[3] = acc[p].w / den;
  }
}

// ---------------------------------------------------------------------------
// bf16: split-KV on the tensor cores (design in the note at the top)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using hopper::ex2;
using hopper::pack_bf16;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16;
using mma::movmatrix_trans;

constexpr int kSplitThreads = 128;     // 4 warps, 16 rows of a tile each
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kMaxSplits = 32;         // kernel.py MAX_SPLITS
constexpr int kCombineThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr int split_pitch() { return HD + 8; }   // bf16
template <int HD>
__host__ __device__ constexpr int split_stages() { return HD == 128 ? 3 : 4; }
// bf16: the ring [stage][k | v][kTS][pitch]; f8: a ring of bytes
// [stage][k | v][kTS][HD], then each warp's widened rows
// [warp][k | v][16][pitch] in bf16
template <int HD, bool F8>
__host__ __device__ constexpr size_t ring_bytes() {
  return F8 ? split_stages<HD>() * 2 * kTS * HD
            : split_stages<HD>() * 2 * kTS * split_pitch<HD>() * sizeof(bf16);
}
template <int HD, bool F8>
__host__ __device__ constexpr size_t split_smem() {
  return ring_bytes<HD, F8>() +
         (F8 ? 2 * kTS * split_pitch<HD>() * sizeof(bf16) : 0);
}

// f32 floats of the end-of-loop exchange: each warp's acc, m and l for
// 8 · NT q heads
template <int HD, int NT>
__host__ __device__ constexpr size_t exchange_bytes() {
  return kSplitWarps * 8 * NT * (HD + 2) * sizeof(float);
}

// KV: bf16, or uint8_t for an e4m3 cache (widened to bf16 on chip)
template <int HD, int NT, typename KV>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ ws, float* __restrict__ lse, int nkv,
                    int group, int n_valid,
                    int rows_per_split, int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh, float scale) {
  constexpr bool F8 = std::is_same<KV, uint8_t>::value;
  constexpr int P = split_pitch<HD>();
  constexpr int RP = F8 ? HD : P;     // ring pitch, in KV elements
  constexpr int S = split_stages<HD>();
  constexpr int kSteps = HD / 16;     // k steps of K·Qᵀ; m tiles of Vᵀ·Pᵀ
  constexpr int kElems = 16 / sizeof(KV);   // elements of a 16-byte chunk
  constexpr int kChunks = HD / kElems;      // 16-byte chunks of a row
  constexpr int kLoads = (kTS * kChunks + kSplitThreads - 1) / kSplitThreads;
  constexpr int GH = 8 * NT;          // q heads the fragments hold
  static_assert(exchange_bytes<HD, NT>() <= split_smem<HD, F8>(),
                "the exchange reuses the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* ring = reinterpret_cast<KV*>(smem_raw);
  // f8: this warp's widened K rows, then its V rows, [16][P] each
  bf16* wide = reinterpret_cast<bf16*>(smem_raw + ring_bytes<HD, F8>()) +
               (threadIdx.x / 32) * 2 * 16 * P;

  const int bh = blockIdx.x;                    // batch row · nkv + kv head
  const int64_t bi = bh / nkv;
  const int kvh = bh % nkv;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int r0 = split * rows_per_split;
  const int rows = min(rows_per_split, n_valid - r0);   // ≥ 1
  const int n_tiles = (rows + kTS - 1) / kTS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;              // fragment row (and row + 8)
  const int t = lane & 3;               // fragment column pair
  const float sl2 = scale * kLog2e;
  const int64_t head0 = static_cast<int64_t>(bh) * group;   // first q row
  const KV* kb = k + bi * ksb + kvh * ksh + r0 * kss;
  const KV* vb = v + bi * vsb + kvh * vsh + r0 * vss;

  // tile `it` of the split into its stage, rows past the split zero-filled;
  // every thread commits one group a call, empty past the last tile
  auto load_tile = [&](int it) {
    if (it < n_tiles) {
      KV* ks = ring + (it % S) * 2 * kTS * RP;
      KV* vs = ks + kTS * RP;
      const int valid = rows - it * kTS;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = threadIdx.x + u * kSplitThreads;
        if (kTS * kChunks % kSplitThreads && i >= kTS * kChunks) break;
        const int r = i / kChunks;
        const int c = (i % kChunks) * kElems;
        const bool live = r < valid;
        const int64_t row = it * kTS + (live ? r : 0);
        cp_async16(ks + r * RP + c, kb + row * kss + c, live ? 16 : 0);
        cp_async16(vs + r * RP + c, vb + row * vss + c, live ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) load_tile(s);

  // Qᵀ as B fragments, head 8 j + g of n-tile j (zeros past the group)
  uint32_t qf[NT][kSteps][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int h = 8 * j + g;
    const uint32_t* qr =
        reinterpret_cast<const uint32_t*>(q + (head0 + h) * HD) + t;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      qf[j][ks][0] = h < group ? __ldg(qr + 8 * ks) : 0u;
      qf[j][ks][1] = h < group ? __ldg(qr + 8 * ks + 4) : 0u;
    }
  }

  // this lane's q heads are 8 j + 2t and 8 j + 2t + 1 in S and in O
  float o[kSteps][NT][4];
  float m[NT][2], l[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    m[j][0] = m[j][1] = attn::kNegInf;    // raw-logit maxima
    l[j][0] = l[j][1] = 0.f;              // this lane's share of the sums
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt)
      o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<S - 2>();             // tile it has landed (this thread)
    __syncthreads();                    // ... for all; stage it - 1 is free
    load_tile(it + S - 1);
    const int live = rows - it * kTS - 16 * warp;   // valid rows of the warp
    if (live <= 0) continue;
    const bf16* k_s;
    const bf16* v_s;
    if constexpr (F8) {
      // the warp's 16 rows of K and V, 16 e4m3 bytes a lane a step,
      // widened into its own bf16 rows (zero rows stay zero)
      const uint8_t* src = ring + (it % S) * 2 * kTS * RP + 16 * warp * RP;
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {           // 2 · 16 · kChunks / 32
        const int i = lane + 32 * u;
        const int m = i / (16 * kChunks);           // 0: K, 1: V
        const int r = (i / kChunks) % 16;
        const int c = (i % kChunks) * 16;
        widen16_bf16(
            *reinterpret_cast<const uint4*>(src + m * kTS * RP + r * RP + c),
            wide + (m * 16 + r) * P + c);
      }
      __syncwarp();
      k_s = wide;
      v_s = wide + 16 * P;
    } else {
      k_s = ring + (it % S) * 2 * kTS * P + 16 * warp * P;
      v_s = k_s + kTS * P;
    }

    // Sᵀ = K·Qᵀ: rows (g, g + 8) of the warp's 16 x heads (2t, 2t + 1)
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, k_s + (lane % 16) * P + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(sc[j], a, qf[j][ks][0], qf[j][ks][1]);
    }
    if (live < 16) {                    // the split's ragged last tile
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (g >= live) sc[j][0] = sc[j][1] = attn::kNegInf;
        if (g + 8 >= live) sc[j][2] = sc[j][3] = attn::kNegInf;
      }
    }

    // online softmax per q head over the 16 rows (8 lanes share a head),
    // then Pᵀ as bf16 B fragments: (rows 2t, 2t + 1 | 2t + 8, 2t + 9;
    // head g) after a transpose of each 8 x 8 half
    uint32_t pb[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float mx0 = fmaxf(sc[j][0], sc[j][2]);
      float mx1 = fmaxf(sc[j][1], sc[j][3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      mx0 = fmaxf(m[j][0], mx0);
      mx1 = fmaxf(m[j][1], mx1);
      const float a0 = ex2((m[j][0] - mx0) * sl2);
      const float a1 = ex2((m[j][1] - mx1) * sl2);
      m[j][0] = mx0;
      m[j][1] = mx1;
#pragma unroll
      for (int mt = 0; mt < kSteps; ++mt) {
        o[mt][j][0] *= a0;
        o[mt][j][1] *= a1;
        o[mt][j][2] *= a0;
        o[mt][j][3] *= a1;
      }
      const float p0 = ex2((sc[j][0] - mx0) * sl2);
      const float p1 = ex2((sc[j][1] - mx1) * sl2);
      const float p2 = ex2((sc[j][2] - mx0) * sl2);
      const float p3 = ex2((sc[j][3] - mx1) * sl2);
      l[j][0] = l[j][0] * a0 + (p0 + p2);
      l[j][1] = l[j][1] * a1 + (p1 + p3);
      pb[j][0] = movmatrix_trans(pack_bf16(p0, p1));
      pb[j][1] = movmatrix_trans(pack_bf16(p2, p3));
    }

    // Oᵀ += Vᵀ·Pᵀ: hd columns of V in m-tiles of 16, the 16 rows as k
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, v_s + ((lane % 8) + (lane / 16) * 8) * P +
                               16 * mt + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(o[mt][j], a, pb[j][0], pb[j][1]);
    }
  }

  // each warp's (m, l, acc) into shared memory (the ring is done with)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      l[j][0] += __shfl_xor_sync(0xffffffffu, l[j][0], off);
      l[j][1] += __shfl_xor_sync(0xffffffffu, l[j][1], off);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* x_acc = reinterpret_cast<float*>(smem_raw);  // [warp][GH][HD]
  float* x_m = x_acc + kSplitWarps * GH * HD;          // [warp][GH]
  float* x_l = x_m + kSplitWarps * GH;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int h = warp * GH + 8 * j + 2 * t;
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt) {
      const int d = 16 * mt + g;
      x_acc[h * HD + d] = o[mt][j][0];
      x_acc[(h + 1) * HD + d] = o[mt][j][1];
      x_acc[h * HD + d + 8] = o[mt][j][2];
      x_acc[(h + 1) * HD + d + 8] = o[mt][j][3];
    }
    if (g == 0) {
      x_m[h] = m[j][0];
      x_m[h + 1] = m[j][1];
      x_l[h] = l[j][0];
      x_l[h + 1] = l[j][1];
    }
  }
  __syncthreads();

  // the block's (m, l, acc), warps folded in order; a warp that saw no
  // valid row has m = NEG_INF, l = 0, acc = 0 and weight 0
  const int64_t part0 = (static_cast<int64_t>(bh) * n_splits + split) * group;
  const int64_t n_parts = static_cast<int64_t>(gridDim.x) * n_splits * group;
  for (int e = threadIdx.x; e < group * HD; e += kSplitThreads) {
    const int h = e / HD;
    const int d = e % HD;
    float mb = attn::kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mb = fmaxf(mb, x_m[w * GH + h]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float c = ex2((x_m[w * GH + h] - mb) * sl2);
      lb += x_l[w * GH + h] * c;
      ab += x_acc[(w * GH + h) * HD + d] * c;
    }
    if (n_splits == 1) {
      out[(head0 + h) * HD + d] = __float2bfloat16_rn(ab / fmaxf(lb, attn::kMinL));
      if (lse && d == 0)
        lse[head0 + h] = mb * scale + logf(fmaxf(lb, attn::kMinL));
    } else {
      ws[(part0 + h) * HD + d] = ab;
      if (d == 0) {
        ws[n_parts * HD + part0 + h] = mb * scale;
        ws[n_parts * (HD + 1) + part0 + h] = lb;
      }
    }
  }
}

// Fold the splits of one (batch row, kv head) in split order. ws holds
// acc [b · nkv][n_splits][group][hd], then m and l [b · nkv][n_splits][group].
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                      float* __restrict__ lse, int group, int hd,
                      int n_splits) {
  __shared__ float coef[kMaxSplits * kMaxGroup];
  __shared__ float den[kMaxGroup];
  const int64_t bh = blockIdx.x;
  const int64_t n_parts = static_cast<int64_t>(gridDim.x) * n_splits * group;
  const float* acc = ws + bh * n_splits * group * hd;
  const float* wm = ws + n_parts * hd + bh * n_splits * group;
  const float* wl = wm + n_parts;
  if (threadIdx.x < group) {
    const int h = threadIdx.x;
    float mx = attn::kNegInf;
    for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, wm[s * group + h]);
    float lsum = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float c = ex2((wm[s * group + h] - mx) * kLog2e);
      coef[s * group + h] = c;
      lsum += wl[s * group + h] * c;
    }
    den[h] = fmaxf(lsum, attn::kMinL);
    if (lse) lse[bh * group + h] = mx + logf(den[h]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < group * hd; e += kCombineThreads) {
    const int h = e / hd;
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      a += acc[static_cast<int64_t>(s) * group * hd + e] * coef[s * group + h];
    out[bh * group * hd + e] = __float2bfloat16_rn(a / den[h]);
  }
}

template <int HD, int NT, typename KV>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         void* out, float* ws, float* lse, int b, int nkv,
                         int group, int n_valid, int rows_per_split,
                         int n_splits, const int64_t* st, float scale,
                         cudaStream_t stream) {
  auto kernel = decode_split_kernel<HD, NT, KV>;
  constexpr size_t smem = split_smem<HD, std::is_same<KV, uint8_t>::value>();
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(b * nkv, n_splits);
  kernel<<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<bf16*>(out), ws,
      n_splits == 1 ? lse : nullptr, nkv, group, n_valid, rows_per_split,
      st[0], st[1], st[2], st[3], st[4], st[5], scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return e;
  decode_combine_kernel<<<b * nkv, kCombineThreads, 0, stream>>>(
      ws, static_cast<bf16*>(out), lse, group, HD, n_splits);
  return cudaGetLastError();
}

template <int HD, typename KV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* ws, float* lse, int b, int nkv,
                        int group, int n_valid, int rows_per_split,
                        int n_splits, const int64_t* st, float scale,
                        cudaStream_t stream) {
  return group > 8
             ? launch_split<HD, 2, KV>(q, k, v, out, ws, lse, b, nkv, group,
                                       n_valid, rows_per_split, n_splits, st,
                                       scale, stream)
             : launch_split<HD, 1, KV>(q, k, v, out, ws, lse, b, nkv, group,
                                       n_valid, rows_per_split, n_splits, st,
                                       scale, stream);
}

template <int HD, typename KV>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int b, int nkv, int group,
                       int n_valid, const int64_t* st, float scale,
                       cudaStream_t stream) {
  auto kernel = decode_kernel<HD, KV>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<b * nkv, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<float*>(out), lse, nkv, group,
      n_valid, st[0], st[1], st[2], st[3], st[4], st[5], scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* ws, float* lse, int b, int nkv, int group,
                   int n_valid, int rows_per_split, int n_splits,
                   const int64_t* st, float scale, int q_bf16, int kv_f8,
                   cudaStream_t stream) {
  if (q_bf16)
    return kv_f8 ? launch_bf16<HD, uint8_t>(q, k, v, out, ws, lse, b, nkv,
                                            group, n_valid, rows_per_split,
                                            n_splits, st, scale, stream)
                 : launch_bf16<HD, bf16>(q, k, v, out, ws, lse, b, nkv, group,
                                         n_valid, rows_per_split, n_splits,
                                         st, scale, stream);
  return kv_f8 ? launch_f32<HD, uint8_t>(q, k, v, out, lse, b, nkv, group,
                                         n_valid, st, scale, stream)
               : launch_f32<HD, float>(q, k, v, out, lse, b, nkv, group,
                                       n_valid, st, scale, stream);
}

}  // namespace

// Plain C entry for ctypes. q/out are contiguous (b, nkv, group, hd) device
// tensors; k/v are (b, S, nkv, hd) caches with the given batch, sequence
// and head strides in elements (head_dim contiguous); rows 0 .. n_valid - 1
// are read. `bf16` says q and out hold bf16 (else f32); `kv_f8` says the
// caches hold e4m3fn bytes (else q's type). bf16 runs in
// n_splits splits of rows_per_split rows (none empty); with more than one,
// `ws` is an f32 workspace of b · nkv · n_splits · group · (hd + 2)
// elements. f32 takes n_splits 1. `lse`, null or a contiguous f32
// (b, nkv, group) tensor, receives each q head's logsumexp of its scaled
// logits over the rows read, written by the kernel that ends the call (the
// split kernel at one split, the combine at several, the f32 kernel).
// Launches asynchronously on `stream` and returns the first CUDA error,
// or 0.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* out, void* ws, void* lse, int b,
                                int nkv,
                                int group, int hd, int n_valid,
                                int rows_per_split, int n_splits, int64_t ksb,
                                int64_t kss, int64_t ksh, int64_t vsb,
                                int64_t vss, int64_t vsh, float scale,
                                int bf16, int kv_f8, void* stream) {
  if (b <= 0 || nkv <= 0 || group < 1 || group > kMaxGroup || n_valid < 1 ||
      static_cast<int64_t>(b) * nkv > 0x7fffffff || n_splits < 1 ||
      n_splits > kMaxSplits || rows_per_split < 1 ||
      static_cast<int64_t>(n_splits - 1) * rows_per_split >= n_valid ||
      static_cast<int64_t>(n_splits) * rows_per_split < n_valid ||
      (n_splits > 1 && (ws == nullptr || !bf16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[6] = {ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  cudaError_t e = cudaErrorInvalidValue;
#define DECODE_CASE(HD)                                                     \
  case HD:                                                                  \
    e = launch<HD>(q, k, v, out, w, static_cast<float*>(lse), b, nkv, group, \
                   n_valid, rows_per_split, n_splits, st, scale, bf16,      \
                   kv_f8, cs);                                              \
    break;
  switch (hd) {
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(128)
    default: break;
  }
#undef DECODE_CASE
  return static_cast<int>(e);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
