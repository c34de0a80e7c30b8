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
// in q's dtype.
//
// Layout: one block per (batch row, kv head) holds the whole q-head group
// (up to 16 heads), so each cache row is read once for the group. The TPU
// grid streamed all S / block_s blocks and masked those past cache_index;
// a masked block changes neither m, l nor acc, so this kernel streams rows
// 0 .. cache_index only, in tiles of 64, and any S runs. cache_index comes
// as a host int: no device read-back.
//
// What bounds it: device-memory bytes. At tinyllama's decode (b 64,
// S 2048, 4 kv heads, group 8, hd 64) a launch at cache_index 2047 reads
// 134 MB of K and V and does 8 FLOPs per byte, far below the card's ratio
// of operations to bytes. So the design keeps loads in flight: each thread
// fetches its share of the next K and V tiles into registers (four 16-byte
// loads at bf16, hd 64) while the block computes on the current tile from
// shared memory. One block per (batch row, kv head) gives 256 blocks at
// that shape, about two per SM; splitting the rows over more blocks
// (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_tile.cuh"

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int nkv,
              int group, int n_valid, int64_t ksb, int64_t kss, int64_t ksh,
              int64_t vsb, int64_t vss, int64_t vsh, float scale) {
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
    attn::Tile<T, HD, kMaxGroup> t;
    t.fetch(q + head0 * HD, HD, group);
    t.store(q_s);
  }
  const T* kb = k + bi * ksb + kvh * ksh;
  const T* vb = v + bi * vsb + kvh * vsh;

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
  attn::Tile<T, HD, kTS> kt, vt;
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
    if (g < group && lane == 0) l_s[g] = l_r[j];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int g = gi + p * kGStride;
    if (g >= group) continue;
    const float den = fmaxf(l_s[g], attn::kMinL);
    T* o = out + (head0 + g) * HD + 4 * c;
    attn::store_out(o, acc[p].x / den);
    attn::store_out(o + 1, acc[p].y / den);
    attn::store_out(o + 2, acc[p].z / den);
    attn::store_out(o + 3, acc[p].w / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int nkv, int group, int n_valid, const int64_t* st,
                   float scale, cudaStream_t stream) {
  auto kernel = decode_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = attn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<b * nkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nkv, group, n_valid,
      st[0], st[1], st[2], st[3], st[4], st[5], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int b, int nkv, int group, int hd, int n_valid,
                     const int64_t* st, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, b, nkv, group, n_valid, st,
                                  scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, b, nkv, group, n_valid, st,
                                  scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, nkv, group, n_valid, st,
                                  scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, b, nkv, group, n_valid, st,
                                    scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. q/out are contiguous (b, nkv, group, hd) device
// tensors; k/v are (b, S, nkv, hd) caches with the given batch, sequence
// and head strides in elements (head_dim contiguous); rows 0 .. n_valid - 1
// are read. `bf16` says the tensors hold bf16 (else f32). Launches
// asynchronously on `stream` and returns the first CUDA error, or 0.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* out, int b, int nkv, int group, int hd,
                                int n_valid, int64_t ksb, int64_t kss,
                                int64_t ksh, int64_t vsb, int64_t vss,
                                int64_t vsh, float scale, int bf16,
                                void* stream) {
  if (b <= 0 || nkv <= 0 || group < 1 || group > kMaxGroup || n_valid < 1 ||
      static_cast<int64_t>(b) * nkv > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[6] = {ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, b, nkv, group, hd, n_valid,
                                     st, scale, cs)
           : dispatch<float>(q, k, v, out, b, nkv, group, hd, n_valid, st,
                             scale, cs);
  return static_cast<int>(e);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
